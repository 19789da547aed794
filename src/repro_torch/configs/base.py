"""Model configuration dataclasses: a copy of ``repro.configs.base``.

The port carries its own copy (it imports nothing of ``repro``); the
fields and their meaning are the reference's, so a config is the same
value in both packages: the model-shape classes, the input-shape table,
``PeftSpec`` (the LoRA spec a ``ModelPlan`` carries) and ``TrainConfig``
(a training run's settings).

The port adds fields of its own (``PORT_FIELDS``), for models the
reference has no config of (granite-4.0-h: NoPE attention, a softmax
scale, embedding, residual and logit multipliers; an expert layer that
holds a share of the experts, a shared expert of its own width; Kimi
K2: multi-head latent attention, YaRN's frequencies, a sigmoid router
whose top-k is chosen on bias-corrected scores, a routed scaling and a
sequence-wise balance loss; Nemotron-H: a layer pattern of one-sublayer
layers, a Mamba-2 inner width from its head count, the gated norm per
group, relu² experts). At its default each leaves the model, its
numbers and its launches as the reference's; ``reference_dict`` is a
config as the reference would hold it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # which layers are MoE: "all", "every_2" (odd layers), or after first_k_dense
    first_k_dense: int = 0
    every: int = 1  # 1 = every layer (after first_k_dense); 2 = alternate
    # the port's own (PORT_FIELDS): the shared expert's width (0: d_ff_expert
    # x num_shared_experts), and the contiguous share of the experts this
    # layer holds, [expert_offset, expert_offset + experts_held) (0: all).
    # The router keeps all num_experts outputs and the capacity counts
    # all of them; the layer computes its own experts' part of the result
    # (expert parallelism's layer, without its exchange)
    d_ff_shared: int = 0
    experts_held: int = 0
    expert_offset: int = 0
    # the port's own (PORT_FIELDS): the router, "softmax" (the
    # reference's: a softmax, its top-k, the Switch balance loss over the
    # whole forward) or "sigmoid" (DeepSeek-V3's, arXiv:2412.19437
    # §2.1.2: sigmoid scores, the top-k chosen on the scores plus a
    # per-expert correction_bias leaf that takes no gradient, gates from
    # the unbiased scores, the balance loss per sequence, averaged over
    # the sequences); either's gates, renormalised over the top-k, times
    # routed_scaling
    router: str = "softmax"
    routed_scaling: float = 1.0

    def __post_init__(self):
        if not 0 <= self.expert_offset <= self.num_experts - self.held:
            raise ValueError(
                f"experts [{self.expert_offset}, {self.expert_offset + self.held}"
                f") outside the {self.num_experts} experts")
        if self.router not in ("softmax", "sigmoid"):
            raise ValueError(f"router must be 'softmax' or 'sigmoid', got "
                             f"{self.router!r}")

    @property
    def held(self) -> int:
        """Experts this layer holds and computes."""
        return self.experts_held or self.num_experts

    @property
    def shared_width(self) -> int:
        return self.d_ff_shared or self.d_ff_expert * self.num_shared_experts


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    conv_dim: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1
    # the port's own (PORT_FIELDS; Nemotron-H's): the mixer's heads (0:
    # expand x d_model / head_dim), which set its inner width num_heads x
    # head_dim; and the gated RMSNorm taken over each of the n_groups
    # groups of d_inner / n_groups channels (Mamba-2's RMSNormGated with
    # group_size), not over the whole inner width. The reference's Mamba-2
    # norms over the whole inner width whatever n_groups is, so True is a
    # departure from it even where n_groups is 1 and the two agree
    num_heads: int = 0
    norm_per_group: bool = False

    def inner(self, d_model: int) -> Tuple[int, int]:
        """(d_inner, heads) of the mixer on a d_model-wide stream."""
        if self.num_heads:
            return self.num_heads * self.head_dim, self.num_heads
        d_inner = self.expand * d_model
        return d_inner, d_inner // self.head_dim


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper-style) models.

    The modality frontend (mel + conv) is a stub per the assignment:
    ``input_specs`` provides precomputed frame embeddings of shape
    (batch, num_frames, d_model).
    """
    num_layers: int = 4
    num_frames: int = 1500  # whisper: 30s audio -> 1500 frames after conv stride 2


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | ssm | moe | vlm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # layer pattern for hybrids: period and which offsets are attention layers
    # e.g. jamba: period 8, attention at offset 4 (1 attn : 7 mamba)
    hybrid_period: int = 0
    hybrid_attn_offsets: Tuple[int, ...] = ()
    # the port's own (PORT_FIELDS; Nemotron-H's hybrid_override_pattern):
    # one character a layer, each layer one sublayer: "M" a Mamba-2
    # mixer alone, "*" an attention mixer alone, "E" a MoE FFN alone, "-"
    # a dense FFN alone (each x + f(rmsnorm(x))); "" keeps the (mixer,
    # ffn) layers of arch_type and hybrid_period
    layer_pattern: str = ""
    # attention details
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) sections
    qk_norm: bool = False
    attn_bias: bool = False
    mlp_bias: bool = False
    sliding_window: Optional[int] = None  # None = full attention
    parallel_block: bool = False  # cohere/command-r parallel attn+mlp residual
    # swiglu | gelu | relu2 (Nemotron-H's ungated down(relu(x up)^2)); the
    # MoE's held and shared experts take it too, swiglu or relu2
    mlp_act: str = "swiglu"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    logit_softcap: float = 0.0
    # the port's own (PORT_FIELDS; granite-4.0-h's): "rope" or "nope" (no
    # positional embedding); the softmax scale (0: 1/sqrt(head_dim)); the
    # embedding times embedding_multiplier, each residual branch times
    # residual_multiplier, the logits over logits_scaling. A multiplier
    # of 1 is skipped, not multiplied by
    position_embedding: str = "rope"
    attention_multiplier: float = 0.0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    # the port's own (PORT_FIELDS; Kimi K2's, DeepSeek-V3's): a
    # kv_lora_rank above 0 makes every attention layer multi-head latent
    # attention (MLA): q from a q_lora_rank latent through its RMSNorm; k
    # and v from one kv_lora_rank latent through its RMSNorm; each q and k
    # head qk_nope_head_dim wide without RoPE and qk_rope_head_dim with it
    # (k's rope part one head shared by all), each v head v_head_dim wide
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN on MLA's rope dimensions (arXiv:2309.00071, in DeepSeek-V3's
    # form): a factor above 1 divides the RoPE frequencies past the
    # correction range that beta_fast and beta_slow give at the original
    # length, each of which it then needs; with yarn_mscale_all_dim the
    # softmax scale is (q.k width)^-1/2 x mscale^2, mscale = 0.1
    # yarn_mscale_all_dim ln(factor) + 1
    yarn_factor: float = 1.0
    yarn_original_max_position: int = 0
    yarn_beta_fast: float = 0.0
    yarn_beta_slow: float = 0.0
    yarn_mscale_all_dim: float = 0.0
    # distribution hints, set by the launcher (not by architecture configs):
    # mesh axis to shard the MoE dispatch/expert-compute activations over
    # (expert parallelism), and the number of independent routing groups
    # (aligned with the data shards so position/capacity bookkeeping never
    # crosses a shard — DeepSpeed-style per-rank capacity).
    expert_axis: Optional[str] = None
    routing_groups: int = 1
    # citation for the assignment table
    source: str = ""

    def __post_init__(self):
        if self.position_embedding not in ("rope", "nope"):
            raise ValueError(f"position_embedding must be 'rope' or 'nope', "
                             f"got {self.position_embedding!r}")
        if self.is_mla and not (self.q_lora_rank > 0
                                and self.qk_nope_head_dim > 0
                                and self.v_head_dim > 0
                                and self.qk_rope_head_dim > 0
                                and self.qk_rope_head_dim % 2 == 0):
            raise ValueError("MLA needs q_lora_rank, qk_nope_head_dim and "
                             "v_head_dim above 0 and an even "
                             "qk_rope_head_dim above 0")
        if self.is_mla and (self.attn_bias or self.qk_norm
                            or self.attention_multiplier):
            raise ValueError("MLA takes no attn_bias, qk_norm or "
                             "attention_multiplier")
        if self.yarn is not None and not (
                self.is_mla and self.yarn_original_max_position > 0
                and self.yarn_beta_fast > 0 and self.yarn_beta_slow > 0):
            raise ValueError("YaRN applies to MLA's rope dimensions only, "
                             "and needs its original length, beta_fast "
                             "and beta_slow")
        if self.layer_pattern and (
                len(self.layer_pattern) != self.num_layers
                or set(self.layer_pattern) - set(LAYER_KINDS)):
            raise ValueError(f"layer_pattern needs one of "
                             f"{''.join(LAYER_KINDS)!r} a layer for "
                             f"{self.num_layers} layers, got "
                             f"{self.layer_pattern!r}")
        if self.moe is not None and self.mlp_act not in ("swiglu", "relu2"):
            raise ValueError(f"a MoE's experts take mlp_act 'swiglu' or "
                             f"'relu2', got {self.mlp_act!r}")
        s = self.ssm
        if s is not None and s.norm_per_group and \
                s.inner(self.d_model)[0] % s.n_groups:
            raise ValueError("the gated norm per group needs n_groups to "
                             "divide the inner width")

    @property
    def is_mla(self) -> bool:
        """Multi-head latent attention in every attention layer."""
        return self.kv_lora_rank > 0

    @property
    def yarn(self) -> Optional[Tuple[float, int, float, float]]:
        """(factor, original length, beta_fast, beta_slow) under YaRN, or
        None."""
        if self.yarn_factor == 1.0:
            return None
        return (self.yarn_factor, self.yarn_original_max_position,
                self.yarn_beta_fast, self.yarn_beta_slow)

    @property
    def attention_is_reference(self) -> bool:
        """RoPE and the 1/sqrt(head_dim) scale over grouped-query heads:
        the attention the flash kernel (B4) and paged decode (B6)
        compute."""
        return self.position_embedding == "rope" and \
            not self.attention_multiplier and not self.is_mla

    def port_fields_set(self) -> Tuple[str, ...]:
        """The port's own fields that are off their defaults (the MoE's and
        the SSM's as ``moe.<field>`` and ``ssm.<field>``): those a path
        that cannot honour them refuses."""
        out = [k for k, v in PORT_FIELDS["model"].items()
               if getattr(self, k) != v]
        for group in ("moe", "ssm"):
            node = getattr(self, group)
            if node is not None:
                out += [f"{group}.{k}" for k, v in PORT_FIELDS[group].items()
                        if getattr(node, k) != v]
        return tuple(out)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    def is_attn_layer(self, i: int) -> bool:
        """Whether layer i carries attention (vs SSM) for hybrid patterns."""
        if self.layer_pattern:
            return LAYER_KINDS[self.layer_pattern[i]][0] == "attn"
        if self.arch_type == "ssm":
            return False
        if self.hybrid_period:
            return (i % self.hybrid_period) in self.hybrid_attn_offsets
        return True

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        if m is None:
            return False
        if self.layer_pattern:
            return LAYER_KINDS[self.layer_pattern[i]][1] == "moe"
        if i < m.first_k_dense:
            return False
        return ((i - m.first_k_dense) % m.every) == 0

    def supports_long_context(self) -> bool:
        """Sub-quadratic decode support: SSM/hybrid natively; dense via sliding window."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# The fields the port adds to the reference's classes, at their defaults.
PORT_FIELDS = {
    "model": {"position_embedding": "rope", "attention_multiplier": 0.0,
              "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
              "logits_scaling": 1.0, "q_lora_rank": 0, "kv_lora_rank": 0,
              "qk_nope_head_dim": 0, "qk_rope_head_dim": 0, "v_head_dim": 0,
              "yarn_factor": 1.0, "yarn_original_max_position": 0,
              "yarn_beta_fast": 0.0, "yarn_beta_slow": 0.0,
              "yarn_mscale_all_dim": 0.0, "layer_pattern": ""},
    "moe": {"d_ff_shared": 0, "experts_held": 0, "expert_offset": 0,
            "router": "softmax", "routed_scaling": 1.0},
    "ssm": {"num_heads": 0, "norm_per_group": False},
}

# ``layer_pattern``'s characters: the (mixer, ffn) of each
LAYER_KINDS = {"M": ("ssm", "none"), "*": ("attn", "none"),
               "E": ("none", "moe"), "-": ("none", "dense")}


def reference_dict(cfg: ModelConfig) -> dict:
    """``dataclasses.asdict(cfg)`` less the port's own fields where they
    hold their defaults: the reference's config of the same model. A
    field off its default stays, so no reference config equals it."""
    out = dataclasses.asdict(cfg)
    for group, node in (("model", out), ("moe", out.get("moe")),
                        ("ssm", out.get("ssm"))):
        for k, v in PORT_FIELDS[group].items():
            if node is not None and node.get(k) == v:
                del node[k]
    return out


# ---------------------------------------------------------------------------
# Input shapes assigned to this paper.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class PeftSpec:
    """Parameter-efficient fine-tuning spec carried by ``ModelPlan``.

    ``targets`` selects which projection families get adapters: "attn"
    (wq/wk/wv/wo), "mlp" (gate/up/down dense FFN), "ssm" (in_proj/out_proj),
    "router" (MoE router — opt-in; expert einsum tensors stay frozen).
    Frozen/hashable so plans remain valid static jit arguments.
    """
    kind: str = "lora"
    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("attn", "mlp", "ssm")


@dataclass(frozen=True)
class TrainConfig:
    """Top-level run config consumed by the launcher."""
    model: ModelConfig
    algo: str = "sfl_ga"  # sfl_ga | sfl | psl | fl
    cut_layer: int = 1  # v: client side = embed + layers[:v]
    local_epochs: int = 1  # tau (legacy alias; prefer ``tau``)
    lr: float = 1e-3
    # cut-layer protocol engine (core.protocol): transport codecs for the
    # smashed-data boundary and τ local steps per round. Defaults (fp32,
    # τ=1) reproduce the pre-engine train step bit for bit.
    uplink_codec: str = "fp32"
    downlink_codec: str = "fp32"
    tau: Optional[int] = None  # None -> local_epochs
    optimizer: str = "sgd"  # sgd | momentum | adamw
    weight_decay: float = 0.0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    fsdp: bool = False  # reduce-scatter server params over data axis
    expert_parallel: bool = False  # shard experts over data axis (hillclimb)
    resync_every: int = 0  # 0 = never re-sync client-side models (paper default)
    # PEFT: "none" keeps the full-parameter path bit-identical to before the
    # adapter refactor; "lora" freezes the base model and federates only
    # per-sublayer low-rank A/B factors (DESIGN.md §17).
    peft: str = "none"  # none | lora
    lora_rank: int = 8
    lora_alpha: float = 16.0
    seed: int = 0

    @property
    def resolved_tau(self) -> int:
        """τ local steps per round; ``tau`` wins over ``local_epochs``."""
        return self.local_epochs if self.tau is None else self.tau
