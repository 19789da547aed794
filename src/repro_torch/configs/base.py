"""Model configuration dataclasses: a copy of ``repro.configs.base``.

The port carries its own copy (it imports nothing of ``repro``); the
fields and their meaning are the reference's, so a config is the same
value in both packages: the model-shape classes, the input-shape table,
``PeftSpec`` (the LoRA spec a ``ModelPlan`` carries) and ``TrainConfig``
(a training run's settings).
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
    # attention details
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) sections
    qk_norm: bool = False
    attn_bias: bool = False
    mlp_bias: bool = False
    sliding_window: Optional[int] = None  # None = full attention
    parallel_block: bool = False  # cohere/command-r parallel attn+mlp residual
    mlp_act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    logit_softcap: float = 0.0
    # distribution hints, set by the launcher (not by architecture configs):
    # mesh axis to shard the MoE dispatch/expert-compute activations over
    # (expert parallelism), and the number of independent routing groups
    # (aligned with the data shards so position/capacity bookkeeping never
    # crosses a shard — DeepSpeed-style per-rank capacity).
    expert_axis: Optional[str] = None
    routing_groups: int = 1
    # citation for the assignment table
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    def is_attn_layer(self, i: int) -> bool:
        """Whether layer i carries attention (vs SSM) for hybrid patterns."""
        if self.arch_type == "ssm":
            return False
        if self.hybrid_period:
            return (i % self.hybrid_period) in self.hybrid_attn_offsets
        return True

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        if m is None:
            return False
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
