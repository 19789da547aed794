"""Model configuration dataclasses: a copy of ``repro.configs.base``.

The port carries its own copy (it imports nothing of ``repro``); the
fields and their meaning are the reference's, so a config is the same
value in both packages. Trimmed to the model-shape classes the serve
slice needs: the input-shape table, ``PeftSpec`` and ``TrainConfig`` come
with the slices that use them.
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
