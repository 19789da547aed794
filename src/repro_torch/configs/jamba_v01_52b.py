"""Jamba v0.1 52B [arXiv:2403.19887] — hybrid Mamba + attention + MoE.

32L, d_model=4096, 32 heads (kv=8), d_ff=14336, vocab=65536.
Pattern: period 8, attention at offset 4 (1 attn : 7 mamba);
MoE (16 experts top-2) on every other layer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    hybrid_period=8,
    hybrid_attn_offsets=(4,),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336, every=2, first_k_dense=1),
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2, head_dim=64, n_groups=1),
    source="arXiv:2403.19887",
)
