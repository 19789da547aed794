"""Granite 8B (code) [arXiv:2405.04324] — llama-architecture.

36L, d_model=4096, 32 heads (kv=8), d_ff=14336, vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10_000_000.0,
    mlp_act="swiglu",
    source="arXiv:2405.04324",
)
