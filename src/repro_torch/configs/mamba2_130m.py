"""Mamba-2 130M [arXiv:2405.21060] — SSD (state-space duality).

Attention-free, 24L, d_model=768, vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,  # attention-free, no separate MLP: mamba2 block only
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, conv_dim=4, expand=2, head_dim=64, n_groups=1),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
