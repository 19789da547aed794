"""StarCoder2 3B [arXiv:2402.19173].

30L, d_model=3072, 24 heads (kv=2), d_ff=12288, vocab=49152.
GQA + RoPE, sliding window 4096 (as in the released model), GELU MLP, biases.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=100_000.0,
    sliding_window=4096,
    mlp_act="gelu",
    attn_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    source="arXiv:2402.19173",
)
