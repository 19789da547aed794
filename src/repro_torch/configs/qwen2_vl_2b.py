"""Qwen2-VL 2B [arXiv:2409.12191] — VLM backbone.

28L, d_model=1536, 12 heads (kv=2, head_dim=128), d_ff=8960, vocab=151936.
M-RoPE (temporal/height/width sections). Vision encoder (ViT) is a STUB per
the assignment: input_specs provides precomputed patch embeddings; this
module is the language/decoder backbone that consumes them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # t/h/w sections of head_dim/2 = 64
    attn_bias=True,  # qwen2 uses QKV bias
    tie_embeddings=True,
    source="arXiv:2409.12191",
)
