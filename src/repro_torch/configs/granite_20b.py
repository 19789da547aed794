"""Granite 20B (code) [arXiv:2405.04324].

52L, d_model=6144, 48 heads (kv=1 — MQA), d_ff=24576, vocab=49152.
The released model is gpt-bigcode style (learned positions); we keep the
assignment's MQA + our zoo's RoPE (adaptation noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    arch_type="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp_act="gelu",
    attn_bias=True,
    mlp_bias=True,
    source="arXiv:2405.04324",
)
