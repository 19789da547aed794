"""Qwen3-MoE 30B-A3B [hf:Qwen/Qwen3-30B-A3B].

48L, d_model=2048, 32 heads (kv=4, head_dim=128), expert d_ff=768,
vocab=151936, 128 experts top-8, QK-norm, all layers MoE.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,  # expert FFN width (A3B active params come from top-8 of these)
    vocab_size=151936,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    rope_theta=1_000_000.0,
    qk_norm=True,
    source="hf:Qwen/Qwen3-30B-A3B",
)
