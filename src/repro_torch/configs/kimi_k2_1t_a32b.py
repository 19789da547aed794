"""Kimi K2 1T-A32B [arXiv:2501.kimi2] — trillion-param MoE (paper-table).

61L, d_model=7168, 64 heads (kv=8), expert d_ff=2048, vocab=163840,
384 experts top-8, 1 shared expert, first layer dense.
(The released model uses MLA; the assignment specifies GQA kv=8 — we follow
the assignment; see DESIGN.md adaptations.)
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,  # 7168/64
    d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, first_k_dense=1),
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2",
)
