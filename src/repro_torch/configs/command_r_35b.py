"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01].

Dense GQA decoder, 40L, d_model=8192, 64 heads (kv=8), d_ff=22528,
vocab=256000. No biases; Cohere-style parallel attention+MLP block.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=8_000_000.0,
    attn_bias=False,
    mlp_bias=False,
    parallel_block=True,
    mlp_act="swiglu",
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
