"""Whisper-tiny [arXiv:2212.04356] — encoder-decoder audio model.

4L enc + 4L dec, d_model=384, 6 heads, d_ff=1536, vocab=51865.
Mel-spectrogram + conv frontend is a STUB per the assignment: input_specs
provides precomputed frame embeddings (batch, 1500, 384).
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,  # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    encoder=EncoderConfig(num_layers=4, num_frames=1500),
    mlp_act="gelu",
    attn_bias=True,
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
