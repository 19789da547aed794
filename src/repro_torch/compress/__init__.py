"""Cut-layer transport codecs (port of ``repro.compress``'s codecs)."""
from repro_torch.compress.codecs import (
    CastCodec,
    Codec,
    IntQuantCodec,
    PassthroughCodec,
    Payload,
    TopKCodec,
    codec_names,
    get_codec,
    hash_uniform,
)

__all__ = [
    "CastCodec", "Codec", "IntQuantCodec", "PassthroughCodec", "Payload",
    "TopKCodec", "codec_names", "get_codec", "hash_uniform",
]
