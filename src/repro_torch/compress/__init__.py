"""Cut-layer transport codecs and channels (port of ``repro.compress``)."""
from repro_torch.compress.channel import (
    broadcast_channel,
    client_seeds,
    downlink_seed,
    unicast_channel,
    uplink_channel,
)
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
    "TopKCodec", "broadcast_channel", "client_seeds", "codec_names",
    "downlink_seed", "get_codec", "hash_uniform", "unicast_channel",
    "uplink_channel",
]
