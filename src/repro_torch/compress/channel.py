"""The lossy cut-layer channel: who encodes with which seed.

Port of ``repro.compress.channel``, the one place that says how the
simulator and the gradagg boundary use the wire:

* client n encodes with ``seed + n * GOLDEN`` (mod 2^32) so stochastic
  rounding decorrelates across clients;
* downlink seeds are the uplink's XOR ``DOWNLINK_MIX``, so the two
  directions of one round never share a rounding pattern;
* identity codecs return their input object, keeping fp32 runs bit for
  bit identical to uncompressed ones.

Seeds are uint32 values held in Python ints or int64 tensors. The
per-client channels run all K clients of an int codec in one encode and
one decode launch (``IntQuantCodec.encode_clients``), with the same bits
as K separate ``roundtrip`` calls; other codecs go client by client.
"""
from __future__ import annotations

import torch

from repro_torch.compress.codecs import IntQuantCodec

GOLDEN = 0x9E3779B1  # per-client seed stride (odd => bijective mod 2^32)
DOWNLINK_MIX = 0x5BD1E995  # uplink/downlink seed decorrelation
_U32 = 0xFFFFFFFF


def client_seeds(seed, n: int, device="cpu") -> torch.Tensor:
    """(n,) per-client seeds from one round seed, as an int64 tensor of
    uint32 values on ``device``."""
    k = torch.arange(n, dtype=torch.int64, device=device)
    return (int(seed) + k * GOLDEN) & _U32


def downlink_seed(seed) -> int:
    return (int(seed) & _U32) ^ DOWNLINK_MIX


def _per_client(codec, x, seed):
    seeds = client_seeds(seed, x.shape[0], x.device)
    if isinstance(codec, IntQuantCodec):
        return codec.decode_clients(codec.encode_clients(x, seeds))
    return torch.stack([codec.roundtrip(x[k], int(s))
                        for k, s in enumerate(seeds.tolist())])


def uplink_channel(codec, x, seed):
    """Per-client lossy uplink: x is (N, ...); client n round-trips its
    slice through ``codec`` with its own seed."""
    if codec.is_identity:
        return x
    return _per_client(codec, x, seed)


def unicast_channel(codec, x, seed):
    """Per-client lossy downlink (sfl/psl unicast cotangents)."""
    if codec.is_identity:
        return x
    return _per_client(codec, x, downlink_seed(seed))


def broadcast_channel(codec, agg, seed):
    """Single-payload lossy downlink: the SFL-GA aggregate is encoded
    once. ``agg`` has no client axis."""
    if codec.is_identity:
        return agg
    return codec.roundtrip(agg, downlink_seed(seed))
