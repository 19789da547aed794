"""The int8 wire format of the cut layer, as a plain frozen copy.

Symmetric absmax quantization over flat 256-element tiles of each
payload, one float32 scale a tile (absmax * f32(1/127), 1 for an
all-zero tile), with counter-hash stochastic rounding: q = clip(floor(x /
scale + u), -127, 127), u the hash of (0, 0, flat index, seed) in [0, 1).
The receiver reads q * scale. Client n's uplink seed is seed + n *
0x9E3779B1 (mod 2^32); the broadcast downlink's is seed ^ 0x5BD1E995.
These are the paper artifact's codec constants (the hash's odd
multipliers and shifts), copied here so that the check shares no code
with the program.
"""
from __future__ import annotations

import torch

TILE = 256
QMAX = 127
GOLDEN = 0x9E3779B1
DOWNLINK_MIX = 0x5BD1E995
_U32 = 0xFFFFFFFF
_K_N, _K_T, _K_D, _K_S = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F
_M1, _M2 = 0x2C1B3C6D, 0x297A2D39


def _mul32(a, k):
    """(a * k) mod 2^32 on int64 tensors holding uint32 values."""
    return ((a * (k & 0xFFFF)) + (((a * (k >> 16)) & 0xFFFF) << 16)) & _U32


def hash_uniform(d, seed: int):
    """u in [0, 1) of the flat indices ``d`` (int64) at n = t = 0."""
    s = torch.tensor(int(seed) & _U32, dtype=torch.int64, device=d.device)
    zero = torch.zeros((), dtype=torch.int64, device=d.device)
    h = (_mul32(zero, _K_N) ^ _mul32(zero, _K_T) ^ _mul32(d, _K_D)
         ^ _mul32(s, _K_S))
    h = h ^ (h >> 15)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def roundtrip(x, seed: int):
    """What the receiver reads of one payload ``x`` sent with ``seed``."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    pad = (-n) % TILE
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    tiles = flat.view(-1, TILE)
    absmax = tiles.abs().amax(dim=1, keepdim=True)
    inv = torch.tensor(1.0 / QMAX, dtype=torch.float32, device=x.device)
    scale = torch.where(absmax > 0, absmax * inv, torch.ones_like(absmax))
    d = torch.arange(flat.numel(), dtype=torch.int64,
                     device=x.device).view(-1, TILE)
    q = torch.clamp(torch.floor(tiles / scale + hash_uniform(d, seed)),
                    -QMAX, QMAX)
    return (q * scale).reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def uplink_seed(seed: int, n: int) -> int:
    return (int(seed) + n * GOLDEN) & _U32


def downlink_seed(seed: int) -> int:
    return (int(seed) & _U32) ^ DOWNLINK_MIX
