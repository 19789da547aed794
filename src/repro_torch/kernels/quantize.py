"""The cut-layer int8/int4 codec: the Hopper kernels' wrappers and their
plain PyTorch versions.

Port of ``repro.kernels.quantize`` (TPU Pallas: ``quantize_pack``, body
``_quantize_kernel``; ``dequant_agg_reduce``, body
``_dequant_agg_kernel``) and its oracles ``repro.kernels.ref.
quantize_ref`` / ``dequant_agg_ref``.

* ``quantize_pack`` -- per (client, bt x bd tile) symmetric quantization:
  scale = absmax * f32(1/qmax), or 1 for an all-zero tile; q =
  clip(floor(g / scale + u), -qmax, qmax) with u from the counter hash
  :func:`hash_uniform` of the global (n, t, d, seed), or 0.5 for
  round-to-nearest; int4 packs pairs, the even index in the low nibble.
  ``client_seeds`` generalizes the seed: client n then hashes (0, t, d,
  client_seeds[n]), which is K separate codec encodes (each hashing its
  own flat index at n = 0 with its own seed) in one launch. Without it
  every client hashes (n, t, d, seed): the reference kernel.
* ``dequant_agg_reduce`` -- out = sum_n rho[n] * scale[n, tile] *
  q[n] in f32, without per-client tensors; at N = 1, rho = 1 it is the
  codec's decode.

Each wrapper takes the plain version for a CPU tensor, and for a CUDA
tensor launches the kernel in ``csrc/quantize.cu`` on the path that
:func:`quantize_plan` / :func:`dequant_plan` pick from shapes and
alignment, or raises; each counts its launches in ``.launches``. The
plain versions follow the Pallas bodies' op order, so the codec's bits
match the reference bit for bit on the CPU, and the kernels match the
plain versions bit for bit on the card.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# xxhash/murmur-style odd multipliers of repro.kernels.quantize.hash_uniform
_K_N = 0x9E3779B1
_K_T = 0x85EBCA77
_K_D = 0xC2B2AE3D
_K_S = 0x27D4EB2F
_M1 = 0x2C1B3C6D
_M2 = 0x297A2D39
_U32 = 0xFFFFFFFF


def qmax_for(bits: int) -> int:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return (1 << (bits - 1)) - 1  # 7 / 127: symmetric, no -2^(b-1) code


def _mul32(a, k: int):
    """(a * k) mod 2^32 for int64 tensors holding uint32 values. The
    multiplier is split in 16-bit halves so no product leaves int64."""
    lo = a * (k & 0xFFFF)
    hi = (a * (k >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _u32(x, device=None):
    """uint32 values as an int64 tensor (ints are masked to 32 bits)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _U32
    return torch.as_tensor(int(x) & _U32, dtype=torch.int64, device=device)


def hash_uniform(n, t, d, seed):
    """Counter-based uniform [0, 1) from global coordinates: the
    reference's ``repro.kernels.quantize.hash_uniform`` bit for bit.

    The reference computes in uint32; torch has no uint32 ``>>`` on the
    CPU, so this computes in int64 and masks every product to 32 bits.
    ``n``, ``t``, ``d`` and ``seed`` are int64 tensors holding uint32
    values, or ints, broadcastable to a common shape."""
    dev = next((x.device for x in (n, t, d, seed)
                if isinstance(x, torch.Tensor)), None)
    h = (_mul32(_u32(n, dev), _K_N) ^ _mul32(_u32(t, dev), _K_T)
         ^ _mul32(_u32(d, dev), _K_D) ^ _mul32(_u32(seed, dev), _K_S))
    h = h ^ (h >> 15)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


# The kernels' launch shapes (csrc/quantize.cu)
THREADS = 256            # threads a block, every path
WARPS = THREADS // 32    # warp path: tiles a block
MAX_CLUSTER = 8          # the portable cluster size
MAX_UNITS = 8            # float4 units a thread holds: 32 values
WARP_TILE = 32 * 4 * MAX_UNITS                          # 1,024 elements
CLUSTER_TILE = MAX_CLUSTER * THREADS * 4 * MAX_UNITS    # 65,536 elements
SEGMENT = 1024           # B3 general path: columns a warp
_INT32 = 2 ** 31


def _pow2(x: int) -> int:
    """The least power of two at or above x (x >= 1)."""
    return 1 << (x - 1).bit_length()


class QuantPlan(NamedTuple):
    """How :func:`quantize_pack` launches B2, from shapes alone.

    ``path``: ``"warp"`` (one warp a tile, ``WARPS`` tiles a block: tile
    = block * WARPS + warp), ``"cluster"`` (one tile a cluster of
    ``cluster`` consecutive blocks: tile = block // cluster) or
    ``"general"`` (one block a tile). On the two vector paths a tile has
    S threads (the warp's 32 lanes, or the cluster's ``cluster *
    THREADS``), and thread i holds the tile's 4-element units i + k S, k
    < ``units``, in registers: ``values`` = 4 * ``units`` f32. The
    general path holds ``values`` (1, or a pair for int4) at a time."""
    path: str
    grid: int
    cluster: int
    units: int
    values: int


def quantize_plan(N, T, D, bt, bd, bits, sms, aligned=True) -> QuantPlan:
    """B2's path for (N, T, D) f32 in (bt, bd) tiles on ``sms``
    multiprocessors. ``aligned``: g's data is 16-byte aligned.

    The vector paths need 16-byte units: bd % 4 == 0 (so D % 4 == 0 and
    every tile row starts on 16 bytes) and an aligned g. Tiles of at most
    ``WARP_TILE`` elements take the warp path; up to ``CLUSTER_TILE`` the
    cluster path, with the fewest blocks that hold the tile at
    ``MAX_UNITS`` a thread, doubled up to ``MAX_CLUSTER`` while the grid
    is short of 4 blocks an SM and each block keeps a full row of
    threads' units. The rest take the general path."""
    tiles = N * (T // bt) * (D // bd)
    elems = bt * bd
    units = elems // 4
    if aligned and bd % 4 == 0 and tiles < _INT32:
        if elems <= WARP_TILE:
            k = _pow2(-(-units // 32))
            return QuantPlan("warp", -(-tiles // WARPS), 1, k, 4 * k)
        if elems <= CLUSTER_TILE:
            c = _pow2(-(-units // (THREADS * MAX_UNITS)))
            while (c < MAX_CLUSTER and tiles * c < 4 * sms
                   and 2 * c * THREADS <= units):
                c *= 2
            if tiles * c < _INT32:
                k = _pow2(-(-units // (c * THREADS)))
                return QuantPlan("cluster", tiles * c, c, k, 4 * k)
    return QuantPlan("general", tiles, 1, 0, 2 if bits == 4 else 1)


class DequantPlan(NamedTuple):
    """How :func:`dequant_agg_reduce` launches B3. ``"vector"``: thread i
    of the grid owns outputs (t, d0 .. d0 + 15) with t, g = divmod(i, D /
    16), d0 = 16 g. ``"general"``: warp s of the grid owns row t's columns
    [SEGMENT j, SEGMENT (j + 1)) with t, j = divmod(s, ceil(D /
    SEGMENT))."""
    path: str
    grid: int


def dequant_plan(N, T, D, bt, bd, bits, aligned=True) -> DequantPlan:
    """B3's path for N payloads of (T, D) in (bt, bd) tiles. ``aligned``:
    q's data is 16-byte aligned. The vector path needs bd % 16 == 0 (16
    outputs a thread inside one tile column; D % 16 == 0 follows) and an
    aligned q."""
    if aligned and bd % 16 == 0 and T * (D // 16) < _INT32:
        return DequantPlan("vector", -(-T * (D // 16) // THREADS))
    segs = T * -(-D // SEGMENT)
    return DequantPlan("general", -(-segs // WARPS))


_QUANT_PATHS = {"general": 0, "warp": 1, "cluster": 2}
_DEQUANT_PATHS = {"general": 0, "vector": 1}


def unpack_int4(q):
    """(..., D/2) packed int8 -> (..., D) int32 in [-8, 7]."""
    q = q.to(torch.int32)
    lo = q & 15
    hi = (q >> 4) & 15
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(q.shape[:-1] + (-1,))


def _tiles(T, D, block_t, block_d, bits):
    block_t, block_d = min(block_t, T), min(block_d, D)
    if T % block_t or D % block_d:
        raise ValueError(f"(T, D) = ({T}, {D}) is not a whole number of "
                         f"({block_t}, {block_d}) tiles")
    if bits == 4 and block_d % 2:
        raise ValueError(f"int4 packs pairs: block_d {block_d} must be even")
    return block_t, block_d


def _expand(scales, block_t, block_d):
    """(N, Tt, Dt) -> (N, T, D) by tile repetition."""
    return scales.repeat_interleave(block_t, 1).repeat_interleave(block_d, 2)


def quantize_ref(g, seed=0, bits: int = 8, block_t: int = 256,
                 block_d: int = 256, stochastic: bool = True,
                 client_seeds=None):
    """Plain version of :func:`quantize_pack`. g: (N, T, D). Returns
    (q (N, T, D*bits/8) int8, scales (N, T/bt, D/bd) f32)."""
    N, T, D = g.shape
    qmax = qmax_for(bits)
    bt, bd = _tiles(T, D, block_t, block_d, bits)
    g32 = g.float()
    absmax = g32.abs().reshape(N, T // bt, bt, D // bd, bd).amax(dim=(2, 4))
    scales = torch.where(absmax > 0.0, absmax * (1.0 / qmax),
                         torch.ones_like(absmax))
    if stochastic:
        dev = g.device
        t = torch.arange(T, dtype=torch.int64, device=dev)[None, :, None]
        d = torch.arange(D, dtype=torch.int64, device=dev)[None, None, :]
        if client_seeds is None:
            n = torch.arange(N, dtype=torch.int64, device=dev)[:, None, None]
            u = hash_uniform(n, t, d, seed)
        else:
            u = hash_uniform(0, t, d, _u32(client_seeds).to(dev)[:, None,
                                                                 None])
    else:
        u = 0.5
    q = torch.clamp(torch.floor(g32 / _expand(scales, bt, bd) + u),
                    -qmax, qmax).to(torch.int32)
    if bits == 4:
        pairs = q.reshape(N, T, D // 2, 2)
        q = ((pairs[..., 1] & 15) << 4) | (pairs[..., 0] & 15)
    return q.to(torch.int8), scales


def dequant_agg_ref(q, scales, rho, bits: int = 8, block_t: int = 256,
                    block_d: int = 256):
    """Plain version of :func:`dequant_agg_reduce`: clients in order
    0..N-1, acc + rho[n] * (q * scale) with one rounding per op.
    Returns (T, D) f32."""
    qi = unpack_int4(q) if bits == 4 else q.to(torch.int32)
    N, T, D = qi.shape
    bt, bd = _tiles(T, D, block_t, block_d, bits)
    s_full = _expand(scales.float(), bt, bd)
    r32 = rho.float()
    acc = torch.zeros((T, D), dtype=torch.float32, device=q.device)
    for n in range(N):
        acc = acc + r32[n] * (qi[n].to(torch.float32) * s_full[n])
    return acc


def _check(tensors, device):
    for name, t, dtype in tensors:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib():
    lib = _build.load("quantize")
    if lib.quantize_pack_f32.argtypes is None:
        lib.quantize_pack_f32.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
            + [ctypes.c_uint, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.quantize_pack_f32.restype = ctypes.c_int
        lib.dequant_agg_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_uint, ctypes.c_void_p])
        lib.dequant_agg_f32.restype = ctypes.c_int
    return lib


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def quantize_pack(g, seed=0, bits: int = 8, block_t: int = 256,
                  block_d: int = 256, stochastic: bool = True,
                  client_seeds=None):
    """Quantize and pack (N, T, D) f32 per (client, tile). Returns
    (q: (N, T, D*bits/8) int8, scales: (N, T/bt, D/bd) f32).

    ``client_seeds``: optional (N,) int64 tensor of uint32 seeds, one per
    client, on g's device; client n then hashes (0, t, d,
    client_seeds[n]). On a CPU tensor this is the plain version; on a
    CUDA tensor it launches the Hopper kernel on the path of
    :func:`quantize_plan`, on the current stream (no synchronisation),
    and raises if the launch fails."""
    if g.device.type == "cpu":
        return quantize_ref(g, seed, bits, block_t, block_d, stochastic,
                            client_seeds)
    if g.device.type != "cuda":
        raise ValueError(f"quantize_pack runs on cpu or cuda, got {g.device}")
    if g.dim() != 3:
        raise ValueError(f"g must be (N, T, D), got {tuple(g.shape)}")
    N, T, D = g.shape
    qmax_for(bits)
    bt, bd = _tiles(T, D, block_t, block_d, bits)
    checks = [("g", g, torch.float32)]
    if client_seeds is not None:
        checks.append(("client_seeds", client_seeds, torch.int64))
        if tuple(client_seeds.shape) != (N,):
            raise ValueError(f"client_seeds {tuple(client_seeds.shape)} for "
                             f"{N} clients")
    _check(checks, g.device)
    q = torch.empty((N, T, D // 2 if bits == 4 else D), dtype=torch.int8,
                    device=g.device)
    scales = torch.empty((N, T // bt, D // bd), dtype=torch.float32,
                         device=g.device)
    if q.numel() == 0:
        return q, scales
    plan = quantize_plan(N, T, D, bt, bd, bits,
                         _build.sm_count(g.device.index),
                         aligned=g.data_ptr() % 16 == 0)
    if plan.grid >= _INT32:
        raise ValueError(f"g {tuple(g.shape)} has {plan.grid} tiles of "
                         f"({bt}, {bd}): more than a grid holds")
    fn = _lib().quantize_pack_f32
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), q.data_ptr(), scales.data_ptr(), N, T, D, bt,
                 bd, bits, int(stochastic), int(seed) & 0xFFFFFFFF,
                 None if client_seeds is None else client_seeds.data_ptr(),
                 _QUANT_PATHS[plan.path], plan.grid, plan.cluster, plan.units,
                 _stream(g.device))
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed with CUDA error "
                           f"{err} (g {tuple(g.shape)}, tile ({bt}, {bd}), "
                           f"{plan})")
    quantize_pack.launches += 1
    return q, scales


def dequant_agg_reduce(q, scales, rho, bits: int = 8, block_t: int = 256,
                       block_d: int = 256):
    """Fused decode + eq. 5: sum_n rho[n] * scale[n, tile] * q[n]. q:
    (N, T, Dq) int8 payloads from :func:`quantize_pack`; scales (N, T/bt,
    D/bd); rho (N,). The tiling must be the encoder's. Returns (T, D)
    f32. CPU tensors take the plain version; CUDA tensors launch the
    kernel on the path of :func:`dequant_plan`, or raise."""
    if q.device.type == "cpu":
        return dequant_agg_ref(q, scales, rho, bits, block_t, block_d)
    if q.device.type != "cuda":
        raise ValueError(f"dequant_agg_reduce runs on cpu or cuda, got "
                         f"{q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be (N, T, Dq), got {tuple(q.shape)}")
    qmax_for(bits)
    N, T, Dq = q.shape
    D = 2 * Dq if bits == 4 else Dq
    bt, bd = _tiles(T, D, block_t, block_d, bits)
    if tuple(scales.shape) != (N, T // bt, D // bd) \
            or tuple(rho.shape) != (N,):
        raise ValueError(f"scales {tuple(scales.shape)} / rho "
                         f"{tuple(rho.shape)} do not match q "
                         f"{tuple(q.shape)} in ({bt}, {bd}) tiles")
    _check([("q", q, torch.int8), ("scales", scales, torch.float32),
            ("rho", rho, torch.float32)], q.device)
    out = torch.empty((T, D), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    plan = dequant_plan(N, T, D, bt, bd, bits,
                        aligned=q.data_ptr() % 16 == 0)
    if plan.grid >= _INT32:
        raise ValueError(f"out {(T, D)} needs {plan.grid} blocks: more "
                         f"than a grid holds")
    fn = _lib().dequant_agg_f32
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), scales.data_ptr(), rho.data_ptr(),
                 out.data_ptr(), N, T, D, bt, bd, bits,
                 _DEQUANT_PATHS[plan.path], plan.grid, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"dequant kernel launch failed with CUDA error "
                           f"{err} (q {tuple(q.shape)}, tile ({bt}, {bd}), "
                           f"{plan})")
    dequant_agg_reduce.launches += 1
    return out


quantize_pack.launches = 0
dequant_agg_reduce.launches = 0
