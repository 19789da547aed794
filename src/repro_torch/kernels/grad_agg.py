"""rho-weighted gradient aggregation (paper eq. 5): the Hopper kernel's
wrapper, its launch plan and its plain PyTorch version.

Port of ``repro.kernels.grad_agg.grad_agg_reduce`` (TPU Pallas, body
``_grad_agg_kernel``) and its oracle ``repro.kernels.ref.grad_agg_ref``:
out = sum_n rho[n] * g[n], accumulated in float32 and cast to g's dtype.
The server runs it on every local epoch of SFL-GA to aggregate the
clients' smashed-data gradients into the one broadcast payload.

* :func:`grad_agg_reduce` is the wrapper. A CPU tensor takes the plain
  version; a CUDA tensor launches the hand-written kernel in
  ``csrc/grad_agg.cu`` (built at first use, see ``_build``) on the path
  that :func:`grad_agg_plan` picks from shapes and alignment, or raises.
  ``grad_agg_reduce.launches`` counts kernel launches.
* :func:`grad_agg_ref` is the plain version: the clients in order 0..N-1,
  one f32 multiply and one add each -- the kernel's arithmetic on every
  path, so the two agree bit for bit.

The reference takes (N, T, D) with T and D divisible by its TPU tile;
both versions here take any contiguous (N, ...) and reduce the leading
axis (``ops.grad_agg`` keeps the reference's model-layout signature).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# The kernel's launch shapes (csrc/grad_agg.cu)
MAX_CLIENTS = 16       # wave and stream: N is a template parameter
WAVE_THREADS = 128     # wave: threads a block, one 16-byte unit each
STREAM_THREADS = 256   # stream: threads a block
STREAM_LOADS = 16      # stream: 16-byte loads a thread a tile, at most
THREADS = 256          # general: threads a block
_INT32 = 2 ** 31


class GradAggPlan(NamedTuple):
    """How :func:`grad_agg_reduce` launches B1, from shapes alone.

    ``path``: ``"wave"`` (block b's thread i owns unit b * 128 + i of
    every client, all loaded before the first add), ``"stream"`` (a
    persistent grid walks tiles of 256 K units, K = ``stream_units(N)``:
    tile b, b + grid, ...) or ``"general"`` (a grid-stride walk, in
    float4 units where M % 4 == 0 and g is 16-byte aligned, else single
    f32). ``grid``: blocks."""
    path: str
    grid: int


def wave_blocks_per_sm(loads: int) -> int:
    """Blocks of ``WAVE_THREADS`` an SM holds at ``loads`` 16-byte units a
    thread (4 registers each, 32 for the rest, in granules of 8; 65,536
    registers, at most 16 blocks): what ``__launch_bounds__`` guarantees
    each wave kernel."""
    return min(16, 512 // (-(-(4 * loads + 32) // 8) * 8))


def stream_units(N: int) -> int:
    """Stream path: units a thread a tile, the most of 4, 2, 1 with N K
    <= ``STREAM_LOADS``."""
    return next(k for k in (4, 2, 1) if N * k <= STREAM_LOADS)


def wave_plan(M: int) -> GradAggPlan:
    """The wave path: one block a 128 units (M % 4 == 0)."""
    return GradAggPlan("wave", -(-(M // 4) // WAVE_THREADS))


def stream_plan(N: int, M: int, sms: int) -> GradAggPlan:
    """The stream path: 2 blocks an SM, never more blocks than tiles
    (M % 4 == 0)."""
    tiles = -(-(M // 4) // (STREAM_THREADS * stream_units(N)))
    return GradAggPlan("stream", min(tiles, 2 * sms))


def general_plan(M: int, sms: int, vec: bool) -> GradAggPlan:
    """The grid-stride walk in float4 units (``vec``) or single f32."""
    work = M // 4 if vec else M
    return GradAggPlan("general",
                       max(1, min(-(-work // THREADS), 16 * sms)))


def grad_agg_plan(N: int, M: int, sms: int,
                  aligned: bool = True) -> GradAggPlan:
    """B1's path for (N, M) f32 on ``sms`` multiprocessors. ``aligned``:
    g's data is 16-byte aligned.

    The wave and stream paths need 16-byte units (M % 4 == 0, aligned),
    1 <= N <= ``MAX_CLIENTS`` and 32-bit offsets (N M < 2^31). The wave
    path takes payloads whose grid fits one wave at the residency of
    ``wave_blocks_per_sm(N)``, so every load is in flight at once, and
    every SM has a block once the payload has 128 units an SM. Larger
    payloads stream (``stream_plan``): past one wave the stream path was
    the faster on the card with a cold L2 (``tools/grad_agg_forms.py``).
    The rest take the general path."""
    vec = aligned and M % 4 == 0
    if vec and 1 <= N <= MAX_CLIENTS and N * M < _INT32:
        plan = wave_plan(M)
        if plan.grid <= sms * wave_blocks_per_sm(N):
            return plan
        return stream_plan(N, M, sms)
    return general_plan(M, sms, vec)


_PATHS = {"general": 0, "wave": 1, "stream": 2}


def grad_agg_ref(g, rho):
    """Plain version. g: (N, ...); rho: (N,). Returns g.shape[1:] in
    g's dtype."""
    g32 = g.float()
    r32 = rho.float()
    acc = torch.zeros(g.shape[1:], dtype=torch.float32, device=g.device)
    for n in range(g.shape[0]):
        acc = acc + r32[n] * g32[n]
    return acc.to(g.dtype)


def _kernel():
    fn = _build.load("grad_agg").grad_agg_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def plan_for(g):
    """The plan :func:`grad_agg_reduce` takes for the CUDA tensor g."""
    n, m = g.shape[0], math.prod(g.shape[1:])
    return grad_agg_plan(n, m, _build.sm_count(g.device.index),
                         aligned=g.data_ptr() % 16 == 0)


def _launch(g, rho, plan):
    """One launch of B1 on ``plan`` (checked inputs; out is fresh, so
    16-byte aligned)."""
    out = torch.empty(g.shape[1:], dtype=torch.float32, device=g.device)
    n, m = g.shape[0], out.numel()
    if m == 0:
        return out
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = _kernel()(g.data_ptr(), rho.data_ptr(), out.data_ptr(), n, m,
                        _PATHS[plan.path], plan.grid, stream)
    if err != 0:
        raise RuntimeError(f"grad_agg kernel launch failed with CUDA error "
                           f"{err} (g {tuple(g.shape)}, {plan})")
    grad_agg_reduce.launches += 1
    return out


def grad_agg_reduce(g, rho):
    """sum_n rho[n] * g[n] over the leading client axis of ``g``.

    On a CPU tensor this is the plain version; on a CUDA tensor it
    launches the Hopper kernel on the path of :func:`grad_agg_plan`, on
    the current stream (no synchronisation), and raises if the launch
    fails. The kernel takes contiguous float32 ``g`` and ``rho`` on one
    device."""
    if g.device.type == "cpu":
        return grad_agg_ref(g, rho)
    if g.device.type != "cuda":
        raise ValueError(f"grad_agg_reduce runs on cpu or cuda, got "
                         f"{g.device}")
    if g.dim() < 2 or tuple(rho.shape) != (g.shape[0],):
        raise ValueError(f"g {tuple(g.shape)} needs a leading client axis "
                         f"matching rho {tuple(rho.shape)}")
    for name, t in (("g", g), ("rho", rho)):
        if t.device != g.device:
            raise ValueError(f"{name} is on {t.device}, g on {g.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return _launch(g, rho, plan_for(g))


grad_agg_reduce.launches = 0
