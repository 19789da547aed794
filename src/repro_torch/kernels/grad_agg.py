"""rho-weighted gradient aggregation (paper eq. 5): the Hopper kernel's
wrapper and its plain PyTorch version.

Port of ``repro.kernels.grad_agg.grad_agg_reduce`` (TPU Pallas, body
``_grad_agg_kernel``) and its oracle ``repro.kernels.ref.grad_agg_ref``:
out = sum_n rho[n] * g[n], accumulated in float32 and cast to g's dtype.
The server runs it on every local epoch of SFL-GA to aggregate the
clients' smashed-data gradients into the one broadcast payload.

* :func:`grad_agg_reduce` is the wrapper. A CPU tensor takes the plain
  version; a CUDA tensor launches the hand-written kernel in
  ``csrc/grad_agg.cu`` (built at first use, see ``_build``) or raises.
  ``grad_agg_reduce.launches`` counts kernel launches.
* :func:`grad_agg_ref` is the plain version: the clients in order 0..N-1,
  one f32 multiply and one add each -- the kernel's arithmetic, so the
  two agree bit for bit.

The reference takes (N, T, D) with T and D divisible by its TPU tile;
both versions here take any contiguous (N, ...) and reduce the leading
axis (``ops.grad_agg`` keeps the reference's model-layout signature).
"""
from __future__ import annotations

import ctypes

import torch


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
    from repro_torch.kernels import _build

    fn = _build.load("grad_agg").grad_agg_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                ctypes.c_longlong,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def grad_agg_reduce(g, rho):
    """sum_n rho[n] * g[n] over the leading client axis of ``g``.

    On a CPU tensor this is the plain version; on a CUDA tensor it
    launches the Hopper kernel on the current stream (no
    synchronisation) and raises if the launch fails. The kernel takes
    contiguous float32 ``g`` and ``rho`` on one device."""
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
    out = torch.empty(g.shape[1:], dtype=torch.float32, device=g.device)
    n, m = g.shape[0], out.numel()
    if m == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(g.data_ptr(), rho.data_ptr(), out.data_ptr(), n, m, stream)
    if err != 0:
        raise RuntimeError(f"grad_agg kernel launch failed with CUDA error "
                           f"{err} (g {tuple(g.shape)})")
    grad_agg_reduce.launches += 1
    return out


grad_agg_reduce.launches = 0
