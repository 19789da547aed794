"""M1: the mixture-of-experts layer's combine, for ``models/moe.py``: the
Hopper kernel's wrapper and its plain PyTorch version.

Replaces no TPU kernel: on the TPU the combine was XLA's gather and
einsum. On the card PyTorch's gather backward (``index_put_`` with
accumulation) sorted the indices and walked the slack row's repeats in
one warp, ~15 % of a granite-4.0-h train step.

    y[t]        = sum over kept j of gates[t, j] ye[slot[t, j]]
    dye[r]      = gates[t, j] dy[t] for the pair (t, j) owning row r, else 0
    dgates[t,j] = <dy[t], ye[slot[t, j]]> for a kept pair, else 0

``ye`` (R, d) float32 rows (the expert products' output, viewed with no
copy), ``slot`` (T, k) int64 and ``gates`` (T, k) float32. A slot equal
to R (the slack row: a drop, or a pair routed to an expert held
elsewhere) is skipped; the kept slots are unique, as the layer's
dispatch makes them. ``kernels.ops.moe_combine`` is the autograd op that
takes them.

* :func:`moe_combine` and :func:`moe_combine_grad` are the wrapper's
  forward and backward. A CPU tensor takes the plain version; a CUDA
  tensor launches the kernels in ``csrc/moe_combine.cu`` (built at first
  use, see ``_build``) or raises: no fallback from the card. They take
  contiguous float32 rows of whole 16-byte words from a 16-byte aligned
  base, int64 slots, float32 gates, and k up to :data:`MAX_K`.
  ``moe_combine.launches`` counts kernel launches (one a forward, two a
  backward: the inverse map and the rows); ``moe_combine.passed`` counts
  the combines the op's rule left on the plain version on the card.
* :func:`moe_combine_ref` is the plain version: the layer's earlier
  expression (a zero row appended, ``flat[slot]``, the ``einsum`` over
  the gates times the kept mask), and :func:`moe_combine_grad_ref` its
  backward as autograd takes it, so the CPU path is the earlier one bit
  for bit.

The kernel sums a token's kept choices in choice order with ``fmaf`` and
reduces ``dgates`` over d in a fixed order (registers, warp shuffles,
the block's warps): its bits do not change from launch to launch, and
differ from the plain version's by f32 rounding. ``dye`` is one product
an element, equal to the plain version's. Its bound on an H100 is bytes
over 3.35 TB/s; the design is written at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

MAX_K = 32  # kMaxK in csrc/moe_combine.cu: one warp reads a token's slots


def moe_combine_ref(ye, slot, gates, keep=None, zero=None):
    """Plain version of :func:`moe_combine`. ``keep`` (T, k), the kept
    pairs, is ``slot < R`` unless given; ``zero``, the (1, d) row
    appended for the slack, is made here unless given (the layer's
    routing groups share one)."""
    R, d = ye.shape
    T, k = slot.shape
    if zero is None:
        zero = torch.zeros((1, d), dtype=ye.dtype, device=ye.device)
    flat = torch.cat([ye, zero], 0)
    yk = flat[slot.reshape(-1)].reshape(T, k, d)
    keep = slot < R if keep is None else keep
    w = gates.to(ye.dtype) * keep.to(ye.dtype)
    return torch.einsum("tkd,tk->td", yk, w)


def moe_combine_grad_ref(dy, ye, slot, gates):
    """Plain version of :func:`moe_combine_grad`: autograd through
    :func:`moe_combine_ref`."""
    with torch.enable_grad():
        ye, gates = (t.detach().requires_grad_(True) for t in (ye, gates))
        y = moe_combine_ref(ye, slot, gates)
        return torch.autograd.grad(y, (ye, gates), dy)


def _check(ye, slot, gates, dy=None):
    if ye.device.type != "cuda" or any(t.device != ye.device
                                       for t in (slot, gates)):
        raise ValueError(f"moe_combine runs on cpu or cuda with every "
                         f"operand on one device, got {ye.device}, "
                         f"{slot.device} and {gates.device}")
    if ye.dim() != 2 or slot.dim() != 2 or gates.shape != slot.shape:
        raise ValueError(f"moe_combine takes ye (R, d), slot (T, k) and "
                         f"gates (T, k), got {tuple(ye.shape)}, "
                         f"{tuple(slot.shape)} and {tuple(gates.shape)}")
    R, d = ye.shape
    T, k = slot.shape
    rows = [("ye", ye)] + ([] if dy is None else [("dy", dy)])
    if dy is not None and dy.shape != (T, d):
        raise ValueError(f"moe_combine's dy is ({T}, {d}), got "
                         f"{tuple(dy.shape)}")
    for name, t in rows:
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"moe_combine operand {name} {tuple(t.shape)} {t.dtype} "
                f"with strides {t.stride()} is not as the kernel reads "
                f"it: float32, contiguous, a 16-byte aligned base")
    if d % 4 or d == 0:
        raise ValueError(f"moe_combine takes rows of whole 16-byte words, "
                         f"got d {d}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"moe_combine takes 1 to {MAX_K} choices a token, "
                         f"got {k}")
    if (slot.dtype != torch.int64 or gates.dtype != torch.float32
            or not slot.is_contiguous() or not gates.is_contiguous()):
        raise ValueError(f"moe_combine takes contiguous int64 slots and "
                         f"float32 gates, got {slot.dtype} and "
                         f"{gates.dtype}")
    if T * k >= 2 ** 31 or R >= 2 ** 31:
        raise ValueError(f"moe_combine indexes pairs and rows in 32 bits, "
                         f"got {T} x {k} pairs and {R} rows")


def _library():
    from repro_torch.kernels import _build

    lib = _build.load("moe_combine")
    if lib.m1_combine_forward.argtypes is None:
        lib.m1_combine_forward.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.m1_combine_forward.restype = ctypes.c_int
        lib.m1_combine_backward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.m1_combine_backward.restype = ctypes.c_int
    return lib


def _raise_on(err, what, ye, slot):
    if err != 0:
        raise RuntimeError(f"moe_combine {what} launch failed with code "
                           f"{err} (ye {tuple(ye.shape)}, slot "
                           f"{tuple(slot.shape)})")


def moe_combine(ye, slot, gates):
    """y (T, d) = each token's kept rows of ``ye`` weighted by its gates
    (module docstring). On a CPU tensor this is the plain version; on a
    CUDA tensor it launches the Hopper kernel on the current stream (no
    synchronisation) and raises if the operands are not as the kernel
    reads them or the launch fails."""
    if ye.device.type == "cpu":
        return moe_combine_ref(ye, slot, gates)
    _check(ye, slot, gates)
    (R, d), (T, k) = ye.shape, slot.shape
    y = torch.empty((T, d), dtype=torch.float32, device=ye.device)
    with torch.cuda.device(ye.device):
        stream = torch.cuda.current_stream(ye.device).cuda_stream
        err = _library().m1_combine_forward(
            ye.data_ptr(), slot.data_ptr(), gates.data_ptr(), y.data_ptr(),
            R, T, d, k, stream)
    _raise_on(err, "forward", ye, slot)
    moe_combine.launches += T > 0
    return y


def moe_combine_grad(dy, ye, slot, gates):
    """(dye (R, d), dgates (T, k)) of :func:`moe_combine` at the
    cotangent ``dy`` (T, d): each element written once, with no sort and
    no atomics. On a CPU tensor this is the plain version."""
    if ye.device.type == "cpu":
        return moe_combine_grad_ref(dy, ye, slot, gates)
    _check(ye, slot, gates, dy)
    (R, d), (T, k) = ye.shape, slot.shape
    dye = torch.empty_like(ye)
    dgates = torch.empty((T, k), dtype=torch.float32, device=ye.device)
    inv = torch.empty((R,), dtype=torch.int32, device=ye.device)
    with torch.cuda.device(ye.device):
        stream = torch.cuda.current_stream(ye.device).cuda_stream
        err = _library().m1_combine_backward(
            dy.data_ptr(), ye.data_ptr(), slot.data_ptr(), gates.data_ptr(),
            inv.data_ptr(), dye.data_ptr(), dgates.data_ptr(), R, T, d, k,
            stream)
    _raise_on(err, "backward", ye, slot)
    moe_combine.launches += (R > 0 and T > 0) + (R > 0 or T > 0)
    return dye, dgates


moe_combine.launches = 0
moe_combine.passed = 0
