"""G1: float32-accurate matrix products on the tensor cores, for the
model's ``linear`` and the MoE layer's experts: the Hopper kernel's
wrapper and its plain PyTorch version.

Replaces no TPU kernel: on the TPU the model's products went to XLA's
``dot``. On the card they ran as cuBLAS's and CUTLASS's f32 SIMT GEMMs
(TF32 off), ~85 % of a granite-8b train step.

Three forms, each over an optional leading batch axis (one weight per
client under ``vmap``, one per expert, or per client and expert), all
float32:

    "y"   Y  = X W      x (B, M, K), w (B, K, N) -> (B, M, N)
    "dx"  dX = dY W^T   dy (B, M, N), w (B, K, N) -> (B, M, K)
    "dw"  dW = X^T dY   x (B, M, K), dy (B, M, N) -> (B, K, N)

(or the same without B). ``kernels.ops.matmul`` is the autograd op
that takes them.

* :func:`gemm` is the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches the hand-written kernel in ``csrc/gemm.cu``
  (built at first use, see ``_build``) or raises: no fallback from the
  card. It takes float32 operands whose last axis is contiguous, whose
  other strides are multiples of 4 elements and whose base is 16-byte
  aligned (the TMA's terms); :func:`kernel_ready` says whether a tensor
  meets them. ``gemm.launches`` counts kernel launches; ``gemm.passed``
  counts the products the op's rule left on ``torch.matmul`` on the card.
* :func:`gemm_ref` is the plain version: the products as autograd takes
  them for ``x @ w``, so the CPU path is today's bit for bit.

The kernel computes in 3xTF32 (each operand split as hi + lo, three
TF32 products a product): f32 accuracy, never a plain TF32 product, and
``torch.backends.cuda.matmul.allow_tf32`` is not read. Each k-stage of
32 is summed from 0 on the tensor cores, whose adds truncate, and joins
the tile's sum in f32 adds that round to nearest; the error against an
f64 product is cuBLAS f32's or below. Its bound on an H100 is
operations: 3 x 2 B M N K flops over 495 TFLOP/s dense TF32, a ceiling
of 165 TFLOP/s of f32 work against the 67 TFLOP/s f32 SIMT rate. The
design, written at the top of the CUDA source: a persistent
warp-specialised grid, TMA loads of raw f32 tiles, B split and made
K-major in shared memory by two warpgroups, A split in registers by
the two that issue ``wgmma``. Each element's sum runs over K in one
order, so the bits do not depend on the batch, on M or on the launch.
"""
from __future__ import annotations

import ctypes

import torch

BM = 128  # kBM in csrc/gemm.cu: rows of an output tile

FORMS = ("y", "dx", "dw")


def gemm_ref(a, b, form: str = "y"):
    """Plain version of :func:`gemm`."""
    if form == "y":
        return a @ b
    if form == "dx":
        return a @ b.transpose(-1, -2)
    if form == "dw":
        return a.transpose(-1, -2) @ b
    raise ValueError(f"form is one of {FORMS}, got {form!r}")


def kernel_ready(t) -> bool:
    """Whether ``t`` is laid out as the kernel reads it: float32, the
    last axis contiguous, the other strides positive multiples of 16
    bytes and the base 16-byte aligned."""
    return (t.dtype == torch.float32 and t.dim() in (2, 3)
            and (t.shape[-1] == 1 or t.stride(-1) == 1)
            and all(s > 0 and s % 4 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _batched(t):
    return t if t.dim() == 3 else t.unsqueeze(0)


def _extents(a, b, form):
    """(batch, M, N, K) of the product C (M x N) = A (M x K) B (K x N)."""
    if a.dim() != b.dim() or a.dim() not in (2, 3) or \
            (a.dim() == 3 and a.shape[0] != b.shape[0]):
        raise ValueError(f"gemm takes two 2-d or two 3-d operands with one "
                         f"batch, got {tuple(a.shape)} and {tuple(b.shape)}")
    batch = a.shape[0] if a.dim() == 3 else 1
    (ra, ca), (rb, cb) = a.shape[-2:], b.shape[-2:]
    if form == "y":
        M, K, N, ok = ra, ca, cb, ca == rb
    elif form == "dx":
        M, K, N, ok = ra, ca, rb, ca == cb
    else:
        M, K, N, ok = ca, ra, cb, ra == rb
    if not ok:
        raise ValueError(f"gemm form {form!r}: {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not match")
    return batch, M, N, K


def _library():
    from repro_torch.kernels import _build

    lib = _build.load("gemm")
    if lib.g1_gemm_f32.argtypes is None:
        lib.g1_gemm_f32.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
        lib.g1_gemm_f32.restype = ctypes.c_int
        lib.g1_gemm_smem_bytes.restype = ctypes.c_longlong
    return lib


def gemm(a, b, form: str = "y"):
    """One of the three products (module docstring), in float32.

    On a CPU tensor this is the plain version; on a CUDA tensor it
    launches the Hopper kernel on the current stream (no
    synchronisation) and raises if the operands are not as the kernel
    reads them or the launch fails."""
    if form not in FORMS:
        raise ValueError(f"form is one of {FORMS}, got {form!r}")
    if a.device.type == "cpu":
        return gemm_ref(a, b, form)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"gemm runs on cpu or cuda with both operands on "
                         f"one device, got {a.device} and {b.device}")
    batch, M, N, K = _extents(a, b, form)
    for name, t in (("a", a), ("b", b)):
        if not kernel_ready(t):
            raise ValueError(
                f"gemm operand {name} {tuple(t.shape)} {t.dtype} with "
                f"strides {t.stride()} is not as the kernel reads it: "
                f"float32, the last axis contiguous, the other strides "
                f"multiples of 4 elements, a 16-byte aligned base")
    shape = (batch, M, N) if a.dim() == 3 else (M, N)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    a3, b3, c3 = _batched(a), _batched(b), _batched(out)
    # the kernel's A is (M, K) K-major or (K, M) M-major, its B (N, K)
    # K-major or (K, N) N-major, as the form stores them
    a_kmajor, b_kmajor = form != "dw", form == "dx"
    lib = _library()
    from repro_torch.kernels import _build

    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.g1_gemm_f32(
            int(a_kmajor), int(b_kmajor), a3.data_ptr(), b3.data_ptr(),
            c3.data_ptr(), batch, M, N, K, a3.stride(1), b3.stride(1),
            c3.stride(1), a3.stride(0), b3.stride(0), c3.stride(0),
            _build.sm_count(a.device.index or 0), stream)
    if err != 0:
        raise RuntimeError(
            f"gemm kernel ({form}) launch failed with code {err} (a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}; a block asks for "
            f"{lib.g1_gemm_smem_bytes()} bytes of shared memory; -1: the "
            f"driver has no cuTensorMapEncodeTiled, -1000 - r: it refused "
            f"a tensor map with CUresult r)")
    gemm.launches += 1
    return out


gemm.launches = 0
gemm.passed = 0
