"""Mamba-2 SSD intra-chunk step: the Hopper kernel's wrapper and its plain
PyTorch version.

Port of ``repro.kernels.ssd_scan.ssd_intra_chunk`` (TPU Pallas, body
``_ssd_chunk_kernel``). Per (batch, head, chunk), with cs = cumsum(dA):

    L       = exp(cs_i - cs_j) for j <= i, 0 above the diagonal
    y_diag  = (C B^T * L) @ xdt                 (Q, P)
    state   = (B * exp(cs_last - cs))^T @ xdt   transposed to (P, N)

all in float32. The inter-chunk recurrence and the off-diagonal term stay
outside (``kernels.ops.ssd``), as in the reference.

Layouts: ``xdt`` (b, h, c, Q, P) is x * dt; ``dA`` (b, h, c, Q) the
log-decay dt * A; ``B`` and ``C`` (b, g, c, Q, N) **per group**: head h
reads group h // (h / g). The reference kernel takes B and C expanded to
every head; the group layout reads h / g times fewer bytes and is the
same function. Returns ``y`` (b, h, c, Q, P) and ``states`` (b, h, c, P,
N), both float32.

* :func:`ssd_intra_chunk` is the wrapper. A CPU tensor takes the plain
  version; a CUDA tensor launches the hand-written kernel in
  ``csrc/ssd_scan.cu`` (built at first use, see ``_build``) or raises.
  There is no fallback from the card. ``ssd_intra_chunk.launches``
  counts kernel launches. The kernel has no backward: on the card a call
  that autograd would have to differentiate raises.
* :func:`ssd_intra_chunk_ref` is the plain version, in the Pallas body's
  op order.

The kernel runs all three products on the tensor cores as TF32
``mma.sync`` in the 3xTF32 split (each operand as hi + lo, three
products per product), which keeps the plain version's f32 accuracy;
it spreads each chunk over several blocks of 4 warps (query-row strips
for y, state rows for the state). It takes a chunk of up to
``MAX_CHUNK`` positions, a head_dim up to ``MAX_HEAD_DIM`` and a state
up to ``MAX_STATE``; a larger shape raises ``NotImplementedError``
before launch. What bounds it on an H100 (operations: 3 x the flops
over the TF32 rate), and the design, are written at the top of the CUDA
source.
"""
from __future__ import annotations

import ctypes

import torch

MAX_CHUNK = 256     # kMaxQ in csrc/ssd_scan.cu
MAX_HEAD_DIM = 128  # kMaxP
MAX_STATE = 128     # kMaxN


def _expand_groups(t, h):
    """(b, g, c, Q, N) per group -> (b, h, c, Q, N) per head."""
    return t.repeat_interleave(h // t.shape[1], dim=1)


def ssd_intra_chunk_ref(xdt, dA, B, C):
    """Plain version. Shapes as in the module docstring."""
    h, Q = xdt.shape[1], xdt.shape[3]
    xdt = xdt.float()
    Bh = _expand_groups(B.float(), h)
    Ch = _expand_groups(C.float(), h)
    cs = torch.cumsum(dA.float(), dim=-1)                  # (b, h, c, Q)
    seg = cs[..., :, None] - cs[..., None, :]              # (.., Q, Q)
    lower = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                  device=xdt.device))
    # exp only where it is kept: above the diagonal seg > 0 can overflow
    L = torch.where(lower, torch.exp(torch.where(lower, seg, 0.0)), 0.0)
    cb = Ch @ Bh.transpose(-1, -2)                         # (.., Q, Q)
    y = (cb * L) @ xdt                                     # (.., Q, P)
    decay = torch.exp(cs[..., -1:] - cs)                   # (.., Q)
    bw = Bh * decay[..., None]                             # (.., Q, N)
    states = xdt.transpose(-1, -2) @ bw                    # (.., P, N)
    return y, states


def _check(xdt, dA, B, C):
    for name, t in (("xdt", xdt), ("dA", dA), ("B", B), ("C", C)):
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, xdt on {xdt.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, c, Q, P = xdt.shape
    g, N = B.shape[1], B.shape[4]
    if tuple(dA.shape) != (b, h, c, Q):
        raise ValueError(f"dA {tuple(dA.shape)} does not match xdt "
                         f"{tuple(xdt.shape)}")
    if B.shape != C.shape or tuple(B.shape[:4]) != (b, g, c, Q) \
            or g < 1 or h % g:
        raise ValueError(f"B {tuple(B.shape)} / C {tuple(C.shape)} are not "
                         f"(b, g, c, Q, N) groups of xdt {tuple(xdt.shape)}")
    if not (1 <= Q <= MAX_CHUNK and 1 <= P <= MAX_HEAD_DIM
            and 1 <= N <= MAX_STATE):
        raise NotImplementedError(
            f"ssd kernel takes a chunk of 1..{MAX_CHUNK}, a head_dim of "
            f"1..{MAX_HEAD_DIM} and a state size of 1..{MAX_STATE}, got "
            f"Q={Q}, P={P}, N={N}")


def _library():
    from repro_torch.kernels import _build

    lib = _build.load("ssd_scan")
    if lib.ssd_intra_chunk_f32.argtypes is None:
        lib.ssd_intra_chunk_f32.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.ssd_intra_chunk_f32.restype = ctypes.c_int
        lib.ssd_intra_chunk_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_intra_chunk_smem_bytes.restype = ctypes.c_longlong
    return lib


def ssd_intra_chunk(xdt, dA, B, C):
    """Mamba-2 SSD intra-chunk outputs and chunk-final states.

    Shapes as in the module docstring. On a CPU tensor this is the plain
    version; on a CUDA tensor it launches the Hopper kernel on the
    current stream (no synchronisation) and raises if the launch fails."""
    if xdt.device.type == "cpu":
        return ssd_intra_chunk_ref(xdt, dA, B, C)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on cpu or cuda, got "
                         f"{xdt.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xdt, dA, B, C)):
        raise NotImplementedError(
            "the SSD kernel is forward only: it has no backward, and the LM "
            "train step pins impl='jnp' (ssd_chunked) as the reference's "
            "does; run it under torch.no_grad")
    _check(xdt, dA, B, C)
    b, h, c, Q, P = xdt.shape
    g, N = B.shape[1], B.shape[4]
    y = torch.empty_like(xdt)
    states = torch.empty((b, h, c, P, N), dtype=torch.float32,
                         device=xdt.device)
    if y.numel() == 0:
        return y, states
    lib = _library()
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = lib.ssd_intra_chunk_f32(
            xdt.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), states.data_ptr(), b, h, g, c, Q, P, N, stream)
    if err != 0:
        raise RuntimeError(
            f"ssd kernel launch failed with CUDA error {err} (xdt "
            f"{tuple(xdt.shape)}, B {tuple(B.shape)}; a block asks for "
            f"{lib.ssd_intra_chunk_smem_bytes(Q, P, N)} bytes of shared "
            f"memory)")
    ssd_intra_chunk.launches += 1
    return y, states


ssd_intra_chunk.launches = 0
