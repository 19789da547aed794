"""Causal / sliding-window flash attention (forward): the Hopper kernel's
wrapper and its plain PyTorch version.

Port of ``repro.kernels.flash_attention.flash_attention_bhsd`` (TPU
Pallas, body ``_attn_kernel``). q (B, Hq, S, D) attends over k/v (B, Hkv,
T, D), query head h over kv head h // (Hq / Hkv) (GQA), with an online
softmax over key tiles: scale 1/sqrt(D), masked scores -1e30 (causal:
key <= query; window W: key > query - W), tiles wholly masked skipped,
the denominator clamped at 1e-30, float32 throughout. Forward only, as
in the reference (which has no custom VJP for it). The reference also
has a non-causal mode; its only caller, the split LM's forward, is
causal, so the port is causal always.

* :func:`flash_attention_bhsd` is the wrapper. A CPU tensor takes the
  plain version; a CUDA tensor launches the hand-written kernel in
  ``csrc/flash_attention.cu`` (built at first use, see ``_build``) or
  raises. There is no fallback from the card.
  ``flash_attention_bhsd.launches`` counts kernel launches. On the card
  a call that autograd would have to differentiate raises.
* :func:`flash_attention_ref` is the plain version: the Pallas body's
  update sequence, tile by tile (64 queries by 64 keys; the tile sizes
  change only the order of the sums, not the function).

Unlike the reference, neither needs S or T to divide the tile: the
ragged last tile is masked.

What bounds the kernel on an H100 is operations: at granite-8b's S 2048
attention does ~680 flops a byte of q, k, v and out. The kernel runs
both products on the tensor cores as TF32 ``mma.sync`` in the 3xTF32
split (each operand as hi + lo, three products per product), which keeps
the plain version's f32 accuracy, so its least time is 3 x the flops
over the TF32 rate (495 TFLOP/s); the CUDA source's note gives the
design.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
BLOCK_Q = 64    # the plain version's tiles (the kernel's are 128 x 32)
BLOCK_K = 64
MAX_HEAD_DIM = 128


def flash_attention_ref(q, k, v, window=None):
    """Plain version. q: (B, Hq, S, D); k, v: (B, Hkv, T, D). Returns q's
    shape and dtype."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf = q.float() * scale
    kf = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    out = torch.empty((B, Hq, S, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, BLOCK_Q):
        qt = qf[:, :, q0:q0 + BLOCK_Q]
        q_pos = torch.arange(q0, q0 + qt.shape[2], device=q.device)[:, None]
        m = torch.full(qt.shape[:3] + (1,), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for k0 in range(0, T, BLOCK_K):
            if k0 > q0 + BLOCK_Q - 1:
                break
            if window is not None and k0 + BLOCK_K - 1 < q0 - window + 1:
                continue
            kt = kf[:, :, k0:k0 + BLOCK_K]
            k_pos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None]
            s = qt @ kt.transpose(-1, -2)
            mask = k_pos <= q_pos
            if window is not None:
                mask &= k_pos > q_pos - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, k0:k0 + BLOCK_K]
            m = m_new
        out[:, :, q0:q0 + BLOCK_Q] = acc / l.clamp_min(1e-30)
    return out.to(q.dtype)


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, L, D), got "
                             f"{tuple(t.shape)}")
    B, Hq, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or k.shape[1] < 1 or Hq % k.shape[1]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if D > MAX_HEAD_DIM:
        raise NotImplementedError(f"flash attention kernel takes head_dim "
                                  f"<= {MAX_HEAD_DIM}, got {D}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _kernel():
    from repro_torch.kernels import _build

    fn = _build.load("flash_attention").flash_attention_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_bhsd(q, k, v, window=None):
    """Causal / windowed GQA attention, forward. Shapes as in
    :func:`flash_attention_ref`. On a CPU tensor this is the plain
    version; on a CUDA tensor it launches the Hopper kernel on the
    current stream (no synchronisation) and raises if the launch fails."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd runs on cpu or cuda, got "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash attention kernel is forward only: it has no "
            "backward, and the LM train step pins impl='jnp' as the "
            "reference's does; run it under torch.no_grad, or take "
            "impl='jnp'")
    _check(q, k, v, window)
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hq, Hkv, S, T, D, 0 if window is None else int(window),
                 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed with CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0
