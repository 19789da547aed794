"""Paged batched-decode attention: the Hopper kernel's wrapper and its
plain PyTorch version.

Port of ``repro.kernels.paged_attention.paged_attention_decode`` (TPU
Pallas, body ``_paged_kernel``) and its oracle
``repro.kernels.ref.paged_attention_ref``. One query token per decode
slot attends over that slot's page list of a paged KV pool with an online
softmax across pages; page j is skipped when j * page >= length, the
denominator is clamped at 1e-30, and a slot of length 0 yields exact
zeros. Scale 1/sqrt(D), float32 throughout.

* :func:`paged_attention_decode` is the wrapper. A CPU tensor takes the
  plain version; a CUDA tensor launches the hand-written kernel in
  ``csrc/paged_attention.cu`` (built at first use, see ``_build``) or
  raises. There is no fallback from the card to the plain version.
  ``paged_attention_decode.launches`` counts kernel launches.
* :func:`paged_attention_ref` is the plain version, in the reference's
  page-by-page op order. The CPU tests hold it against the JAX oracle and
  the Pallas kernel; ``chip_smoke.py`` holds the kernel against it.
* :func:`split_plan` picks, from shapes only, how many blocks of a thread
  block cluster share one (slot, kv head); the kernel gives each of them
  a contiguous part of the slot's live pages.

What bounds the kernel on an H100, and how it is built, is written at
the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_CLUSTER = 8  # the portable thread block cluster size
PART_WORK = 512  # least positions x query rows a part of a split holds


def paged_attention_ref(q, pages_k, pages_v, page_table, lengths):
    """Plain version. q: (slots, Hkv, G, D); pools: (Hkv, P, page, D);
    page_table: (slots, max_pages) int32; lengths: (slots,) int32
    counting the just-written token. Returns q's shape and dtype.

    The same f32 update sequence as the reference oracle, page by page;
    a page at or past a slot's length leaves the running state untouched
    (the kernel's page skip), so a dead slot yields zeros."""
    B, Hkv, G, D = q.shape
    maxp = page_table.shape[1]
    page = pages_k.shape[2]
    scale = 1.0 / math.sqrt(D)
    idx = page_table.long()
    kg = pages_k[:, idx].transpose(0, 1)  # (B, Hkv, maxp, page, D)
    vg = pages_v[:, idx].transpose(0, 1)
    qf = q.float() * scale
    length = lengths.long().view(B, 1, 1, 1)
    iota = torch.arange(page, device=q.device)
    m = torch.full((B, Hkv, G, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    for j in range(maxp):
        s = qf @ kg[:, :, j].float().transpose(-1, -2)   # (B, Hkv, G, page)
        s = torch.where(j * page + iota < length, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(-1, keepdim=True)
        acc_new = acc * alpha + p @ vg[:, :, j].float()
        hit = j * page < length
        m = torch.where(hit, m_new, m)
        l = torch.where(hit, l_new, l)
        acc = torch.where(hit, acc_new, acc)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def split_plan(slots, hkv, G, maxp, page, sms):
    """Cluster size: how many blocks share the pages of one (slot, kv
    head), 1 to ``MAX_CLUSTER``. The launch has ``cluster * slots * hkv``
    blocks, a multiple of the cluster size.

    From shapes only, so that planning never reads ``lengths`` back from
    the card. A split pays when the (slot, kv head) pairs alone cannot
    fill the ``sms`` multiprocessors, and only as far as each part of a
    table row of ``maxp`` pages still holds ``PART_WORK`` positions x
    query rows (the kernel takes rows in tiles of 4): fewer, and the
    cluster's launch and combine cost more than the part saves."""
    pairs = slots * hkv
    if pairs >= sms:
        return 1
    least_pages = max(1, -(-PART_WORK // (max(G, 4) * page)))
    return max(1, min(MAX_CLUSTER, -(-sms // pairs), maxp // least_pages))


def _check(q, pages_k, pages_v, page_table, lengths):
    B, Hkv, G, D = q.shape
    for name, t, dtype in (("q", q, torch.float32),
                           ("pages_k", pages_k, torch.float32),
                           ("pages_v", pages_v, torch.float32),
                           ("page_table", page_table, torch.int32),
                           ("lengths", lengths, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"paged attention kernel takes head_dim "
                                  f"in {HEAD_DIMS}, got {D}")
    if pages_k.shape != pages_v.shape or pages_k.shape[0] != Hkv \
            or pages_k.shape[3] != D:
        raise ValueError(f"pools {tuple(pages_k.shape)}/"
                         f"{tuple(pages_v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {B} slots")
    if q.data_ptr() % 16 or pages_k.data_ptr() % 16 \
            or pages_v.data_ptr() % 16:
        raise ValueError("q and the pools must be 16-byte aligned (the "
                         "kernel stages them in 16-byte copies)")


def _kernel():
    fn = _build.load("paged_attention").paged_attention_decode_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention_decode(q, pages_k, pages_v, page_table, lengths):
    """Batched single-token GQA decode over a paged KV pool.

    Shapes as in :func:`paged_attention_ref`. On a CPU tensor this is the
    plain version; on a CUDA tensor it launches the Hopper kernel on the
    current stream (no synchronisation), in clusters of
    :func:`split_plan`'s size, and raises if the launch fails."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, pages_k, pages_v, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode runs on cpu or cuda, "
                         f"got {q.device}")
    _check(q, pages_k, pages_v, page_table, lengths)
    B, Hkv, G = q.shape[:3]
    cluster = split_plan(B, Hkv, G, page_table.shape[1], pages_k.shape[2],
                         _build.sm_count(q.device.index))
    return _launch(q, pages_k, pages_v, page_table, lengths, cluster)


def _launch(q, pages_k, pages_v, page_table, lengths, cluster):
    """One launch of the kernel on checked inputs, with the given cluster
    size (1 to ``MAX_CLUSTER``); counts it."""
    B, Hkv, G, D = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
                 page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 B, Hkv, G, D, pages_k.shape[1], pages_k.shape[2],
                 page_table.shape[1], cluster, 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed with CUDA "
                           f"error {err} (q {tuple(q.shape)}, pools "
                           f"{tuple(pages_k.shape)}, cluster {cluster})")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0
