"""Paged KV cache: fixed-size pages, per-slot page tables (DESIGN.md §18).

Port of ``repro.models.paging``; an SSM layer keeps its O(1) recurrent
state (``models.ssm.SSMCache``) beside the attention layers' pages. A
continuous-batching server
keeps every slot at its own position, so the cache is a pool of
fixed-size pages:

* ``pages_k``/``pages_v`` -- ``(Hkv, num_pages, page_size, head_dim)``
  physical pools, head-major so one (head, page) tile is contiguous for
  the kernel.
* ``page_table`` -- ``(slots, max_pages)`` int32: logical page ``j`` of a
  slot lives in physical page ``page_table[slot, j]``. Allocation is
  host-driven (:class:`PageAllocator`).
* ``lengths`` -- ``(slots,)`` int32 per-slot token counts.
* ``live`` -- ``(slots,)`` bool; dead slots neither write nor advance.
* ``live_idx`` -- int64 indices of the live slots, computed on the host
  whenever admission state is pushed (:func:`admission_tensors`). The
  reference routes a dead slot's write to an out-of-range page and lets
  the scatter drop it (``mode="drop"``); torch indexing has no such mode,
  so the port writes through the live slots' indices only.

Unlike the reference, whose arrays are immutable, :func:`paged_write`
and :func:`write_prompt` update the pools IN PLACE: a functional update
would copy the whole pool of every layer on every step. The small
admission tensors are never mutated; updates return a new cache object
that shares the pools.

Paged attention is full-causal only. The attention over this layout is
``kernels.ops.paged_attention``; ``dense_view`` rebuilds dense K/V for
parity tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import linear


@dataclass(frozen=True)
class PagedKVCache:
    pages_k: torch.Tensor     # (Hkv, P, page_size, D) physical pool
    pages_v: torch.Tensor     # (Hkv, P, page_size, D)
    page_table: torch.Tensor  # (slots, max_pages) int32 physical page ids
    lengths: torch.Tensor     # (slots,) int32 tokens written per slot
    live: torch.Tensor        # (slots,) bool -- dead slots are frozen
    live_idx: torch.Tensor    # (n_live,) int64 indices of live slots

    @property
    def page_size(self) -> int:
        return self.pages_k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.pages_k.shape[1]

    @property
    def slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` tokens (allocate-on-write unit)."""
    return max(0, -(-int(tokens) // int(page_size)))


def admission_tensors(page_table, lengths, live, device):
    """Host admission state (numpy) -> the device tensors of a cache."""
    live = np.asarray(live, bool)
    return dict(
        page_table=torch.as_tensor(np.asarray(page_table, np.int32),
                                   device=device),
        lengths=torch.as_tensor(np.asarray(lengths, np.int32), device=device),
        live=torch.as_tensor(live, device=device),
        live_idx=torch.as_tensor(np.flatnonzero(live).astype(np.int64),
                                 device=device))


def init_paged_cache(cfg: ModelConfig, slots: int, max_len: int,
                     page_size: int = 16, num_pages: Optional[int] = None,
                     dtype=torch.float32, device="cpu") -> PagedKVCache:
    """Empty paged cache for one attention layer.

    ``num_pages`` defaults to full occupancy (``slots × ceil(max_len /
    page_size)``); a server oversubscribing memory passes fewer and lets
    admission control block when the pool runs dry.
    """
    if cfg.sliding_window is not None:
        raise ValueError("paged KV cache is full-causal only; sliding-window "
                         "models keep the ring-buffered dense decode path")
    if page_size < 8:
        # the reference's floor (its TPU f32 sublane tile), kept so both
        # packages accept the same configurations
        raise ValueError(f"page_size {page_size} < 8")
    hd = cfg.resolved_head_dim
    max_pages = pages_for(max_len, page_size)
    if num_pages is None:
        num_pages = slots * max_pages
    shape = (cfg.num_kv_heads, num_pages, page_size, hd)
    return PagedKVCache(
        pages_k=torch.zeros(shape, dtype=dtype, device=device),
        pages_v=torch.zeros(shape, dtype=dtype, device=device),
        **admission_tensors(np.zeros((slots, max_pages), np.int32),
                            np.zeros((slots,), np.int32),
                            np.zeros((slots,), bool), device))


def paged_write(cache: PagedKVCache, k: torch.Tensor,
                v: torch.Tensor) -> PagedKVCache:
    """Write one token per LIVE slot at its own position; dead slots are
    not written. Updates the pools in place and returns the cache with
    live slots' lengths advanced by one.

    k/v: ``(slots, 1, Hkv, D)`` (the ``_project_qkv`` layout). The target
    physical row of slot ``b`` is ``(page_table[b, len_b // page],
    len_b % page)``.
    """
    page = cache.page_size
    idx = cache.live_idx
    pos = cache.lengths.long()[idx]
    logical = torch.clamp(pos // page, max=cache.max_pages - 1)
    phys = cache.page_table.long()[idx, logical]
    off = pos % page
    cache.pages_k[:, phys, off] = k[idx, 0].transpose(0, 1).to(
        cache.pages_k.dtype)
    cache.pages_v[:, phys, off] = v[idx, 0].transpose(0, 1).to(
        cache.pages_v.dtype)
    return dataclasses.replace(
        cache, lengths=cache.lengths + cache.live.to(torch.int32))


def write_prompt(cache: PagedKVCache, slot_page_ids: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor) -> PagedKVCache:
    """Scatter a prefilled prompt's dense K/V rows into a slot's pages,
    in place.

    ``slot_page_ids``: ``(max_pages,)`` int -- the slot's (freshly
    allocated) physical pages; ``k``/``v``: ``(1, S, Hkv, D)`` from
    ``attend_prefill`` with capacity exactly S. Lengths/table/live are
    host-owned admission state, pushed by the engine, not here.
    """
    S = k.shape[1]
    page = cache.page_size
    s = torch.arange(S, device=k.device)
    pi = slot_page_ids.long()[s // page]
    oi = s % page
    cache.pages_k[:, pi, oi] = k[0].transpose(0, 1).to(cache.pages_k.dtype)
    cache.pages_v[:, pi, oi] = v[0].transpose(0, 1).to(cache.pages_v.dtype)
    return cache


def dense_view(cache: PagedKVCache) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Rebuild ``(k, v, valid)`` dense tensors -- ``k``/``v``:
    ``(slots, max_pages*page, Hkv, D)``, ``valid``: bool ``(slots, T)``."""
    table = cache.page_table.long()
    kg = cache.pages_k[:, table]  # (Hkv, slots, maxp, page, D)
    vg = cache.pages_v[:, table]
    hkv, slots, maxp, page, d = kg.shape
    k = kg.reshape(hkv, slots, maxp * page, d).permute(1, 2, 0, 3)
    v = vg.reshape(hkv, slots, maxp * page, d).permute(1, 2, 0, 3)
    valid = torch.arange(maxp * page, device=table.device)[None, :] \
        < cache.lengths[:, None]
    return k, v, valid


def attend_decode_paged(params, cfg: ModelConfig, x, cache: PagedKVCache):
    """One-token GQA decode against the paged cache. x: ``(slots, 1, d)``.

    Each slot's new token sits at its OWN position ``lengths[b]`` (RoPE
    per slot). The write happens before the attend, so the query sees
    itself. The attention is the paged-decode kernel on the card and its
    plain version on the CPU (``kernels.ops.paged_attention``).
    """
    if cfg.logit_softcap:
        raise NotImplementedError("paged decode does not support "
                                  "logit_softcap models")
    if not cfg.attention_is_reference:
        raise ValueError(f"{cfg.name}: paged decode (B6) computes RoPE "
                         f"attention at 1/sqrt(head_dim); this model sets "
                         f"{cfg.port_fields_set()}")
    B = x.shape[0]
    positions = cache.lengths[:, None]  # (B, 1) per slot
    if cfg.mrope_sections:
        positions = positions[None].expand(3, B, 1)
    q, k, v = attn_mod._project_qkv(params, cfg, x, positions)
    cache = paged_write(cache, k, v)
    out = kops.paged_attention(q[:, 0], cache.pages_k, cache.pages_v,
                               cache.page_table, cache.lengths)
    return linear(params["wo"], out.reshape(B, 1, -1)), cache


# ---------------------------------------------------------------------------
# Host-side page allocation (admission control is host-driven: the decode
# step never allocates)
# ---------------------------------------------------------------------------

class PageAllocator:
    """Free-list over the physical pool. ``alloc`` claims pages for a
    slot (admission / page-boundary crossing), ``free`` returns them at
    retirement. Raises when the pool is exhausted -- the engine treats
    that as \"admission blocked\", never as silent eviction."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"page pool exhausted: want {n}, "
                              f"free {len(self._free)}/{self.num_pages}")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"freeing invalid page id {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)


# ---------------------------------------------------------------------------
# Group-cache plumbing: caches[group][layer][sublayer], mirroring the
# per-layer parameter lists of ``transformer``; paged caches on attention
# layers, the recurrent state of every slot on SSM layers
# ---------------------------------------------------------------------------

def init_paged_group_caches(cfg: ModelConfig, groups, slots: int,
                            max_len: int, page_size: int = 16,
                            num_pages: Optional[int] = None,
                            dtype=torch.float32, device="cpu"):
    """Cache skeleton for ``apply_groups_decode`` with paged attention.

    Every attention layer gets its own physical pool, but all layers
    share ONE logical page table (the engine pushes table updates to all
    of them with :func:`replace_tables`) -- a slot's pages mean the same
    physical ids in every layer's pool. An SSM layer gets an
    ``SSMCache`` with one row per slot."""
    caches = []
    for g in groups:
        layers = []
        for _ in range(g.repeat):
            per = []
            for s in g.period:
                if s[0] == "attn":
                    per.append(init_paged_cache(cfg, slots, max_len,
                                                page_size, num_pages, dtype,
                                                device))
                else:
                    per.append(ssm_mod.init_ssm_cache(cfg, slots, dtype,
                                                      device))
            layers.append(tuple(per))
        caches.append(layers)
    return caches


def map_paged(caches, fn):
    """Apply ``fn`` to every PagedKVCache in a group-cache list."""
    return [[tuple(fn(c) if isinstance(c, PagedKVCache) else c for c in lc)
             for lc in gc] for gc in caches]


def _paged(caches):
    return [c for gc in caches for lc in gc for c in lc
            if isinstance(c, PagedKVCache)]


def replace_tables(caches, page_table: np.ndarray, lengths: np.ndarray,
                   live: np.ndarray):
    """Push host-owned admission state (table / lengths / live) into every
    layer's paged cache: one host-to-device copy, shared by all layers.
    A stack without attention layers has nothing to update."""
    paged = _paged(caches)
    if not paged:
        return caches
    adm = admission_tensors(page_table, lengths, live, paged[0].pages_k.device)
    return map_paged(caches, lambda c: dataclasses.replace(c, **adm))


def paged_cache_stats(caches) -> dict:
    """Live-token / page occupancy summary for obs (`serve` events).
    Every layer holds the same lengths, so one is read back."""
    paged = _paged(caches)
    if not paged:
        return {"live_tokens": 0, "pages_in_use": 0, "pages_total": 0}
    L = len(paged)
    page = paged[0].page_size
    lens = paged[0].lengths.cpu().numpy()
    return {"live_tokens": int(lens.sum()) * L,
            "pages_in_use": sum(pages_for(int(t), page) for t in lens) * L,
            "pages_total": sum(c.num_pages for c in paged)}
