"""Client bank: where the O(N) per-client state lives (port of
``repro.core.bank``).

The server model is O(1) (the simulator keeps one aggregated copy), but
the client-side stacks -- one model per registered client -- are O(N):
about 853 MB for the paper CNN's client side at cut 2 and N = 4,096.
Each round only touches a K-client cohort, and the cohort sampler is
pure in ``(seed, t)``, so next round's K-slice is known in advance.
:class:`ClientBank` uses that behind three backends:

``device``
    The stacked tree lives on the device; gathers and scatters index it
    there. The default, and the bit-parity baseline.
``host``
    The bank lives in host memory (pinned when the device is CUDA). A
    round gathers only the K-slice onto the device and scatters it back,
    so device memory for client state is O(K) whatever N is. One
    background worker double-buffers the pipeline: while round t trains,
    round t+1's slice is staged host->device (``prefetch``) and round
    t's updates drain device->host (``scatter``). The worker runs its
    tasks in submission order, which is the correctness argument: a
    prefetch enqueued after a scatter observes that scatter's writes,
    and the caller enqueues a prefetch BEFORE a pending scatter only
    when the two cohorts are disjoint (see ``FedSimulator``).

    On CUDA the copies order through events, never through the legacy
    default stream: a prefetch gathers the rows into a pinned staging
    buffer and copies them host->device on a side stream, then records
    an event; ``gather`` makes the current stream wait on that event
    and guards the staged tensors with ``record_stream``. A scatter
    records an event on the current stream when it is enqueued; the
    worker makes its own stream wait on it before the device->host copy
    and synchronises that stream before it writes the rows. On the CPU
    the same code runs with plain tensors and no streams.

``sharded``
    The bank is one DTensor per leaf over ``launch.mesh.make_bank_mesh``
    (every rank of the default process group on the client axis;
    ``launch.shardings.bank_sharding``: ``Shard(0)`` over it). Rank r
    holds rows [r N / ranks, (r + 1) N / ranks), so per-device client
    state is O(N / ranks). The execution model is SPMD: every rank runs
    the same simulator with the same seeds, and a gathered K-slice lands
    replicated on every rank. ``gather`` is one collective (the K rows,
    packed as bytes, ``all_gather``-ed from every rank; each row is then
    taken from its owner's slot, so it is a copy, bit for bit);
    ``scatter``, the broadcast scatter, ``replace`` and
    ``broadcast_single`` are local (each rank writes the rows it owns
    from its replicated copy). ``tree`` returns the DTensors: a consumer
    reads ``full_tensor()`` (the checkpoint writer, a test comparing two
    banks) or ``to_local()`` (its own rows), never the DTensor as a
    plain tensor. The whole-bank reductions (``rho_mean``,
    ``merge_anchored``, ``drift``, ``drift_streamed``, ``full_device``)
    gather the rows in order (one collective) and run the ``device``
    expression on the whole bank, so they are bit for bit the device
    backend's at any number of ranks; the cost is transient O(N) memory
    on every rank for the length of the reduction: the packed gather
    buffer and the unpacked copy of the bank, about twice its bytes.

Duplicate cohort indices (the rho sampler draws with replacement)
resolve to the last occurrence on every backend: the scatter keeps each
index's last row, chosen on the host, because CUDA's indexed writes
leave the winner among duplicates undefined.

The bank holds any tree (nested dicts and lists) whose leaves carry a
leading (N,) axis when ``stacked``, or a single copy when not (the
collapsed sfl/fl banks, which are O(1) and always live on the device).
Whole-bank reductions (the evaluation-time rho-mean, the ``set_cut``
anchored merge, the Gamma drift metric) with one chunk (N <=
``chunk_rows``, and always on ``device`` and ``sharded``) are the
simulator's device expressions bit for bit; with several chunks they
accumulate in float64 on the host and round once, within 1 ulp of the
one-chunk result.

Instrumentation (``repro_torch.obs``): gauges ``bank_gather_wait_s``
(how long the round blocked on the staged slice), ``bank_prefetch_s``
and ``bank_scatter_s`` (worker-side copy times), counters
``bank_prefetch_hit`` / ``bank_prefetch_miss``, and ``stats()``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import is_dtensor, obs, require_device
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

BANK_BACKENDS = ("device", "host", "sharded")

# whole-bank reductions stream this many rows at a time; one chunk (N <=
# chunk_rows) reproduces the unchunked device expression exactly
DEFAULT_CHUNK_ROWS = 65536


def tree_nbytes(tree) -> int:
    """Total payload bytes of a tree of tensors or numpy arrays."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += int(np.asarray(leaf).nbytes)
    return total


def _rows_nbytes(leaf, k: int) -> int:
    return k * (leaf.numel() // max(leaf.shape[0], 1)) * leaf.element_size()


def _last_occurrence(idx: np.ndarray):
    """(unique indices, position of each one's LAST occurrence in
    ``idx``), or ``(idx, None)`` when ``idx`` has no duplicate."""
    uniq, first_rev = np.unique(idx[::-1], return_index=True)
    if uniq.size == idx.size:
        return idx, None
    return uniq, idx.size - 1 - first_rev


def _row_bytes(leaf) -> int:
    return (leaf.numel() // max(leaf.shape[0], 1)) * leaf.element_size()


def _pack(parts) -> torch.Tensor:
    """Tensors with a common leading dim M as one (M, bytes) uint8
    tensor, each row the concatenation of the parts' rows."""
    m = parts[0].shape[0]
    return torch.cat([p.contiguous().view(torch.uint8).reshape(m, -1)
                      for p in parts], dim=1)


def _unpack(rows: torch.Tensor, like) -> list:
    """Inverse of ``_pack``: (M, bytes) uint8 rows -> one contiguous
    (M, ...) tensor per leaf of ``like`` (their dtypes and row shapes)."""
    out, c = [], 0
    for leaf in like:
        w = _row_bytes(leaf)
        out.append(rows[:, c:c + w].contiguous().view(leaf.dtype).reshape(
            (rows.shape[0],) + tuple(leaf.shape[1:])))
        c += w
    return out


def make_bank(tree, *, n_clients: int, stacked: bool, backend: str = "device",
              device="cuda", chunk_rows: int = DEFAULT_CHUNK_ROWS,
              prefetch: bool = True) -> "ClientBank":
    return ClientBank(tree, n_clients=n_clients, stacked=stacked,
                      backend=backend, device=device, chunk_rows=chunk_rows,
                      prefetch=prefetch)


class ClientBank:
    """Owns a per-client state tree behind a residency backend."""

    def __init__(self, tree, *, n_clients: int, stacked: bool,
                 backend: str = "device", device="cuda",
                 chunk_rows: int = DEFAULT_CHUNK_ROWS, prefetch: bool = True):
        if backend not in BANK_BACKENDS:
            raise ValueError(
                f"unknown bank backend {backend!r}; known: {BANK_BACKENDS}")
        self.device = require_device(device)
        self._cuda = self.device.type == "cuda"
        self.n_clients = int(n_clients)
        self.stacked = bool(stacked)
        # collapsed (single-copy) banks are O(1): residency is moot, the
        # device layout is always right
        self.backend = backend if self.stacked else "device"
        self.chunk_rows = int(chunk_rows)
        self.prefetch_enabled = bool(prefetch) and self.backend == "host"
        self._rec = obs.get_recorder()
        if self.backend == "sharded":
            self._init_shards()
        # host-backend pipeline state
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: list = []
        self._staged: Optional[tuple] = None  # (t, idx, Future, bytes)
        self._lock = threading.Lock()
        # the worker's CUDA stream: prefetch copies and scatter drains
        self._side = torch.cuda.Stream(device=self.device) \
            if self._cuda and self.backend == "host" else None
        # accounting
        self._gathered_bytes = 0
        self._staged_bytes = 0
        self._peak_device_bytes = 0
        self._slice_bytes = 0
        self._hits = 0
        self._misses = 0
        self._gather_wait_s = 0.0
        self._tree = self._ingest(tree)
        self._note_device_bytes()

    def _init_shards(self) -> None:
        """The sharded backend's layout over ``make_bank_mesh``: rank r
        holds rows [r N / ranks, (r + 1) N / ranks)."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import (make_bank_mesh, mesh_shape,
                                             n_client_shards)

        self._mesh = make_bank_mesh(self.device)
        self._shards = n_client_shards(self._mesh)
        if self.n_clients % self._shards:
            raise ValueError(
                f"sharded bank: N={self.n_clients} not divisible by "
                f"{self._shards} client shards (mesh "
                f"{mesh_shape(self._mesh)})")
        self._rows = self.n_clients // self._shards
        self._lo = dist.get_rank() * self._rows

    # -- storage ---------------------------------------------------------
    @property
    def tree(self):
        """The bank as stored: tensors on the device (``device``), on the
        host (``host``), or DTensors holding this rank's rows
        (``sharded``: ``full_tensor()`` gives the whole leaf on every
        rank, a collective; ``to_local()`` the rank's rows). Callers
        reading the host tree directly must ``flush()`` first if a round
        is in flight (``FedSimulator`` does this through ``state``)."""
        return self._tree

    def _host(self, x) -> torch.Tensor:
        """A host tensor that the bank owns and may write in place:
        pinned when the device is CUDA."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, copy=True))
        if x.device.type == "cpu" and (not self._cuda or x.is_pinned()):
            return x.contiguous()
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=self._cuda)
        return out.copy_(x)

    def _on_device(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):  # own a copy of numpy input
            x = torch.from_numpy(np.array(x, copy=True))
        return x.to(self.device)

    def _dtensor(self, local: torch.Tensor):
        """This rank's rows as a DTensor of the bank's sharding."""
        from torch.distributed.tensor import DTensor

        from repro_torch.launch.shardings import bank_sharding

        return DTensor.from_local(
            local, self._mesh, bank_sharding(self._mesh, local.ndim)
            .placements, run_check=False)

    def _shard(self, x):
        """A whole (N, ...) leaf as this bank's DTensor: the bank's own
        DTensors (``set_cut`` re-partitioning ``tree``) are kept; any
        other leaf, replicated on every rank, gives this rank's rows,
        copied onto the device."""
        if is_dtensor(x):
            return x
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        if x.shape[0] != self.n_clients:
            raise ValueError(f"sharded bank: leaf of {x.shape[0]} rows for "
                             f"{self.n_clients} clients")
        return self._dtensor(x[self._lo:self._lo + self._rows].to(
            self.device, copy=True).contiguous())

    def _ingest(self, tree):
        if self.backend == "host":
            return tree_map(self._host, tree)
        if self.backend == "sharded":
            return tree_map(self._shard, tree)
        return tree_map(self._on_device, tree)

    # -- collectives (sharded backend) ---------------------------------
    def _all_gather(self, rows: torch.Tensor) -> torch.Tensor:
        """(M, bytes) uint8 rows from every rank -> (ranks, M, bytes),
        slot r from rank r: one ``all_gather`` over the default group."""
        import torch.distributed as dist

        out = [torch.empty_like(rows) for _ in range(dist.get_world_size())]
        dist.all_gather(out, rows)
        return torch.stack(out)

    def _full(self, tree):
        """The whole rows of a tree of this bank's DTensors, in client
        order, on every rank (one collective)."""
        leaves = tree_leaves(tree)
        if not leaves:
            return tree
        slots = self._all_gather(_pack([leaf.to_local() for leaf in leaves]))
        return tree_unflatten(tree, _unpack(
            slots.reshape(self.n_clients, -1), leaves))

    def _gather_rows(self, idx: np.ndarray):
        """The K rows ``idx`` on every rank, in cohort order: each rank
        packs the rows it owns into a zero (K, bytes) buffer, one
        ``all_gather`` brings every rank's buffer, and row k is copied
        from its owner's slot (never summed: ``-0.0 + 0.0`` is ``+0.0``)."""
        leaves = tree_leaves(self._tree)
        k = idx.size
        mine = np.flatnonzero((idx >= self._lo)
                              & (idx < self._lo + self._rows))
        buf = torch.zeros((k, sum(_row_bytes(leaf) for leaf in leaves)),
                          dtype=torch.uint8, device=self.device)
        if mine.size:
            lidx = torch.as_tensor(idx[mine] - self._lo, device=self.device)
            buf[torch.as_tensor(mine, device=self.device)] = _pack(
                [leaf.to_local().index_select(0, lidx) for leaf in leaves])
        slots = self._all_gather(buf)
        owner = torch.as_tensor(idx // self._rows, device=self.device)
        rows = slots[owner, torch.arange(k, device=self.device)]
        return tree_unflatten(self._tree, _unpack(rows, leaves))

    def replace(self, tree) -> None:
        """Swap the bank's contents (set_cut re-partitions, collapsed
        per-round updates, checkpoint restore). Drains the pipeline
        first: a replace must observe every pending scatter."""
        self.flush()
        self._staged = None
        self._staged_bytes = 0
        self._tree = self._ingest(tree)
        self._note_device_bytes()

    # -- accounting ------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return tree_nbytes(self._tree)

    @property
    def device_bytes(self) -> int:
        """Device-resident client-state bytes the bank holds now: the
        whole tree (``device``), this rank's shard (``sharded``) or the
        staged + gathered K-slices (``host``: the O(K) claim)."""
        if self.backend == "device":
            return self.nbytes
        if self.backend == "sharded":
            return self.nbytes // self._shards
        return self._gathered_bytes + self._staged_bytes

    def _note_device_bytes(self) -> None:
        self._peak_device_bytes = max(self._peak_device_bytes,
                                      self.device_bytes)

    def stats(self) -> Dict[str, Any]:
        return {
            "backend": self.backend,
            "bank_bytes": self.nbytes,
            "slice_bytes": self._slice_bytes,
            "device_bytes": self.device_bytes,
            "device_bytes_peak": max(self._peak_device_bytes,
                                     self.device_bytes),
            "prefetch_hits": self._hits,
            "prefetch_misses": self._misses,
            "gather_wait_s": self._gather_wait_s,
        }

    # -- worker (host backend) -------------------------------------------
    def _submit(self, fn, *args) -> Future:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="bank")
        fut = self._pool.submit(fn, *args)
        with self._lock:
            self._pending.append(fut)
            # keep failed futures so flush() re-raises their exception
            self._pending = [f for f in self._pending
                             if not f.done() or f.exception() is not None]
        return fut

    def flush(self) -> None:
        """Block until every enqueued scatter/prefetch has completed
        (re-raising any worker exception). Whole-bank reads, ``replace``
        and ``save`` go through here."""
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        """Drain the pipeline and release the worker thread. Safe to
        call repeatedly; the bank stays readable afterwards, and a later
        scatter/prefetch lazily recreates the pool."""
        self.flush()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self) -> "ClientBank":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- round path ------------------------------------------------------
    def gather(self, idx, *, t: Optional[int] = None):
        """Device-resident cohort slice (leading axis K). ``idx=None`` is
        the identity cohort: the full bank (free on ``device``). On the
        ``sharded`` backend the slice (the whole bank for None) lands
        replicated on every rank, one collective. On the ``host``
        backend a staged prefetch for ``(t, idx)`` is consumed when
        present (gauge ``bank_gather_wait_s`` records how long the round
        still waited); otherwise the slice is copied synchronously after
        a pipeline flush."""
        if self.backend == "device":
            if idx is None:
                return self._tree
            didx = torch.as_tensor(np.asarray(idx, np.int64),
                                   device=self.device)
            return tree_map(lambda b: b.index_select(0, didx), self._tree)
        if self.backend == "sharded":
            if idx is None:
                return self._full(self._tree)
            return self._gather_rows(np.asarray(idx, np.int64))
        staged = self._staged
        if staged is not None and t is not None and staged[0] == t \
                and idx is not None \
                and np.array_equal(staged[1], np.asarray(idx)):
            self._staged = None
            t0 = time.perf_counter()
            out, event = staged[2].result()
            if event is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(event)
                for leaf in tree_leaves(out):  # made on the side stream
                    leaf.record_stream(cur)
            wait = time.perf_counter() - t0
            self._hits += 1
            self._gather_wait_s += wait
            self._rec.gauge("bank_gather_wait_s", wait)
            self._rec.counter("bank_prefetch_hit")
            self._gathered_bytes = staged[3]
            self._staged_bytes = 0
            self._note_device_bytes()
            return out
        self._misses += 1
        self._rec.counter("bank_prefetch_miss")
        self.flush()  # order after any pending scatter
        self._staged = None
        self._staged_bytes = 0
        out = self._slice_to_device(idx)
        self._gathered_bytes = tree_nbytes(out)
        self._slice_bytes = self._gathered_bytes
        self._note_device_bytes()
        return out

    def _slice_to_device(self, idx):
        """The host rows ``idx`` (all rows for None) as device tensors,
        copied on the current stream."""
        if idx is None:
            return tree_map(lambda b: b.to(self.device, copy=True),
                            self._tree)
        hidx = torch.as_tensor(np.asarray(idx, np.int64))

        def one(b):
            rows = torch.empty((hidx.numel(),) + tuple(b.shape[1:]),
                               dtype=b.dtype, pin_memory=self._cuda)
            torch.index_select(b, 0, hidx, out=rows)
            return rows.to(self.device, non_blocking=self._cuda)

        return tree_map(one, self._tree)

    def prefetch(self, t: int, idx) -> None:
        """Stage round-``t``'s cohort slice host->device off the hot path
        (host backend only; a no-op otherwise). The caller guarantees
        ordering against in-flight scatters: enqueue BEFORE a pending
        scatter only when the two cohorts are disjoint."""
        if not self.prefetch_enabled or idx is None:
            return
        idx = np.asarray(idx, np.int64)

        def stage():
            t0 = time.perf_counter()
            if self._cuda:
                side = self._side
                with torch.cuda.stream(side):
                    out = self._slice_to_device(idx)
                    event = torch.cuda.Event()
                    event.record(side)
            else:
                out, event = self._slice_to_device(idx), None
            self._rec.gauge("bank_prefetch_s", time.perf_counter() - t0)
            return out, event

        fut = self._submit(stage)
        nbytes = sum(_rows_nbytes(l, len(idx))
                     for l in tree_leaves(self._tree))
        self._slice_bytes = max(self._slice_bytes, nbytes)
        self._staged = (int(t), idx, fut, nbytes)
        self._staged_bytes = nbytes
        self._note_device_bytes()

    def scatter(self, idx, updated, *, broadcast: bool = False) -> None:
        """Fold a trained cohort back into the bank. ``idx=None`` is the
        identity cohort (wholesale replace). ``broadcast=True`` writes
        cohort row 0 to every bank row (the client-aggregating schemes'
        model sync, inherently O(N)). Host-backend partial scatters are
        asynchronous: the device->host drain runs on the worker, ordered
        before any later prefetch or flush. Duplicate cohort indices
        resolve to the last occurrence on every backend. Wholesale and
        broadcast scatters drop any staged prefetch: they rewrite every
        row, so the staged slice is stale whatever the cohorts. Sharded
        scatters are local: each rank writes the rows it owns from its
        replicated ``updated``."""
        if self.backend == "sharded":
            self._scatter_local(idx, updated, broadcast)
            self._note_device_bytes()
            return
        if self.backend == "device":
            if broadcast:
                for b, u in zip(tree_leaves(self._tree),
                                tree_leaves(updated)):
                    b.copy_(u[0].expand_as(b))
            elif idx is None:
                self._tree = tree_map(self._on_device, updated)
            else:
                uniq, pos = _last_occurrence(np.asarray(idx, np.int64))
                didx = torch.as_tensor(uniq, device=self.device)
                dpos = None if pos is None else torch.as_tensor(
                    pos, device=self.device)
                for b, u in zip(tree_leaves(self._tree),
                                tree_leaves(updated)):
                    if dpos is not None:
                        u = u.index_select(0, dpos)
                    b.index_copy_(0, didx, u.to(b.dtype))
            self._note_device_bytes()
            return
        if broadcast or idx is None:
            self.flush()
            self._staged = None
            self._staged_bytes = 0
            for b, u in zip(tree_leaves(self._tree), tree_leaves(updated)):
                b.copy_(u[0].expand_as(b) if broadcast else u)
            return
        uniq, pos = _last_occurrence(np.asarray(idx, np.int64))
        hidx = torch.as_tensor(uniq)
        bank_leaves = tree_leaves(self._tree)
        upd_leaves = tree_leaves(updated)
        event = None
        if self._cuda:
            side = self._side
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            for u in upd_leaves:  # read on the worker's stream
                u.record_stream(side)

        def drain():
            t0 = time.perf_counter()
            if event is not None:
                rows = []
                with torch.cuda.stream(side):
                    side.wait_event(event)
                    for u in upd_leaves:
                        buf = torch.empty(u.shape, dtype=u.dtype,
                                          pin_memory=True)
                        rows.append(buf.copy_(u, non_blocking=True))
                side.synchronize()
            else:
                rows = upd_leaves
            for b, u in zip(bank_leaves, rows):
                if pos is not None:
                    u = u[torch.as_tensor(pos)]
                b.index_copy_(0, hidx, u.to(b.dtype))
            self._rec.gauge("bank_scatter_s", time.perf_counter() - t0)

        self._submit(drain)

    def _scatter_local(self, idx, updated, broadcast: bool) -> None:
        if idx is None and not broadcast:
            self._tree = tree_map(self._shard, updated)
            return
        bank = [b.to_local() for b in tree_leaves(self._tree)]
        upd = tree_leaves(updated)
        if broadcast:
            for b, u in zip(bank, upd):
                b.copy_(u[0].expand_as(b))
            return
        uniq, pos = _last_occurrence(np.asarray(idx, np.int64))
        pos = np.arange(uniq.size) if pos is None else pos
        mine = (uniq >= self._lo) & (uniq < self._lo + self._rows)
        if not mine.any():
            return
        didx = torch.as_tensor(uniq[mine] - self._lo, device=self.device)
        dpos = torch.as_tensor(pos[mine], device=self.device)
        for b, u in zip(bank, upd):
            b.index_copy_(0, didx, u.index_select(0, dpos).to(b.dtype))

    # -- whole-bank reductions ---------------------------------------------
    def full_device(self):
        """The whole bank on the device -- O(N) on purpose (the exact
        drift metric on the host bank, small-N debugging; on ``sharded``
        every rank gets the whole bank). Flushes first."""
        self.flush()
        if self.backend == "sharded":
            return self._full(self._tree)
        return tree_map(lambda b: b.to(self.device, copy=True), self._tree)

    def _chunks(self):
        n = self.n_clients
        step = max(1, self.chunk_rows)
        for s in range(0, n, step):
            yield s, min(n, s + step)

    def _one_chunk(self) -> bool:
        return self.backend != "host" or self.n_clients <= self.chunk_rows

    def _w_device(self, w, p):
        w = torch.as_tensor(np.asarray(w, np.float32)) \
            if not isinstance(w, torch.Tensor) else w
        return w.to(p.device, torch.float32).reshape(
            (-1,) + (1,) * (p.ndim - 1))

    def rho_mean(self, rho):
        """rho-weighted mean over the bank axis -> single-copy tree (the
        evaluation-time global model). One chunk: exactly
        ``torch.sum(p * rho, dim=0)`` on the device over the whole leaf,
        the simulator's expression bit for bit. Several chunks (host,
        N > chunk_rows) accumulate in float64 on the host and round
        once: within 1 ulp of the one-chunk result, not bit-exact."""
        if not self.stacked:
            return self._tree
        self.flush()
        if self._one_chunk():
            tree = self._tree if self.backend == "device" \
                else self.full_device()
            return tree_map(lambda p: torch.sum(
                p * self._w_device(rho, p), dim=0), tree)
        rho64 = np.asarray(rho.cpu() if isinstance(rho, torch.Tensor)
                           else rho, np.float64)

        def part(p, s, e):
            w = rho64[s:e].reshape((-1,) + (1,) * (p.ndim - 1))
            return (p[s:e].numpy().astype(np.float64) * w).sum(axis=0)

        acc = None
        for s, e in self._chunks():
            ps = tree_map(lambda p: part(p, s, e), self._tree)
            acc = ps if acc is None else tree_map(np.add, acc, ps)
        return tree_map(lambda a, p: torch.from_numpy(
            np.asarray(a, p.numpy().dtype)).to(self.device), acc, self._tree)

    def merge_anchored(self, block, w):
        """Anchored-delta rho-average of one bank block (a dict of
        (N, ...) leaves) -> single copy:
        ``anchor + sum w (x - anchor)`` with row 0 as the anchor, the
        estimator of ``protocol.aggregate_cohort`` (a bit-exact
        pass-through when all rows agree). One chunk: exactly
        ``aggregate_cohort`` on the device. Several chunks accumulate
        the anchored deltas in float64 on the host and round once,
        within 1 ulp of one chunk."""
        from repro_torch.core.protocol import aggregate_cohort

        self.flush()
        if self.backend == "sharded":
            block = self._full(block)
        if self._one_chunk():
            blk = {k: self._on_device(p) for k, p in block.items()}
            anchor = {k: p[0] for k, p in blk.items()}
            return aggregate_cohort([blk], w, [anchor])[0]
        w64 = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w,
                         np.float64)
        arrays = tree_map(lambda p: p.detach().cpu().numpy()
                          if isinstance(p, torch.Tensor) else np.asarray(p),
                          block)
        anchor = tree_map(lambda p: p[0].astype(np.float64), arrays)

        def part(p, a, s, e):
            wb = w64[s:e].reshape((-1,) + (1,) * (p.ndim - 1))
            return ((p[s:e].astype(np.float64) - a[None]) * wb).sum(0)

        upd = None
        for s, e in self._chunks():
            ps = tree_map(lambda p, a: part(p, a, s, e), arrays, anchor)
            upd = ps if upd is None else tree_map(np.add, upd, ps)
        return tree_map(lambda p, a, u: torch.from_numpy(
            np.asarray(a + u, p.dtype)).to(self.device), arrays, anchor, upd)

    def broadcast_single(self, single):
        """A single-copy block stacked to ``(N, ...)`` in this backend's
        storage (``set_cut`` moving boundary layers client-ward), each
        row its own writable copy."""
        n = self.n_clients
        if self.backend == "host":
            def host(x):
                x = x.detach().cpu() if isinstance(x, torch.Tensor) \
                    else torch.from_numpy(np.asarray(x))
                out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                                  pin_memory=self._cuda)
                return out.copy_(x.unsqueeze(0).expand(out.shape))
            return tree_map(host, single)
        if self.backend == "sharded":
            return tree_map(lambda x: self._dtensor(
                self._on_device(x).unsqueeze(0).expand(
                    (self._rows,) + tuple(x.shape)).clone()), single)
        return tree_map(lambda x: self._on_device(x).unsqueeze(0).expand(
            (n,) + tuple(x.shape)).clone(), single)

    def drift(self, drift_fn) -> float:
        """Gamma drift proxy over the WHOLE bank via ``drift_fn``
        (``ProtocolEngine.client_drift``). The device bank evaluates in
        place; the host bank pays one O(N) host->device copy, the sharded
        bank one O(N) gather onto every rank -- the bit-parity form
        ``SimConfig.drift_metric=True`` selects. The host default streams
        instead (``drift_streamed``)."""
        if not self.stacked:
            return 0.0
        if self.backend != "device":
            return float(drift_fn(self.full_device()))
        return float(drift_fn(self._tree))

    def drift_streamed(self) -> float:
        """Gamma chunk-streamed on the host: per leaf, sum_n ||p_n -
        mean||^2 = sum_n ||p_n||^2 - ||sum_n p_n||^2 / N, accumulated in
        float64 over ``chunk_rows`` slices, so it costs no device memory.
        Algebraically equal to ``drift``; the one-pass form trades
        bit-exactness for streaming (cancellation clamped at 0), which is
        why the parity tests pin ``drift`` and the host default reports
        this one."""
        if not self.stacked:
            return 0.0
        self.flush()
        n = self.n_clients
        total = 0.0
        tree = self._full(self._tree) if self.backend == "sharded" \
            else self._tree
        for p in tree_leaves(tree):
            s1, s2 = 0.0, 0.0
            for s, e in self._chunks():
                c = p[s:e].detach().cpu().numpy().astype(np.float64)
                s1 = s1 + c.sum(axis=0)
                s2 = s2 + float(np.square(c).sum())
            total += s2 - float(np.square(s1).sum()) / n
        return max(total, 0.0)
