"""Event-driven buffered-async round engine (port of
``repro.core.async_engine``).

The synchronous loop runs every round as a global barrier: sample K
clients, wait for all of them, aggregate, so one slow channel stalls the
round. The paper's latency model (§IV eq. 29) already prices the
per-client completion times needed to break the barrier. This engine
is the event-driven alternative:

* a **virtual clock**: each admitted client completes at its own chi+psi
  time (``sysmodel.latency.completion_time_fn``), queued as an event;
* a **buffered merge**: when the B earliest completions are in, the
  server folds their deltas into the current model with
  ``protocol.merge_async``, the staleness-weighted anchored form
  (weights scale deltas, never the model, so partial merges stay
  unbiased), with the discount (1 + tau_i)^(-lambda), tau_i the merges
  elapsed since client i was dispatched (FedBuff, Nguyen et al. 2022);
* an **admission stream**: ``cohort.AdmissionSampler`` refills the
  in-flight set back to K as clients complete, pure in ``(seed, d)``,
  so a checkpoint/resume replays the identical completion and merge
  order.

Sync is the degenerate case, not a separate code path: with B = K and
zero latency spread every generation completes at once and fills the
buffer exactly, and the engine hands the step to the executor's
unchanged synchronous round (``run_sync``), bit-identical to the barrier
loop by construction.

The engine is executor-agnostic. An executor provides:

``run_sync(d, idx, w)``
    the synchronous round, verbatim (degenerate path);
``run_generation(d, idx, w) -> payload``
    dispatch-time compute for one admitted generation against the
    current models; returns a payload tree holding each participant's
    outputs and deltas;
``apply_merge(items, taus, lam, merge_idx) -> metrics``
    fold a buffer of completed entries (each referencing its
    generation's payload row) into the live model;
``checkpoint_state() / checkpoint_template() / gen_template(size) /
prepare_restore(meta) / restore_state(tree, meta)``
    the checkpoint surface ``save``/``restore`` compose with.

Checkpoints are the reference's files byte for byte
(``repro_torch.checkpoint``), and the obs events and gauges carry the
reference's names (the ``async``/``merge`` event, ``async_queue_depth``,
``async_staleness``), so ``python -m repro_torch.obs.report`` (and the
reference's report) reads a port run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.checkpoint import (load_checkpoint, load_checkpoint_meta,
                                    save_checkpoint)


@dataclass
class _Job:
    """One in-flight client: completes at virtual time ``done``."""
    done: float    # virtual completion time (clock + per-client chi+psi)
    client: int    # bank index
    gen: int       # admission generation that dispatched it
    pos: int       # row inside the generation's payload
    born: int      # merge_idx at dispatch: staleness tau = merge_idx - born
    w: float       # the admission cohort's weight for this client


class AsyncRoundEngine:
    """Virtual-clock event queue + buffered staleness-weighted merges.

    ``step()`` is the async analogue of one synchronous round: refill
    the in-flight set to its target size (the d=0 admission's K), then
    merge the B earliest completions. ``drain()`` merges everything
    still in flight without refilling (end of run, or before a cut
    migration: payload shapes are cut-static)."""

    def __init__(self, executor, admission, completion_fn, *,
                 buffer: Optional[int] = None, lam: float = 0.5):
        self.executor = executor
        self.admission = admission
        self.completion_fn = completion_fn
        self.target = int(admission.initial_size)  # in-flight set size K
        self.buffer = self.target if buffer is None else int(buffer)
        if not 1 <= self.buffer <= self.target:
            raise ValueError(
                f"buffer B={self.buffer} outside [1, K={self.target}]")
        self.lam = float(lam)
        self.clock = 0.0       # virtual wall-clock (seconds)
        self.merge_idx = 0     # merges completed (the async round counter)
        self.dispatch_idx = 0  # admission generations dispatched
        self.sync_steps = 0    # steps that took the degenerate sync path
        self.pending: List[_Job] = []
        self._gens: Dict[int, dict] = {}  # gen -> payload + refcount
        # once any step dispatches asynchronously the executor's round
        # counter decouples from the generation index, so the degenerate
        # path (which IS the synchronous round) is no longer reachable
        self._sync_ok = True
        self._rec = obs.get_recorder()

    # ------------------------------------------------------------------
    def step(self):
        """Refill the in-flight set, then merge the B earliest
        completions. Returns the executor's metrics dict, extended with
        the event-level view (virtual clock, staleness, queue depth)."""
        dispatched: List[int] = []
        while len(self.pending) < self.target:
            d = self.dispatch_idx
            idx, w = self.admission.admit(d)
            idx = np.asarray(idx, np.int64)
            w = np.asarray(w, np.float32)
            per = np.asarray(self.completion_fn(d), np.float64)[idx]
            if (self._sync_ok and not self.pending
                    and idx.size == self.buffer
                    and float(per.min()) == float(per.max())):
                # degenerate schedule: the whole generation completes at
                # once and fills the buffer exactly -- the synchronous
                # barrier round, through the unchanged sync code
                out = self.executor.run_sync(d, idx, w)
                self.dispatch_idx += 1
                self.merge_idx += 1
                self.clock += float(per[0])
                self.sync_steps += 1
                out = dict(out)
                out.update(clock=self.clock, merged=int(idx.size),
                           staleness_mean=0.0, staleness_max=0.0,
                           queue_depth=0, merge_idx=self.merge_idx - 1)
                return out
            self._sync_ok = False
            payload = self.executor.run_generation(d, idx, w)
            self._gens[d] = {"payload": payload, "left": int(idx.size),
                             "size": int(idx.size)}
            for i in range(idx.size):
                self.pending.append(_Job(
                    done=self.clock + float(per[i]), client=int(idx[i]),
                    gen=d, pos=i, born=self.merge_idx, w=float(w[i])))
            self.dispatch_idx += 1
            dispatched.append(int(idx.size))
        return self._merge(self.buffer, dispatched)

    def drain(self):
        """Merge every in-flight client without refilling (the final
        merges may be smaller than B). Returns the per-merge metrics."""
        outs = []
        while self.pending:
            outs.append(self._merge(min(self.buffer, len(self.pending)), []))
        return outs

    def _merge(self, size: int, dispatched: List[int]):
        if not self.pending:
            return None
        size = min(size, len(self.pending))
        # completion order; (client, gen) breaks virtual-time ties
        # deterministically so resume replays the identical merge order
        self.pending.sort(key=lambda j: (j.done, j.client, j.gen))
        take, self.pending = self.pending[:size], self.pending[size:]
        self.clock = max(self.clock, take[-1].done)
        taus = np.asarray([self.merge_idx - j.born for j in take], np.float64)
        items = [{"gen": j.gen, "payload": self._gens[j.gen]["payload"],
                  "pos": j.pos, "client": j.client, "w": j.w} for j in take]
        rec = self._rec
        if rec.enabled:
            rec.set_round(self.merge_idx)
        out = self.executor.apply_merge(items, taus, self.lam, self.merge_idx)
        self.merge_idx += 1
        for j in take:
            g = self._gens[j.gen]
            g["left"] -= 1
            if g["left"] == 0:  # last entry merged: release the payload
                del self._gens[j.gen]
        out = dict(out or {})
        out.update(clock=self.clock, merged=size,
                   staleness_mean=float(taus.mean()),
                   staleness_max=float(taus.max()),
                   queue_depth=len(self.pending),
                   merge_idx=self.merge_idx - 1)
        if rec.enabled:
            rec.gauge("async_queue_depth", float(len(self.pending)))
            rec.gauge("async_staleness", float(taus.mean()))
            rec.event("async", name="merge", merge_idx=self.merge_idx - 1,
                      clock=self.clock, merged=size, dispatched=dispatched,
                      queue_depth=len(self.pending),
                      staleness_mean=float(taus.mean()),
                      staleness_max=float(taus.max()))
        return out

    # ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self.pending)

    def mean_staleness(self) -> float:
        """Mean staleness of the current in-flight set (merges elapsed
        since each client's dispatch): a DDQN congestion observation."""
        if not self.pending:
            return 0.0
        return float(np.mean([self.merge_idx - j.born
                              for j in self.pending]))

    def inflight_clients(self) -> np.ndarray:
        return np.unique(np.asarray(
            [j.client for j in self.pending], np.int64))

    def stats(self) -> Dict:
        return {"clock": float(self.clock), "merges": self.merge_idx,
                "dispatches": self.dispatch_idx,
                "queue_depth": len(self.pending),
                "mean_staleness": self.mean_staleness(),
                "sync_steps": self.sync_steps,
                "buffer": self.buffer, "lam": self.lam}

    # -- checkpoint ------------------------------------------------------
    def save(self, path: str, extra_meta: Optional[Dict] = None) -> None:
        """Checkpoint the event schedule: executor state, in-flight
        generation payloads and the queue and counters. Admission and
        completion draws are pure in ``(seed, d)``, so counters and the
        pending queue are the only schedule state: a resumed run replays
        the identical completion and merge order. The meta keys and
        their order are the reference's, so the same state and meta
        give the same file bytes."""
        exec_state, exec_meta = self.executor.checkpoint_state()
        state = {"exec": exec_state,
                 "gens": {str(d): g["payload"]
                          for d, g in sorted(self._gens.items())}}
        meta = dict(exec_meta)
        meta.update({
            "async_clock": float(self.clock),
            "async_merge_idx": int(self.merge_idx),
            "async_dispatch_idx": int(self.dispatch_idx),
            "async_buffer": int(self.buffer),
            "async_lam": float(self.lam),
            "async_sync_ok": bool(self._sync_ok),
            "async_sync_steps": int(self.sync_steps),
            "async_pending": [[j.done, j.client, j.gen, j.pos, j.born, j.w]
                              for j in self.pending],
            "async_gen_sizes": {str(d): g["size"]
                                for d, g in self._gens.items()},
        })
        if extra_meta:
            meta.update(extra_meta)
        save_checkpoint(path, state, meta)

    def restore(self, path: str) -> Dict:
        meta = load_checkpoint_meta(path)
        for key, got in (("async_buffer", self.buffer),
                         ("async_lam", self.lam)):
            if key in meta and meta[key] != got:
                raise ValueError(
                    f"checkpoint {key} {meta[key]!r} != engine {got!r}: "
                    f"resuming would change the merge schedule")
        self.executor.prepare_restore(meta)
        sizes = {k: int(v)
                 for k, v in meta.get("async_gen_sizes", {}).items()}
        template = {"exec": self.executor.checkpoint_template(),
                    "gens": {k: self.executor.gen_template(v)
                             for k, v in sizes.items()}}
        state, meta = load_checkpoint(path, template)
        self.executor.restore_state(state["exec"], meta)
        left: Dict[int, int] = {}
        self.pending = []
        for done, client, gen, pos, born, w in meta.get("async_pending", []):
            self.pending.append(_Job(float(done), int(client), int(gen),
                                     int(pos), int(born), float(w)))
            left[int(gen)] = left.get(int(gen), 0) + 1
        # in the loaded tree's key order (sorted strings, as jax's
        # unflatten gives the reference), so a re-save writes its bytes
        self._gens = {int(k): {"payload": payload,
                               "left": left.get(int(k), 0),
                               "size": sizes[k]}
                      for k, payload in sorted(state["gens"].items())}
        self.clock = float(meta["async_clock"])
        self.merge_idx = int(meta["async_merge_idx"])
        self.dispatch_idx = int(meta["async_dispatch_idx"])
        self._sync_ok = bool(meta.get("async_sync_ok", False))
        self.sync_steps = int(meta.get("async_sync_steps", 0))
        if hasattr(self.executor, "sync_inflight"):
            self.executor.sync_inflight([j.client for j in self.pending])
        return meta
