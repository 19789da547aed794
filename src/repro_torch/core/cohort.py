"""Cohort sampling for partial participation: the port's copy of
``repro.core.cohort`` (pure numpy, so every schedule equals the
reference's bit for bit).

Real SFL deployments never run all N registered devices every round: a
cohort of K << N participants is sampled, trained and aggregated, while
the other N-K devices sit the round out. This module owns WHO
participates -- the per-round participant index set and the matching
aggregation weights -- as a pure function of ``(seed, t)``, so a
checkpoint/resume at round t replays the identical cohort schedule with
no stored RNG state (the same contract as ``protocol.round_seed``).

Samplers
========

``full``     Identity cohort: every client, weights = rho. The K=N
             default.
``uniform``  K distinct clients uniformly without replacement (sorted, so
             K=N degenerates to the identity permutation). Weights are
             the Horvitz-Thompson ``rho_cohort`` re-weighting
             rho_n / (K/N) -- unbiased: E[sum_{n in C} w_n x_n] =
             sum_n rho_n x_n.
``rho``      K i.i.d. draws with probability rho (with replacement -- a
             heavy client may appear twice and contribute two
             independent local updates), weights 1/K. Unbiased (FedAvg
             "Scheme I", Li et al. 2020).
``latency``  Straggler-avoiding: per round, estimate each client's round
             latency from the wireless system model (``sysmodel.latency``
             chi+psi terms under equal-split bandwidth and fresh block
             fading) and pick the K fastest. Weights are rho renormalized
             over the cohort -- deliberately BIASED toward
             well-connected clients; it trades statistical fidelity for
             wall-clock.

Weights from partial cohorts need not sum to 1; aggregation must then
use the anchored-delta form (``protocol.aggregate_cohort`` with an
anchor), which is what ``CohortSampler.anchored`` signals.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.core.protocol import rho_cohort

SAMPLERS: Tuple[str, ...] = ("full", "uniform", "rho", "latency")

# odd prime stride decorrelating per-round cohort draws (same pattern as
# protocol.ROUND_SEED_STRIDE; a different constant so cohort and codec
# streams never collide)
COHORT_SEED_STRIDE = 888888883


def cohort_rng(seed: int, t: int) -> np.random.RandomState:
    """Per-round RNG, pure in ``(seed, t)`` — the schedule's only state."""
    return np.random.RandomState(
        (int(seed) + int(t) * COHORT_SEED_STRIDE) % (2 ** 31 - 1))


def channel_latency_fn(n_clients: int, seed: int = 0,
                       smashed_bits: float = 1e6, batch: int = 32,
                       comm=None, comp=None) -> Callable[[int], np.ndarray]:
    """Default per-round latency estimator for the ``latency`` sampler.

    Returns ``fn(t) -> (N,)`` per-client round-latency estimates from the
    wireless system model: fixed client distances (drawn once from
    ``seed``), fresh Rayleigh block fading per round (pure in ``(seed,
    t)``), equal-split bandwidth at max power — the pre-P2.1 information
    a scheduler would actually have when picking the cohort.
    """
    from repro_torch.sysmodel.comm import CommParams, path_loss_gain
    from repro_torch.sysmodel.comp import CompParams
    from repro_torch.sysmodel.latency import LatencyModel

    comm = comm or CommParams()
    comp = comp or CompParams()
    model = LatencyModel(comm, comp, smashed_bits, float(batch))
    dists = np.random.RandomState(seed).uniform(0.05, 0.5, n_clients)
    bw = np.full(n_clients, comm.total_bandwidth / n_clients)

    def fn(t: int) -> np.ndarray:
        gains = path_loss_gain(dists, cohort_rng(seed ^ 0x5A5A5A5A, t))
        chi = model.chi_terms(bw, comm.client_power, gains,
                              comp.client_cpu_max, comp.server_cpu_max)
        psi = model.psi_terms(gains, comp.client_cpu_max)
        return np.asarray(chi + psi)

    return fn


class CohortSampler:
    """Per-round participant selection + aggregation weights.

    ``cohort(t)`` returns ``(idx, weights)``: ``idx`` — (K,) int64
    participant indices into the client bank; ``weights`` — (K,) float32
    aggregation weights replacing ρ over the cohort. Pure in ``t``.
    """

    def __init__(self, kind: str, n_clients: int, k: Optional[int] = None,
                 rho: Optional[np.ndarray] = None, seed: int = 0,
                 latency_fn: Optional[Callable[[int], np.ndarray]] = None):
        if kind not in SAMPLERS:
            raise ValueError(f"unknown sampler {kind!r}; known: {SAMPLERS}")
        self.kind = kind
        self.n_clients = int(n_clients)
        self.k = self.n_clients if k is None else int(k)
        if not 1 <= self.k <= self.n_clients:
            raise ValueError(
                f"cohort size {self.k} outside [1, {self.n_clients}]")
        if kind == "full" and self.k != self.n_clients:
            raise ValueError(
                f"sampler 'full' needs K == N, got K={self.k} "
                f"N={self.n_clients}; pick uniform/rho/latency for K < N")
        self.rho = np.asarray(
            rho if rho is not None
            else np.full(self.n_clients, 1.0 / self.n_clients), np.float32)
        if self.rho.shape != (self.n_clients,):
            raise ValueError(f"rho {self.rho.shape} for {self.n_clients} "
                             "clients")
        self.seed = int(seed)
        if kind == "latency":
            self._latency_fn = latency_fn or channel_latency_fn(
                self.n_clients, seed=self.seed)
        self._identity = np.arange(self.n_clients, dtype=np.int64)

    # ------------------------------------------------------------------
    @property
    def identity(self) -> bool:
        """True when every round's cohort is exactly [0..N-1] with ρ
        weights — gathers/scatters are skippable no-ops."""
        return self.kind == "full"

    @property
    def anchored(self) -> bool:
        """Whether aggregation needs the anchored-delta form: partial
        cohorts (weights don't sum to 1 per round) and the with-
        replacement ``rho`` sampler (random multisets even at K=N)."""
        if self.kind == "full":
            return False
        if self.kind == "rho":
            return True
        return self.k < self.n_clients

    # ------------------------------------------------------------------
    def cohort(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        n, k = self.n_clients, self.k
        if self.kind == "full":
            return self._identity, self.rho
        rng = cohort_rng(self.seed, t)
        if self.kind == "uniform":
            idx = np.sort(rng.choice(n, size=k, replace=False))
            # sorted → K=N yields the identity permutation (bit-parity
            # with 'full'); sorting is inclusion-probability-neutral
            return idx.astype(np.int64), rho_cohort(self.rho, idx, k / n)
        if self.kind == "rho":
            idx = np.sort(rng.choice(n, size=k, replace=True, p=self._p()))
            w = np.full(k, 1.0 / k, np.float32)
            return idx.astype(np.int64), w
        # latency: K fastest under this round's channel estimate
        lat = np.asarray(self._latency_fn(t))
        if lat.shape != (n,):
            raise ValueError(f"latency_fn({t}) gave shape {lat.shape}, "
                             f"want ({n},)")
        idx = np.sort(np.argpartition(lat, k - 1)[:k])
        w = self.rho[idx] / max(float(self.rho[idx].sum()), 1e-12)
        return idx.astype(np.int64), w.astype(np.float32)

    def peek(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pure lookahead: exactly what ``cohort(t)`` will return, with
        no schedule state consumed — ``cohort`` is already pure in ``t``
        (a fresh RNG per call), so peeking any number of times, in any
        order, before or after a checkpoint/restore, cannot perturb the
        cohorts a run replays. The bank prefetcher (``core.bank``) leans
        on this to stage round t+1's K-slice while round t trains."""
        return self.cohort(t)

    def _p(self) -> np.ndarray:
        p = self.rho.astype(np.float64)
        return p / p.sum()  # exact simplex for np.random.choice

    def schedule(self, rounds: int, start: int = 0):
        """Convenience: the (idx, weights) stream for a span of rounds."""
        return [self.cohort(t) for t in range(start, start + rounds)]


class AdmissionSampler:
    """Admission schedule for the buffered-async engine (DESIGN.md §16).

    The event-driven round loop (``core.async_engine``) never samples a
    barrier cohort: it keeps an IN-FLIGHT set topped up as clients
    complete. This wrapper turns a :class:`CohortSampler` into that
    admission stream — ``admit(d)`` returns the d-th admitted
    generation ``(idx, weights)``:

    * ``d = 0`` — the initial in-flight set: the base sampler's round-0
      cohort (size K), so the engine starts from exactly the clients a
      synchronous round 0 would have trained;
    * ``d ≥ 1`` — a refill generation of size ``refill`` (the engine's
      buffer B), drawn by a sampler of the same kind/seed/ρ.

    Pure in ``(seed, d)`` — a fresh RNG per call, nothing consumed — so
    checkpoint/resume replays the identical admission (and therefore
    completion/merge) schedule. When ``refill == base.k`` the base
    sampler itself serves every generation: ``admit(d)`` is then
    ``base.cohort(d)``, the exact per-round schedule of the synchronous
    loop — the degenerate case the sync-parity tests pin. A ``full``
    base with ``refill < N`` falls back to ``uniform`` refills (the
    identity cohort has no size-B form); weights stay the base kind's
    Horvitz-Thompson re-weighting, so in-flight cohorts aggregate
    unbiased exactly as partial sync cohorts do.
    """

    def __init__(self, base: CohortSampler, refill: Optional[int] = None):
        self.base = base
        self.refill = base.k if refill is None else int(refill)
        if not 1 <= self.refill <= base.n_clients:
            raise ValueError(
                f"refill size {self.refill} outside [1, {base.n_clients}]")
        kind = "uniform" if (base.kind == "full"
                             and self.refill < base.n_clients) else base.kind
        if self.refill == base.k and kind == base.kind:
            self._refiller = base
        else:
            self._refiller = CohortSampler(
                kind, base.n_clients, self.refill, rho=base.rho,
                seed=base.seed,
                latency_fn=getattr(base, "_latency_fn", None))

    def admit(self, d: int) -> Tuple[np.ndarray, np.ndarray]:
        if d == 0:
            return self.base.cohort(0)
        return self._refiller.cohort(d)

    @property
    def initial_size(self) -> int:
        """Size of the d=0 in-flight set (the sync cohort's K)."""
        return self.base.k


def make_sampler(kind: str, n_clients: int, k: Optional[int] = None,
                 rho: Optional[np.ndarray] = None, seed: int = 0,
                 latency_fn=None) -> CohortSampler:
    return CohortSampler(kind, n_clients, k, rho=rho, seed=seed,
                         latency_fn=latency_fn)


def cohort_stats(idx, w, n_clients: int) -> dict:
    """Summarize one round's cohort for the obs event stream: who
    participated, how far the Horvitz-Thompson weights are from the
    uniform 1/K, and how much of the bank the round touched. Pure
    numpy so recorders can call it per round for free."""
    idx = np.asarray(idx)
    w = np.asarray(w, np.float64)
    return {
        "participants": [int(i) for i in idx],
        "k": int(idx.size),
        "n_clients": int(n_clients),
        "distinct": int(np.unique(idx).size),
        "bank_fraction": float(np.unique(idx).size / max(n_clients, 1)),
        "w_sum": float(w.sum()),
        "w_min": float(w.min()) if w.size else 0.0,
        "w_max": float(w.max()) if w.size else 0.0,
        "w_mean": float(w.mean()) if w.size else 0.0,
    }
