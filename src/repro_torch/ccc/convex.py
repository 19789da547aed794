"""P2.1 — convex resource allocation (eq. 32), solved without CVX: the
port's copy of ``repro.ccc.convex`` (the scalar numpy solver) and of
``repro.ccc.convex_jax`` (the batched solver), in one module.

Structure (see paper §IV-B-1): given the cut v, per round minimize
χ + ψ subject to per-client latency constraints (31b)/(31c) and pooled
budgets Σ B_n ≤ B (30f), Σ f_sn ≤ f_max^s (30d).

Monotonicity gives p_n* = p_max and f_n* = f_max (uplink rate and client
compute latency are monotone), and ψ has no pooled variables, so
ψ* = max_n ψ_n(f_max) directly. The remaining problem —

    min χ  s.t.  X/r_n(B_n) + l_F^n + s_n / f_sn ≤ χ,  ΣB ≤ B, Σf ≤ F

— is solved by bisection on χ with a two-resource feasibility oracle:
for fixed χ each client's feasible (B_n, f_sn) region has a convex Pareto
frontier parametrized by the uplink-latency share θ_n; a Lagrangian sweep
over λ (price of server compute in bandwidth units) picks the per-client
point minimizing B_n + λ f_sn, and feasibility holds iff some λ satisfies
both budgets.

Key physical subtlety: r_n(B) = B log2(1 + p g_n / (B N0)) saturates at
p g_n / (N0 ln 2) as B→∞, so uplink latency has a positive infimum
u_min_n = X N0 ln2 / (p g_n); χ below max_n(l_F^n + u_min_n + s_n/F) is
infeasible no matter the allocation.

Two solvers:

* ``solve_p21`` — one round, vectorized numpy in float64: a verbatim copy
  of the reference's, run by the scalar env and the figure scripts.
* ``solve_p21_batched`` — B rounds at once, the counterpart of the
  reference's ``convex_jax.solve_p21_batched``: the same algorithm as
  fixed-iteration batched tensor ops, every early exit of the scalar
  solver a mask. A numpy input runs as torch float64 on the CPU and
  returns numpy (same candidate sequence as ``solve_p21``, so it agrees
  to machine precision); a tensor input stays on its device and dtype
  (f32 on the card, as the reference's jitted path: ~1e-5-relative
  dtype noise against the f64 oracle). The reference jits its loops; here
  they run eagerly, and the bracket growth's early exit costs one host
  sync per doubling (usually one or two).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.sysmodel.comm import CommParams, downlink_rate, uplink_rate
from repro_torch.sysmodel.comp import (CompParams, client_bp_latency,
                                       client_fp_latency)

LN2 = math.log(2.0)
GROWTH_ITERS = 60  # doubling steps to bracket χ (as the scalar solver)


def _invert_rate(target_rate: np.ndarray, power, gains, comm: CommParams,
                 b_hi: float, iters: int = 40) -> np.ndarray:
    """Smallest B with r(B) >= target (vectorized bisection); inf where
    even b_hi cannot reach it (rate saturation)."""
    target = np.asarray(target_rate, np.float64)
    lo = np.full_like(target, 1e-3)
    hi = np.full_like(target, b_hi)
    r_hi = uplink_rate(hi, power, gains, comm)
    infeasible = target > r_hi
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        r = uplink_rate(mid, power, gains, comm)
        lo = np.where(r < target, mid, lo)
        hi = np.where(r < target, hi, mid)
    out = hi
    return np.where(infeasible, np.inf, out)


@dataclass
class AllocationResult:
    chi: float
    psi: float
    total: float
    bandwidth: np.ndarray  # (N,)
    f_server: np.ndarray  # (N,)
    f_client: np.ndarray  # (N,)
    p_tx: np.ndarray  # (N,)
    feasible: bool


def solve_p21(gains: np.ndarray, smashed_bits: float, n_samples: float,
              comm: CommParams, comp: CompParams,
              theta_grid: int = 24, lam_grid: int = 24,
              chi_iters: int = 40) -> AllocationResult:
    """Solve P2.1 for one round. gains: (N,) linear channel gains."""
    N = len(gains)
    g = np.asarray(gains, np.float64)
    p = comm.client_power
    X = float(smashed_bits)

    # monotone-optimal point variables
    f_client = np.full(N, comp.client_cpu_max)
    p_tx = np.full(N, p)

    # ψ: no pooled resources (downlink is broadcast; client BP at f_max)
    r_dn = downlink_rate(g, comm)
    psi = float(np.max(X / np.maximum(r_dn, 1e-9)
                       + client_bp_latency(n_samples, comp, f_client)))

    # fixed per-client terms of χ
    l_F = client_fp_latency(n_samples, comp, f_client)  # (N,)
    s_work = n_samples * (comp.server_fwd_flops + comp.server_bwd_flops) \
        / comp.flops_per_cycle  # server cycles needed per client
    u_min = X * comm.noise_psd * LN2 / (p * g)  # uplink latency infimum

    B_tot = comm.total_bandwidth
    F_tot = comp.server_cpu_max
    lam0 = B_tot / F_tot  # natural price scale
    lams = lam0 * np.logspace(-4, 4, lam_grid)

    def oracle(chi: float):
        """Feasibility + allocation for a candidate χ."""
        c = chi - l_F  # latency budget for uplink + server per client
        # server compute needs f = s/(c - θ); uplink needs r(B) = X/θ
        room = c - u_min
        if np.any(room <= 1e-9):
            return None
        frac = (np.arange(1, theta_grid + 1) / (theta_grid + 1.0))
        theta = u_min[:, None] + room[:, None] * frac[None, :]  # (N,K)
        f_need = s_work / np.maximum(c[:, None] - theta, 1e-12)  # (N,K)
        B_need = _invert_rate(X / theta, p, g[:, None], comm,
                              b_hi=B_tot * 4.0)  # (N,K)
        best = None
        for lam in lams:
            costs = B_need + lam * f_need
            k = np.argmin(costs, axis=1)
            Bn = B_need[np.arange(N), k]
            fn = f_need[np.arange(N), k]
            if Bn.sum() <= B_tot and fn.sum() <= F_tot:
                best = (Bn, fn)
                break
        return best

    # bisection bounds
    lo = float(np.max(l_F + u_min) + s_work / F_tot)
    hi = max(lo * 2, 1.0)
    for _ in range(60):  # grow hi until feasible
        if oracle(hi) is not None:
            break
        hi *= 2.0
    else:
        return AllocationResult(np.inf, psi, np.inf, np.full(N, np.nan),
                                np.full(N, np.nan), f_client, p_tx, False)

    alloc = oracle(hi)
    for _ in range(chi_iters):
        mid = 0.5 * (lo + hi)
        a = oracle(mid)
        if a is None:
            lo = mid
        else:
            hi, alloc = mid, a
    Bn, fn = alloc
    return AllocationResult(chi=hi, psi=psi, total=hi + psi, bandwidth=Bn,
                            f_server=fn, f_client=f_client, p_tx=p_tx,
                            feasible=True)


def latency_fixed_alloc(gains: np.ndarray, smashed_bits: float,
                        n_samples: float, comm: CommParams,
                        comp: CompParams) -> Dict[str, float]:
    """Benchmark baseline (Fig. 6 'fixed resources'): equal bandwidth and
    equal server-CPU split, max power/clock."""
    N = len(gains)
    bw = np.full(N, comm.total_bandwidth / N)
    f_s = np.full(N, comp.server_cpu_max / N)
    f_c = np.full(N, comp.client_cpu_max)
    p = np.full(N, comm.client_power)
    r_up = uplink_rate(bw, p, gains, comm)
    chi = float(np.max(smashed_bits / np.maximum(r_up, 1e-9)
                       + client_fp_latency(n_samples, comp, f_c)
                       + n_samples * (comp.server_fwd_flops + comp.server_bwd_flops)
                       / (f_s * comp.flops_per_cycle)))
    r_dn = downlink_rate(gains, comm)
    psi = float(np.max(smashed_bits / np.maximum(r_dn, 1e-9)
                       + client_bp_latency(n_samples, comp, f_c)))
    return {"chi": chi, "psi": psi, "total": chi + psi}


# ----------------------------------------------------------------------
# The batched solver (counterpart of ``repro.ccc.convex_jax``)
# ----------------------------------------------------------------------

class BatchedAllocationResult(NamedTuple):
    """``AllocationResult`` stacked over the batch: scalars become (B,),
    per-client vectors become (B, N)."""
    chi: Any
    psi: Any
    total: Any
    bandwidth: Any
    f_server: Any
    f_client: Any
    p_tx: Any
    feasible: Any


def _invert_rate_batched(target, power, gains, comm: CommParams,
                         b_hi: float, iters: int = 40):
    """Smallest B with r(B) >= target — fixed-iteration bisection, same
    semantics as ``_invert_rate`` for any batch shape."""
    lo = torch.full_like(target, 1e-3)
    hi = torch.full_like(target, b_hi)
    infeasible = target > uplink_rate(hi, power, gains, comm)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        low = uplink_rate(mid, power, gains, comm) < target
        lo, hi = torch.where(low, mid, lo), torch.where(low, hi, mid)
    return torch.where(infeasible, math.inf, hi)


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    """A comp field (a float, numpy array or tensor) as a tensor on
    ``like``'s device and dtype."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


class _P21Problem:
    """The fixed per-batch quantities of P2.1 plus the χ-feasibility
    oracle; built once, queried ~43 times during bracketing/bisection."""

    def __init__(self, g: torch.Tensor, X_bits: torch.Tensor, n_samples,
                 comm: CommParams, comp: CompParams, theta_grid: int,
                 lam_grid: int):
        self.g = g
        X = self.X = X_bits[:, None]  # (B, 1)
        self.B_batch, self.N = g.shape
        self.comm = comm
        p = self.p = comm.client_power

        self.f_client = torch.full_like(g, comp.client_cpu_max)
        self.p_tx = torch.full_like(g, p)

        # ψ: no pooled resources (downlink broadcast; client BP at f_max)
        r_dn = downlink_rate(g, comm)
        self.psi = (X / r_dn.clamp_min(1e-9)
                    + client_bp_latency(n_samples, comp, self.f_client)
                    ).amax(dim=1)

        # fixed per-client terms of χ
        self.l_F = client_fp_latency(n_samples, comp, self.f_client)  # (B,N)
        s_work = n_samples * (comp.server_fwd_flops + comp.server_bwd_flops) \
            / comp.flops_per_cycle  # server cycles/client: scalar or (B,1)
        self.s_col = _as_tensor(s_work, g).expand(self.B_batch, 1)
        self.u_min = X * comm.noise_psd * LN2 / (p * g)  # (B, N)

        self.B_tot = comm.total_bandwidth
        self.F_tot = comp.server_cpu_max
        # grids built on the host in float64, then cast, as the reference
        self.lams = _as_tensor(
            (self.B_tot / self.F_tot) * np.logspace(-4, 4, lam_grid), g)
        self.frac = _as_tensor(
            np.arange(1, theta_grid + 1) / (theta_grid + 1.0), g)
        # analytic χ infimum (bisection lower bound)
        self.lo0 = (self.l_F + self.u_min).amax(dim=1) \
            + self.s_col[:, 0] / self.F_tot  # (B,)

    def oracle(self, chi, want_alloc: bool = False):
        """Feasibility (+ first-feasible-λ allocation) at χ, shape (B,)."""
        c = chi[:, None] - self.l_F  # (B, N) uplink+server budget
        room = c - self.u_min
        ok_room = (room > 1e-9).all(dim=1)  # (B,)
        theta = self.u_min[..., None] + room[..., None] * self.frac  # (B,N,K)
        f_need = self.s_col[..., None] \
            / (c[..., None] - theta).clamp_min(1e-12)
        B_need = _invert_rate_batched(self.X[..., None] / theta, self.p,
                                      self.g[..., None], self.comm,
                                      b_hi=self.B_tot * 4.0)
        costs = B_need[..., None] + self.lams * f_need[..., None]  # (B,N,K,L)
        k = costs.argmin(dim=2)  # (B, N, L): first minimum, as numpy's
        Bn_l = torch.take_along_dim(B_need, k, dim=2)  # (B, N, L)
        fn_l = torch.take_along_dim(f_need, k, dim=2)
        feas_l = ((Bn_l.sum(dim=1) <= self.B_tot)
                  & (fn_l.sum(dim=1) <= self.F_tot))  # (B, L)
        feasible = feas_l.any(dim=1) & ok_room
        if not want_alloc:
            return feasible
        # first feasible λ: argmax's first-index rule (argmax takes no bool)
        lam_star = feas_l.to(torch.int32).argmax(dim=1)
        Bn = torch.take_along_dim(Bn_l, lam_star[:, None, None], dim=2)[..., 0]
        fn = torch.take_along_dim(fn_l, lam_star[:, None, None], dim=2)[..., 0]
        return feasible, Bn, fn


def _inputs(gains, X_bits):
    """(g, X, to_out): numpy inputs as CPU float64 tensors with a
    converter back to numpy; tensors as they are."""
    if isinstance(gains, torch.Tensor):
        X = X_bits if isinstance(X_bits, torch.Tensor) else \
            torch.as_tensor(X_bits, dtype=gains.dtype, device=gains.device)
        return gains, X, lambda t: t
    g = torch.from_numpy(np.asarray(gains, np.float64))
    X = torch.from_numpy(np.asarray(X_bits, np.float64))
    return g, X, lambda t: t.numpy()


def _comp_for(comp: CompParams, like: torch.Tensor) -> CompParams:
    """``comp`` with array-valued FLOP fields (numpy, from
    ``scale_by_cut``) as tensors on ``like``'s device and dtype."""
    fields = {f: getattr(comp, f) for f in
              ("client_fwd_flops", "client_bwd_flops",
               "server_fwd_flops", "server_bwd_flops")}
    if not any(isinstance(v, np.ndarray) for v in fields.values()):
        return comp
    return CompParams(client_cpu_max=comp.client_cpu_max,
                      server_cpu_max=comp.server_cpu_max,
                      flops_per_cycle=comp.flops_per_cycle,
                      **{f: _as_tensor(v, like) for f, v in fields.items()})


def solve_p21_batched(gains, X_bits, n_samples, comm: CommParams,
                      comp: CompParams, theta_grid: int = 24,
                      lam_grid: int = 24,
                      chi_iters: int = 40) -> BatchedAllocationResult:
    """Solve P2.1 for B independent rounds.

    gains: (B, N) linear channel gains; X_bits: (B,) uplink payloads.
    ``comp`` FLOP fields may be scalars or (B, 1) arrays (per-round cut).
    Backend follows the inputs (see module docstring).
    """
    g, X, to_out = _inputs(gains, X_bits)
    prob = _P21Problem(g, X, n_samples, comm, _comp_for(comp, g),
                       theta_grid, lam_grid)

    # bracket: double hi until the oracle admits it (masked once found).
    # Rows typically bracket in 1-2 doublings, so the loop stops when
    # every row has one: one host sync a doubling.
    hi = (prob.lo0 * 2.0).clamp_min(1.0)
    found = torch.zeros(prob.B_batch, dtype=torch.bool, device=g.device)
    for _ in range(GROWTH_ITERS):
        found = found | prob.oracle(hi)
        hi = torch.where(found, hi, hi * 2.0)
        if bool(found.all()):
            break

    lo = prob.lo0
    for _ in range(chi_iters):
        mid = 0.5 * (lo + hi)
        feas = prob.oracle(mid)
        lo, hi = torch.where(feas, lo, mid), torch.where(feas, mid, hi)

    _, Bn, fn = prob.oracle(hi, want_alloc=True)
    chi = torch.where(found, hi, math.inf)
    rows = found[:, None]
    return BatchedAllocationResult(
        chi=to_out(chi), psi=to_out(prob.psi), total=to_out(chi + prob.psi),
        bandwidth=to_out(torch.where(rows, Bn, math.nan)),
        f_server=to_out(torch.where(rows, fn, math.nan)),
        f_client=to_out(prob.f_client), p_tx=to_out(prob.p_tx),
        feasible=to_out(found))


def p21_feasible_at(gains, X_bits, chi, n_samples, comm: CommParams,
                    comp: CompParams, theta_grid: int = 24,
                    lam_grid: int = 24):
    """Feasibility of candidate χ values (B,) — the bisection oracle
    exposed for tests (infeasible-χ probing) without a full solve."""
    g, X, to_out = _inputs(gains, X_bits)
    prob = _P21Problem(g, X, n_samples, comm, _comp_for(comp, g),
                       theta_grid, lam_grid)
    return to_out(prob.oracle(_as_tensor(chi, g)))
