"""MDP for the cutting-point subproblem P2.2 (§IV-B-2, eqs. 34-35): the
port's copy of ``repro.ccc.env``.

State  (eq. 34): per-client channel gains at round t (log-normalized) plus
the normalized cumulative cost Σ_{i<t}(Γ + χ_i + ψ_i).
Action (eq. 34): cutting point v ∈ {1..V-1}.
Reward (eq. 35): -(w·Γ(φ(v)) + χ_t + ψ_t) when the privacy constraint
log(1+φ(v)/q) ≥ ε holds, else the penalty -C. χ/ψ come from solving P2.1.

Γ(φ) = γ0 · φ/q (linear, monotone — satisfies Assumption 4; the paper
leaves Γ unspecified, see DESIGN.md §8).

``CuttingPointEnv`` is a verbatim numpy copy: the same ``RandomState``
draws the same gains, so its transitions equal the reference's bit for
bit. ``BatchedCuttingPointEnv`` steps B envs at once as torch tensors on
the card (a ``torch.Generator`` in place of the jax PRNG), with the
batched P2.1 solver inside the reward.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.ccc.convex import (AllocationResult, solve_p21,
                                    solve_p21_batched)
from repro_torch.sysmodel.comm import (CommParams, path_loss_gain,
                                       path_loss_linear)
from repro_torch.sysmodel.comp import CompParams, scale_by_cut
from repro_torch.sysmodel.payload import spec_for
from repro_torch.sysmodel.privacy import privacy_ok
from repro_torch.sysmodel.traffic import migration_bits, wire_bits


@dataclass
class CuttingEnvConfig:
    phis: Tuple[int, ...]  # φ(v) for v = 1..V-1 (parameter counts)
    smashed_elems: Tuple[int, ...]  # per-sample smashed size for v = 1..V-1
    flop_fracs: Tuple[float, ...]  # client FLOP fraction for v = 1..V-1
    total_params: int  # q
    n_clients: int = 10
    batch: int = 32
    horizon: int = 20  # T rounds per episode
    w: float = 1.0  # convergence-vs-latency weight (eq. 30)
    gamma0: float = 10.0  # Γ(φ) = gamma0 * φ / q
    epsilon: float = 0.001  # privacy threshold ε
    penalty: float = 50.0  # C (reward = -C when infeasible)
    bytes_per_elem: int = 4
    dist_km_range: Tuple[float, float] = (0.05, 0.5)
    seed: int = 0
    # joint cut+codec action space (documented extension): X_t(v) bits
    # become codec-dependent and the convergence term gains a
    # quantization-distortion penalty gamma_q · D(codec), so the agent
    # trades uplink latency against gradient fidelity. The default single
    # fp32 codec reduces exactly to the paper's action space.
    codecs: Tuple[str, ...] = ("fp32",)
    gamma_q: float = 100.0
    # partial participation (DESIGN.md §13): per round only K ≤ N
    # sampled clients train, so the P2.1 solve shares the bandwidth
    # K-ways and the DDQN observes the K participants' gains (state_dim
    # = K+1). None = everyone (the paper's setting).
    cohort: Optional[int] = None
    # buffered-async congestion observations (DESIGN.md §16): append the
    # event engine's queue depth and mean staleness (normalized) to the
    # state so the policy sees merge-pipeline pressure alongside the
    # channel. Default off — state_dim (and trained policies) unchanged.
    async_obs: bool = False
    # cut-migration pricing (DESIGN.md §17): per-cut parameter counts that
    # MOVE when the policy changes v between rounds — full φ(v) for
    # full-parameter runs, the adapter sliver φ̂(v) under PEFT. When set,
    # a v_{t-1} → v_t switch adds the migrating payload's latency (priced
    # at the round's allocated uplink rate) to the cost, so the DDQN
    # weighs migration against the gain — and learns that LoRA makes
    # switching nearly free. None preserves the paper MDP exactly
    # (scalar/batched parity and trained policies unchanged).
    mig_phis: Optional[Tuple[int, ...]] = None


class CuttingPointEnv:
    """Gym-like environment; channel redrawn per round (block fading).

    Action = cut index × codec index: ``a = (v-1) * n_codecs + c`` picks
    cutting point v and transport codec cfg.codecs[c] jointly.

    With ``cfg.cohort = K < n_clients`` the env draws a fresh uniform
    cohort of K participants per round (or honors an externally supplied
    one via :meth:`set_cohort` — how ``core.closed_loop`` aligns the MDP
    with the simulator's cohort schedule); gains, the P2.1 allocation and
    the observation then cover exactly those K clients."""

    def __init__(self, cfg: CuttingEnvConfig,
                 comm: Optional[CommParams] = None,
                 comp: Optional[CompParams] = None):
        self.cfg = cfg
        self.comm = comm or CommParams()
        self.base_comp = comp or CompParams()
        self.rng = np.random.RandomState(cfg.seed)
        self.n_codecs = len(cfg.codecs)
        self.n_actions = len(cfg.phis) * self.n_codecs
        self.n_participants = cfg.cohort or cfg.n_clients
        assert 1 <= self.n_participants <= cfg.n_clients
        self.state_dim = self.n_participants + 1 + (2 if cfg.async_obs else 0)
        self._dists = None
        self._cohort_idx = None  # external override (closed loop)
        self._async_stats = (0.0, 0.0)  # (queue depth, mean staleness)
        self.reset()

    # --------------------------------------------------------------
    def set_async_stats(self, queue_depth: float,
                        mean_staleness: float) -> None:
        """Feed the event engine's congestion state into the next
        observation (``cfg.async_obs`` runs; ``core.closed_loop`` calls
        this before each policy query). No-op state-wise when
        ``async_obs`` is off."""
        self._async_stats = (float(queue_depth), float(mean_staleness))

    def set_cohort(self, idx) -> None:
        """Pin the participant set used for every subsequent gain draw
        (``None`` reverts to the env's own uniform per-round sampling).
        Call before ``reset``/``step`` so round t's channel state covers
        the same K clients the training stack gathered."""
        if idx is not None:
            idx = np.asarray(idx, np.int64)
            if idx.shape != (self.n_participants,):
                raise ValueError(
                    f"cohort index shape {idx.shape} != "
                    f"({self.n_participants},)")
        self._cohort_idx = idx

    def _draw_gains(self) -> np.ndarray:
        if self._dists is None:
            lo, hi = self.cfg.dist_km_range
            self._dists = self.rng.uniform(lo, hi, size=self.cfg.n_clients)
        d = self._dists
        if self._cohort_idx is not None:
            d = d[self._cohort_idx]
        elif self.n_participants < self.cfg.n_clients:
            pick = np.sort(self.rng.choice(self.cfg.n_clients,
                                           self.n_participants,
                                           replace=False))
            d = d[pick]
        return path_loss_gain(d, self.rng)

    def _state(self) -> np.ndarray:
        # log-gain normalized to ~[-1,1]; cumulative cost normalized by horizon
        g = np.log10(self.gains) / 10.0 + 1.0
        cum = self.cum_cost / (self.cfg.horizon * 10.0)
        tail = [cum]
        if self.cfg.async_obs:
            # queue depth normalized by the in-flight target K, staleness
            # by a ~10-merge scale (both O(1) for healthy pipelines)
            q, s = self._async_stats
            tail = [cum, q / self.n_participants, s / 10.0]
        return np.concatenate([g, tail]).astype(np.float32)

    def reset(self) -> np.ndarray:
        self.t = 0
        self.cum_cost = 0.0
        self.prev_v = None  # last executed cut (migration pricing)
        self.gains = self._draw_gains()
        return self._state()

    def gamma_terms(self, v: int, codec: str = "fp32") -> Tuple[float, float]:
        """Γ decomposed: (convergence term gamma0·φ/q, quantization term
        gamma_q·D(codec)) — the reward-decomposition view the obs layer
        reports per episode."""
        conv = self.cfg.gamma0 * self.cfg.phis[v - 1] / self.cfg.total_params
        dist = self.cfg.gamma_q * spec_for(codec).distortion
        return conv, dist

    def gamma_fn(self, v: int, codec: str = "fp32") -> float:
        """Γ(φ_t(v)) — Assumption 4 instantiation — plus the codec's
        quantization-distortion penalty (zero for fp32)."""
        conv, dist = self.gamma_terms(v, codec)
        return conv + dist

    def smashed_bits(self, v: int, codec: str = "fp32") -> float:
        """X_t(v) on the wire under ``codec`` — a thin adapter over the
        unified ``sysmodel.traffic`` accounting (fp32 keeps the paper's
        bytes_per_elem pricing)."""
        elems = self.cfg.smashed_elems[v - 1] * self.cfg.batch
        return wire_bits(codec, elems, self.cfg.bytes_per_elem * 8)

    def decode_action(self, action: int) -> Tuple[int, str]:
        """action -> (cutting point v, codec name)."""
        v_idx, c_idx = divmod(int(action), self.n_codecs)
        return v_idx + 1, self.cfg.codecs[c_idx]

    def cost_terms(self, v: int, codec: str = "fp32",
                   ) -> Tuple[float, float, float, AllocationResult]:
        cfg = self.cfg
        comp = scale_by_cut(self.base_comp, cfg.flop_fracs[v - 1])
        X_bits = self.smashed_bits(v, codec)
        alloc = solve_p21(self.gains, X_bits, cfg.batch, self.comm, comp)
        return self.gamma_fn(v, codec), alloc.chi, alloc.psi, alloc

    def migration_cost(self, v: int, chi: float, X_bits: float
                       ) -> Tuple[float, int]:
        """(latency, total bits) of moving the cut from ``prev_v`` to ``v``
        (``cfg.mig_phis``). The migrating payload rides the round's
        allocated uplink, so its latency is χ scaled by the per-client
        payload ratio against X_t(v) — zero when the cut holds, pricing
        OFF entirely when ``mig_phis`` is None."""
        cfg = self.cfg
        if (cfg.mig_phis is None or self.prev_v is None
                or v == self.prev_v or X_bits <= 0):
            return 0.0, 0
        mb = migration_bits(cfg.mig_phis[self.prev_v - 1],
                            cfg.mig_phis[v - 1],
                            n_clients=self.n_participants,
                            raw_bits_per_elem=cfg.bytes_per_elem * 8)
        per_client = mb["total_bits"] / self.n_participants
        return chi * (per_client / X_bits), mb["total_bits"]

    def step(self, action: int):
        """action ∈ [0, n_actions-1] decodes to (v, codec)."""
        cfg = self.cfg
        v, codec = self.decode_action(action)
        gamma, chi, psi, alloc = self.cost_terms(v, codec)
        ok = privacy_ok(cfg.phis[v - 1], cfg.total_params, cfg.epsilon)
        mig_lat, mig_bits = 0.0, 0
        if ok and alloc.feasible:
            mig_lat, mig_bits = self.migration_cost(
                v, chi, self.smashed_bits(v, codec))
            cost = cfg.w * gamma + chi + psi + mig_lat
            reward = -cost
        else:
            cost = cfg.penalty
            reward = -cfg.penalty
        self.prev_v = v
        self.cum_cost += cost
        self.t += 1
        done = self.t >= cfg.horizon
        self.gains = self._draw_gains()
        g_conv, g_dist = self.gamma_terms(v, codec)
        return self._state(), float(reward), done, {
            "v": v, "codec": codec, "bits": self.smashed_bits(v, codec),
            "chi": chi, "psi": psi, "gamma": gamma,
            "gamma_conv": g_conv, "gamma_dist": g_dist,
            "mig_bits": mig_bits, "mig_latency": mig_lat,
            "privacy_ok": ok, "latency": chi + psi + mig_lat}


class BatchedEnvState(NamedTuple):
    """State of B synchronized episodes, as tensors on the env's device."""
    t: Any         # (B,) int32 — round index within the episode
    cum_cost: Any  # (B,) f32 — Σ_{i<t}(Γ + χ + ψ) (or penalty)
    gains: Any     # (B, N) f32 — this round's channel draw


class BatchedCuttingPointEnv:
    """Vectorized ``CuttingPointEnv``: steps B independent episodes per
    call, as tensors on ``device`` (the card unless the caller passes
    ``device="cpu"``).

    Semantics match the scalar env — same MDP, same action decoding,
    same block-fading redraw per round — but every per-action quantity
    (X_t(v) bits, Γ, client-FLOP fraction, the privacy check, which are
    all pure functions of the discrete action) is precomputed into
    device tables at construction, and the P2.1 reward oracle is the
    batched solver. Episodes run in lockstep (same horizon) and
    auto-reset on done. The env's ``torch.Generator`` on ``device``,
    seeded from ``cfg.seed``, draws the distances, the fading and the
    cohorts; it advances with every draw, so repeated resets (training,
    then a greedy rollout) see fresh fading.
    """

    def __init__(self, cfg: CuttingEnvConfig, n_envs: int,
                 comm: Optional[CommParams] = None,
                 comp: Optional[CompParams] = None, device="cuda"):
        if cfg.mig_phis is not None:
            # Migration pricing makes the reward depend on v_{t-1}, which
            # the precomputed per-action tables can't express. Train the
            # base MDP batched, then evaluate/roll out with the scalar env.
            raise ValueError("mig_phis pricing is scalar-env only; "
                             "construct BatchedCuttingPointEnv with "
                             "mig_phis=None")
        self.device = require_device(device)
        self.cfg = cfg
        self.comm = comm or CommParams()
        self.base_comp = comp or CompParams()
        self.n_envs = n_envs
        self.n_codecs = len(cfg.codecs)
        self.n_actions = len(cfg.phis) * self.n_codecs
        self.n_participants = cfg.cohort or cfg.n_clients
        assert 1 <= self.n_participants <= cfg.n_clients
        self.state_dim = self.n_participants + 1 + (2 if cfg.async_obs else 0)
        self._async_stats = (0.0, 0.0)

        # per-action lookup tables (action = (v-1) * n_codecs + c)
        xbits, g_conv, g_dist, fracs, priv = [], [], [], [], []
        for a in range(self.n_actions):
            v_idx, c_idx = divmod(a, self.n_codecs)
            v, codec = v_idx + 1, cfg.codecs[c_idx]
            elems = cfg.smashed_elems[v - 1] * cfg.batch
            xbits.append(float(wire_bits(codec, elems, cfg.bytes_per_elem * 8)))
            g_conv.append(cfg.gamma0 * cfg.phis[v - 1] / cfg.total_params)
            g_dist.append(cfg.gamma_q * spec_for(codec).distortion)
            fracs.append(cfg.flop_fracs[v - 1])
            priv.append(privacy_ok(cfg.phis[v - 1], cfg.total_params,
                                   cfg.epsilon))

        def table(values, dtype=torch.float32):
            return torch.tensor(values, dtype=dtype, device=self.device)

        self.xbits_table = table(xbits)
        self.gamma_conv_table = table(g_conv)
        self.gamma_dist_table = table(g_dist)
        # summed in python floats BEFORE the f32 cast, as the reference
        self.gamma_table = table([c + d for c, d in zip(g_conv, g_dist)])
        self.frac_table = table(fracs)
        self.priv_table = table(priv, torch.bool)

        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(cfg.seed)
        # fixed client distances per env (the scalar env draws once too)
        lo, hi = cfg.dist_km_range
        dists = lo + (hi - lo) * self._rand(n_envs, cfg.n_clients)
        self._det_gain = path_loss_linear(dists)  # (B, N), fading applied/step

    # --------------------------------------------------------------
    def _rand(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def _draw_gains(self) -> torch.Tensor:
        det = self._det_gain
        if self.n_participants < self.cfg.n_clients:
            # fresh uniform cohort of K participants per env per round:
            # the first K of a random permutation, in index order
            perm = self._rand(self.n_envs, self.cfg.n_clients).argsort(dim=1)
            pick = perm[:, :self.n_participants].sort(dim=1).values
            det = det.gather(1, pick)  # (B, K)
        ray = torch.empty_like(det).exponential_(generator=self.gen)
        return det * ray  # |h|^2 ~ Exp(1)

    def set_async_stats(self, queue_depth: float,
                        mean_staleness: float) -> None:
        """Scalar congestion state broadcast to every env in the batch
        (``cfg.async_obs``), read by the next observation."""
        self._async_stats = (float(queue_depth), float(mean_staleness))

    def _obs(self, state: BatchedEnvState) -> torch.Tensor:
        g = torch.log10(state.gains) / 10.0 + 1.0
        cum = state.cum_cost / (self.cfg.horizon * 10.0)
        cols = [g, cum[:, None]]
        if self.cfg.async_obs:
            q, s = self._async_stats
            cols.append(torch.tensor(
                [q / self.n_participants, s / 10.0], dtype=torch.float32,
                device=self.device).expand(g.shape[0], 2))
        return torch.cat(cols, dim=1).to(torch.float32)

    def reset(self) -> Tuple[BatchedEnvState, torch.Tensor]:
        """Fresh lockstep episodes."""
        state = BatchedEnvState(
            t=torch.zeros(self.n_envs, dtype=torch.int32, device=self.device),
            cum_cost=torch.zeros(self.n_envs, dtype=torch.float32,
                                 device=self.device),
            gains=self._draw_gains())
        return state, self._obs(state)

    def step(self, state: BatchedEnvState, actions):
        """actions: (B,) ints. Returns (state', obs', reward, done, info)
        with per-env tensors. Auto-resets done envs."""
        cfg = self.cfg
        actions = torch.as_tensor(actions, device=self.device).long()
        X_bits = self.xbits_table[actions]
        gamma = self.gamma_table[actions]
        frac = self.frac_table[actions]
        priv = self.priv_table[actions]

        comp = scale_by_cut(self.base_comp, frac[:, None])  # (B,1) fields
        alloc = solve_p21_batched(state.gains, X_bits, float(cfg.batch),
                                  self.comm, comp)
        ok = priv & alloc.feasible
        latency = alloc.chi + alloc.psi
        cost = torch.where(ok, cfg.w * gamma + latency, cfg.penalty)
        reward = -cost

        t2 = state.t + 1
        done = t2 >= cfg.horizon
        state2 = BatchedEnvState(
            t=torch.where(done, 0, t2),
            cum_cost=torch.where(done, 0.0, state.cum_cost + cost),
            gains=self._draw_gains())
        info = {"v": actions // self.n_codecs + 1, "bits": X_bits,
                "chi": alloc.chi, "psi": alloc.psi, "gamma": gamma,
                "gamma_conv": self.gamma_conv_table[actions],
                "gamma_dist": self.gamma_dist_table[actions],
                "privacy_ok": priv, "latency": latency}
        return state2, self._obs(state2), reward, done, info


def cnn_env_config(light: bool = True, flop_aware: bool = False,
                   **kw) -> CuttingEnvConfig:
    """Environment wired to the paper's CNN φ(v)/X(v) splits.

    flop_aware=False (default, paper-faithful): the per-sample workloads are
    the §V-A constants (5.6 / 86.01 MFLOPs) independent of v — the paper
    treats computation split as fixed and lets v drive communication,
    convergence (Γ) and privacy. flop_aware=True recomputes the client
    fraction from the CNN's actual per-block FLOPs (a documented extension).
    The parameter counts come from the CNN's shapes (the reference draws
    params only to count them).
    """
    from repro_torch.configs.paper_cnn import CONFIG, LIGHT_CONFIG
    from repro_torch.models import cnn

    ccfg = LIGHT_CONFIG if light else CONFIG
    V = ccfg.num_layers
    phis = tuple(cnn.phi(ccfg, v) for v in range(1, V))
    smashed = tuple(cnn.smashed_numel(ccfg, v) for v in range(1, V))
    total = cnn.total_params(ccfg)
    base = CompParams()
    paper_frac = base.client_fwd_flops / (base.client_fwd_flops
                                          + base.server_fwd_flops)
    if flop_aware:
        fracs = tuple(cnn.client_flop_fraction(ccfg, v) for v in range(1, V))
    else:
        fracs = tuple(paper_frac for _ in range(1, V))
    return CuttingEnvConfig(phis=phis, smashed_elems=smashed, flop_fracs=fracs,
                            total_params=total, **kw)


def lm_env_config(model_cfg, *, seq: int, peft=None,
                  **kw) -> CuttingEnvConfig:
    """Environment wired to an LM's φ(v)/X(v) splits (DESIGN.md §17).

    φ(v) — which drives the privacy gate and the Γ convergence term — is
    the FULL client-side parameter count (embed + layers[:v]): the frozen
    base is resident client-side under PEFT too, so the privacy surface
    is unchanged. What PEFT changes is the MIGRATION payload: with a
    ``PeftSpec`` the per-cut ``mig_phis`` are the adapter slivers φ̂(v),
    so the DDQN prices a cut move at adapter cost and learns that dynamic
    splitting is nearly free; without one they are φ(v) itself and moves
    are expensive. Smashed payload per sample is seq·d_model at every
    cut (the transformer's residual stream), FLOP fractions come from
    the analytic per-layer counts.

    The counts are the port's ``core.split``: every leaf of a layer, so
    where the reference's count leaves leaves out (QK-norm scales,
    biases, a Mamba-2 layer's extra leaves) φ(v) and q are larger here,
    and an attention-free config, on which the reference raises, has an
    env.
    """
    from repro_torch.core.split import (client_adapter_numel,
                                        client_param_numel, split_flops,
                                        total_param_numel)
    from repro_torch.models import lm as lm_mod

    V = model_cfg.num_layers
    plans = [lm_mod.build_plan(model_cfg, v, peft=peft) for v in range(1, V)]
    phis = tuple(client_param_numel(p) for p in plans)
    smashed = tuple(seq * model_cfg.d_model for _ in plans)
    fracs = []
    for v in range(1, V):
        f = split_flops(model_cfg, v, seq)
        fracs.append(f["client_fwd"] / (f["client_fwd"] + f["server_fwd"]))
    mig = tuple(client_adapter_numel(p) for p in plans) if peft else phis
    return CuttingEnvConfig(phis=phis, smashed_elems=smashed,
                            flop_fracs=tuple(fracs),
                            total_params=total_param_numel(plans[0]),
                            mig_phis=mig, **kw)
