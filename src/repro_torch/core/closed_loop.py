"""Closed-loop dynamic-split training: Algorithm 1 executed against live
training (port of ``repro.core.closed_loop``).

The paper's headline is dynamic model splitting: the cutting point is
re-selected every round as channels fade (§IV-B). ``ccc`` learns that
policy; ``run_closed_loop`` executes it:

* per round, a :class:`CutSchedule` (a trained DDQN policy queried on
  the live channel state, a fixed per-round sequence, or a constant)
  picks v;
* ``FedSimulator.set_cut`` migrates the boundary layers, priced by
  ``sysmodel.traffic.migration_bits`` and
  ``sysmodel.latency.migration_latency`` (an equal-share band: the
  migration happens before the round's P2.1 allocation exists);
* the round's wall-clock comes from ``sysmodel.latency`` through the
  P2.1 solve inside ``CuttingPointEnv.step`` (``alloc="opt"``), the
  equal-split baseline (``alloc="fixed"``), or, with an async engine,
  from the engine's virtual clock (per-client completion times);
* the training itself runs at the new cut, on the card unless the
  simulator was built on the CPU.

A constant schedule reproduces the fixed-cut run bit for bit.
``ccc.strategy.CCCResult.cut_schedule`` exports a trained policy as a
``CutSchedule``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs as obslib
from repro_torch.ccc.convex import latency_fixed_alloc
from repro_torch.data.federated import replacement_fraction, round_batches
from repro_torch.sysmodel.comp import scale_by_cut
from repro_torch.sysmodel.latency import migration_latency


class CutSchedule:
    """Per-round cutting-point source for the closed loop.

    Either a concrete per-round sequence (cycled when shorter than the
    run) or a policy callable ``(t, obs) -> v`` queried on the live MDP
    observation (eq. 34 state: normalized gains + cumulative cost).
    """

    def __init__(self, cuts: Optional[Sequence[int]] = None,
                 policy: Optional[Callable] = None, cycle: bool = True,
                 name: str = "schedule"):
        if (cuts is None) == (policy is None):
            raise ValueError("exactly one of cuts/policy must be given")
        self.cuts = None if cuts is None else tuple(int(v) for v in cuts)
        self.policy = policy
        self.cycle = cycle
        self.name = name

    @classmethod
    def constant(cls, v: int) -> "CutSchedule":
        return cls(cuts=(int(v),), name=f"constant_v{int(v)}")

    @classmethod
    def from_sequence(cls, seq: Sequence[int], cycle: bool = True,
                      name: str = "sequence") -> "CutSchedule":
        return cls(cuts=seq, cycle=cycle, name=name)

    @classmethod
    def from_agent(cls, agent, env, name: str = "ddqn") -> "CutSchedule":
        """Greedy rollout of a trained (scalar or batched) DDQN agent,
        evaluated per round on the CURRENT channel observation."""
        def policy(t, obs):
            try:
                a = agent.act(obs, greedy=True)
            except TypeError:  # BatchedDDQNAgent.act is greedy-only
                a = agent.act(obs)
            if not isinstance(a, int):  # the batched agent's (B,) tensor
                a = int(a.reshape(-1)[0])
            v, _codec = env.decode_action(a)
            return v

        return cls(policy=policy, name=name)

    @classmethod
    def random(cls, env, rounds: int, seed: int = 0,
               name: str = "random") -> "CutSchedule":
        """Uniform-random cut per round (the fig. 6 random baseline)."""
        rng = np.random.RandomState(seed)
        cuts = [env.decode_action(int(rng.randint(env.n_actions)))[0]
                for _ in range(rounds)]
        return cls(cuts=cuts, name=name)

    def __call__(self, t: int, obs=None) -> int:
        if self.policy is not None:
            return int(self.policy(t, obs))
        i = t % len(self.cuts) if self.cycle else min(t, len(self.cuts) - 1)
        return self.cuts[i]


@dataclass
class ClosedLoopResult:
    name: str
    cuts: List[int]                      # executed cut per round
    records: List[dict]                  # per-round latency/bits/migration
    curve: List[Tuple[float, float]]     # (cumulative wall-clock s, accuracy)
    final_acc: float
    total_latency_s: float               # training rounds (chi+psi) + migration
    total_bits: float                    # protocol + migration traffic
    migration_bits_total: float
    n_migrations: int
    infeasible_rounds: int = 0

    def acc_at_time(self, budget_s: float) -> float:
        """Accuracy reached by wall-clock ``budget_s`` (step
        interpolation: the last evaluation completed within the budget;
        0.0 before any)."""
        acc = 0.0
        for t, a in self.curve:
            if t <= budget_s:
                acc = a
        return acc


def _fixed_alloc_latency(env, v: int) -> float:
    cfg = env.cfg
    comp = scale_by_cut(env.base_comp, cfg.flop_fracs[v - 1])
    r = latency_fixed_alloc(env.gains, env.smashed_bits(v), cfg.batch,
                            env.comm, comp)
    return r["total"]


def run_closed_loop(sim, env, schedule: CutSchedule, train, test, parts,
                    rounds: int, *, alloc: str = "opt", eval_every: int = 10,
                    batch_seed: int = 0, skip_batches: int = 0,
                    name: Optional[str] = None, log_every: int = 0,
                    async_engine=None) -> ClosedLoopResult:
    """Run ``rounds`` of live training under a per-round cut schedule.

    ``sim`` is a ``core.simulator.FedSimulator``; ``env`` a
    ``ccc.env.CuttingPointEnv`` supplying block fading, the P2.1
    allocation (``alloc="opt"``) and the observation the schedule's
    policy may read; its action space must be the cut-only one (one
    codec). Wall-clock a round = migration latency (if the cut moved) +
    chi+psi at the executed cut; a round where P2.1 is infeasible is
    charged the equal-split latency. ``skip_batches`` fast-forwards the
    data stream past rounds a resumed simulator already trained on (pass
    the restored ``sim._t``).

    The simulator's cohort schedule is threaded through: each round the
    sampler's K participants get the data draws, the env's channel state
    (``set_cohort``, so the observation and the P2.1 bandwidth split
    cover exactly the clients that train) and the migration pricing.

    ``async_engine`` (a ``core.async_engine.AsyncRoundEngine`` built over
    ``sim`` with its own pure data stream) swaps the barrier round for
    one buffered-async merge an iteration: wall-clock comes from the
    engine's virtual clock instead of the P2.1 barrier latency, the
    engine's queue depth and mean staleness feed the observation
    (``env.set_async_stats``, seen when the env was built with
    ``async_obs=True``), and a cut migration drains the in-flight queue
    first (payload shapes are cut-static). The env keeps its own cohort
    draw for the channel state, since refills are not round-aligned."""
    assert env.n_codecs == 1, "closed loop prices the cut-only action space"
    assert env.n_participants == sim.n_participants, \
        (f"env prices {env.n_participants} participants but the simulator "
         f"samples {sim.n_participants}")
    assert alloc in ("opt", "fixed")
    rng = np.random.RandomState(batch_seed)
    t0 = sim._t - skip_batches  # first round the data stream covers
    for i in range(skip_batches):
        idx, _ = sim.cohort_for_round(t0 + i)
        round_batches(train, parts, sim.sim.batch, sim.sim.tau, rng, idx=idx)
    threaded = (sim.n_participants < sim.sim.n_clients
                and async_engine is None)
    idx, _w = sim.cohort_for_round(sim._t)
    if threaded:
        env.set_cohort(idx)
    obs = env.reset()
    t_wall = 0.0
    total_bits = 0.0
    mig_bits_total = 0.0
    n_migrations = 0
    infeasible = 0
    cuts: List[int] = []
    records: List[dict] = []
    curve: List[Tuple[float, float]] = []
    rec = obslib.get_recorder()
    for t in range(rounds):
        if rec.enabled:
            rec.set_round(sim._t)
        if async_engine is not None:
            env.set_async_stats(async_engine.queue_depth,
                                async_engine.mean_staleness())
        v = schedule(t, obs)
        with rec.span("migration", cut=v):
            if async_engine is not None and v != sim.cut:
                # in-flight payload shapes are cut-static: merge the
                # queue down before the boundary layers move
                async_engine.drain()
            mig = sim.set_cut(v)  # zero-traffic no-op when v is unchanged
            mig_lat = 0.0
            if mig["total_bits"]:
                n_migrations += 1
                K = sim.n_participants  # migration bits are already x K
                mig_lat = migration_latency(mig["up_bits"] / K,
                                            mig["down_bits"] / K,
                                            env.gains, env.comm)
        fixed_lat = _fixed_alloc_latency(env, v)
        # the NEXT round's cohort owns the gains env.step draws at the end
        nxt_idx, _ = sim.cohort_for_round(sim._t + 1)
        if threaded:
            env.set_cohort(nxt_idx)
        # advance the MDP with the executed action: P2.1 reward inside,
        # block-fading redraw, observation for the next policy query
        t_solve = time.perf_counter()
        obs, _r, done, info = env.step((v - 1) * env.n_codecs)
        t_solve = time.perf_counter() - t_solve
        if alloc == "opt":
            lat = info["latency"]
            if not np.isfinite(lat):
                infeasible += 1
                lat = fixed_lat
        else:
            lat = fixed_lat
        if done:
            obs = env.reset()  # episode boundary: fresh fading
        t_round = time.perf_counter()
        if async_engine is not None:
            clock0 = async_engine.clock
            m = async_engine.step()
            # the event schedule's own wall-clock replaces the barrier's
            lat = async_engine.clock - clock0
        else:
            m = sim.run_round(*round_batches(train, parts, sim.sim.batch,
                                             sim.sim.tau, rng, idx=idx))
        t_round = time.perf_counter() - t_round
        if rec.enabled:
            # modeled latency is the system model's wall-clock (chi+psi at
            # the executed cut + migration); measured is the host's
            rec.event("round", name="closed_loop", cut=v,
                      latency_modeled=mig_lat + lat,
                      latency_measured=t_round, p21_solve_s=t_solve,
                      migration_s=mig_lat, infeasible=alloc == "opt"
                      and not np.isfinite(info["latency"]))
            rec.gauge("p21_solve_s", t_solve)
            rec.event("cohort", name="data", replacement_fraction=float(
                replacement_fraction(parts, sim.sim.batch, idx=idx)))
        idx = nxt_idx
        round_bits = m["bits_up"] + m["bits_down"] + mig["total_bits"]
        t_wall += mig_lat + lat
        total_bits += round_bits
        mig_bits_total += mig["total_bits"]
        cuts.append(v)
        records.append({"round": t, "cut": v, "loss": m["loss"],
                        "latency_s": lat, "migration_s": mig_lat,
                        "migration_bits": mig["total_bits"],
                        "bits": round_bits, "wall_clock_s": t_wall})
        if (t + 1) % eval_every == 0 or t == rounds - 1:
            with rec.span("eval"):
                acc = sim.evaluate(test.x, test.y)
            curve.append((t_wall, acc))
            if log_every and (t + 1) % log_every == 0:
                obslib.log(f"  round {t+1}/{rounds} cut={v} acc={acc:.3f} "
                           f"wall={t_wall:.2f}s")
    if async_engine is not None and async_engine.queue_depth:
        # merge the leftover in-flight queue and account its clock; the
        # curve gets one final post-drain point
        clock0 = async_engine.clock
        async_engine.drain()
        t_wall += async_engine.clock - clock0
        with rec.span("eval"):
            curve.append((t_wall, sim.evaluate(test.x, test.y)))
    if rec.enabled:
        rec.event("bank", name="bank", **sim.bank.stats())
    # the run owns the bank's worker thread: release it (the simulator
    # stays usable; a later round restarts the worker)
    sim.close()
    return ClosedLoopResult(
        name=name or schedule.name, cuts=cuts, records=records, curve=curve,
        final_acc=curve[-1][1], total_latency_s=t_wall, total_bits=total_bits,
        migration_bits_total=mig_bits_total, n_migrations=n_migrations,
        infeasible_rounds=infeasible)
