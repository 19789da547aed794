"""Closed-loop dynamic-split training: the port's ``CutSchedule`` (the
per-round cut source of ``repro.core.closed_loop``).

The reference's ``run_closed_loop`` executes Algorithm 1's schedule
against live training (``FedSimulator.set_cut`` per round, migration
priced by ``sysmodel.traffic.migration_bits``); it is not ported yet.
``ccc.strategy.CCCResult.cut_schedule`` exports a trained policy as a
``CutSchedule``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np


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
