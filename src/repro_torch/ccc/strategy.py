"""Algorithm 1 — the joint CCC strategy: DDQN over cutting points with
convex resource allocation inside the reward (paper §IV-B). The port of
``repro.ccc.strategy``.

Two drivers for the same MDP: ``run_algorithm1`` (scalar numpy env, one
episode at a time — the paper-faithful reference) and
``run_algorithm1_batched`` (B envs on the card stepped in lockstep by
one fused step per round)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs as obslib
from repro_torch.ccc.convex import latency_fixed_alloc
from repro_torch.ccc.ddqn import BatchedDDQNAgent, DDQNAgent, DDQNConfig
from repro_torch.ccc.env import BatchedCuttingPointEnv, CuttingPointEnv
from repro_torch.sysmodel.comp import scale_by_cut
from repro_torch.sysmodel.privacy import privacy_ok


@dataclass
class CCCResult:
    episode_rewards: List[float]
    episode_latencies: List[float]
    # greedy rollout decisions per round: v when the env has a single
    # codec (paper-faithful action space), else (v, codec) pairs
    greedy_policy: List
    agent: object  # DDQNAgent or BatchedDDQNAgent

    def cut_schedule(self, env=None):
        """Export the learned policy as a ``core.closed_loop.CutSchedule``.
        With ``env`` the schedule re-queries the agent on the LIVE channel
        observation every round (the true closed loop); without it the
        frozen greedy rollout is cycled."""
        from repro_torch.core.closed_loop import CutSchedule

        if env is not None:
            return CutSchedule.from_agent(self.agent, env)
        cuts = [v if isinstance(v, int) else v[0] for v in self.greedy_policy]
        return CutSchedule.from_sequence(cuts, name="ddqn_rollout")


def run_algorithm1(env: CuttingPointEnv, episodes: int = 200,
                   agent: Optional[DDQNAgent] = None,
                   log_every: int = 0, device="cuda") -> CCCResult:
    """Alg. 1: for each episode, roll the MDP; each reward internally solves
    P2.1; transitions go to the replay buffer; DDQN updates per step. The
    agent, when not given, is built on ``device``."""
    if agent is None:
        agent = DDQNAgent(DDQNConfig(state_dim=env.state_dim,
                                     n_actions=env.n_actions,
                                     seed=env.cfg.seed), device=device)
    rec = obslib.get_recorder()
    ep_rewards, ep_lat = [], []
    for ep in range(episodes):
        s = env.reset()
        total_r, total_l = 0.0, 0.0
        # per-episode reward decomposition (eq. 35 terms) + TD-loss mean
        dec = {"gamma_conv": 0.0, "gamma_dist": 0.0, "chi": 0.0, "psi": 0.0}
        penalties, losses = 0, []
        done = False
        while not done:
            a = agent.act(s)
            s2, r, done, info = env.step(a)
            losses.append(agent.observe(s, a, r, s2, done))
            s = s2
            total_r += r
            total_l += info["latency"] if np.isfinite(info["latency"]) else 0.0
            if np.isfinite(info["latency"]) and info["privacy_ok"]:
                for k in dec:
                    dec[k] += float(info[k])
            else:
                penalties += 1
        ep_rewards.append(total_r)
        ep_lat.append(total_l)
        if rec.enabled:
            rec.event("ddqn_episode", name="episode", episode=ep,
                      reward=total_r, latency=total_l,
                      eps=agent.epsilon(),
                      td_loss=float(np.mean(losses)) if losses else None,
                      penalties=penalties, q=agent.q_stats(s), **dec)
        if log_every and (ep + 1) % log_every == 0:
            obslib.log(f"  episode {ep+1}/{episodes} reward {total_r:.2f} "
                       f"eps {agent.epsilon():.2f}")
    # greedy rollout to expose the learned cutting-point (+codec) policy
    s = env.reset()
    policy = []
    done = False
    while not done:
        a = agent.act(s, greedy=True)
        v, codec = env.decode_action(a)
        policy.append(v if env.n_codecs == 1 else (v, codec))
        s, _, done, _ = env.step(a)
    return CCCResult(ep_rewards, ep_lat, policy, agent)


def run_algorithm1_batched(env: BatchedCuttingPointEnv, episodes: int = 200,
                           agent: Optional[BatchedDDQNAgent] = None,
                           log_every: int = 0) -> CCCResult:
    """Alg. 1 over B envs on the env's device: ``episodes`` total episodes
    are rolled in ⌈episodes/B⌉ lockstep waves of B; each round is one
    fused step (ε-greedy act → batched P2.1 reward → replay insert →
    gradient update → target sync). The agent, when not given, is built
    on the env's device. Returns the same ``CCCResult`` shape as the
    scalar driver."""
    if agent is None:
        agent = BatchedDDQNAgent(DDQNConfig(state_dim=env.state_dim,
                                            n_actions=env.n_actions,
                                            seed=env.cfg.seed),
                                 device=env.device)
    B = env.n_envs
    waves = max(1, math.ceil(episodes / B))
    ep_rewards: List[float] = []
    ep_lat: List[float] = []
    env_state, obs = env.reset()
    for wave in range(waves):
        wave_r = torch.zeros(B, device=env.device)
        wave_l = torch.zeros(B, device=env.device)
        for _ in range(env.cfg.horizon):
            env_state, obs, r, done, info, _ = agent.fused_step(
                env, env_state, obs)
            wave_r = wave_r + r
            lat = info["latency"]
            wave_l = wave_l + torch.where(torch.isfinite(lat), lat, 0.0)
        wave_r, wave_l = wave_r.cpu().numpy(), wave_l.cpu().numpy()
        ep_rewards.extend(wave_r.tolist())
        ep_lat.extend(wave_l.tolist())
        rec = obslib.get_recorder()
        if rec.enabled:
            # one episode event per env in the wave (episode = global idx)
            for i, (rr, ll) in enumerate(zip(wave_r, wave_l)):
                rec.event("ddqn_episode", name="episode",
                          episode=wave * B + i, reward=float(rr),
                          latency=float(ll))
        if log_every and (wave + 1) % max(1, log_every // B) == 0:
            obslib.log(f"  wave {wave+1}/{waves} ({len(ep_rewards)} episodes) "
                       f"mean reward {float(np.mean(wave_r)):.2f}")
    ep_rewards, ep_lat = ep_rewards[:episodes], ep_lat[:episodes]
    # greedy rollout (env 0's trajectory) exposes the learned policy
    env_state, obs = env.reset()
    policy = []
    for _ in range(env.cfg.horizon):
        a = agent.act(obs)
        env_state, obs, _, _, info = env.step(env_state, a)
        v, codec = divmod(int(a[0]), env.n_codecs)
        policy.append(v + 1 if env.n_codecs == 1
                      else (v + 1, env.cfg.codecs[codec]))
    return CCCResult(ep_rewards, ep_lat, policy, agent)


def _baseline_round_cost(env: CuttingPointEnv, v: int,
                         codec: str = "fp32") -> Dict:
    """One round's (latency, cost) for a baseline policy, under the SAME
    rules the DDQN reward pays (eq. 35): infeasible allocation or a
    privacy violation costs the penalty C, not the raw χ+ψ — otherwise
    fig. 6 would compare a penalized agent against unpenalized baselines.
    Infinite χ (infeasible P2.1) contributes 0 to the latency sum, exactly
    like the Algorithm 1 accounting in ``run_algorithm1``."""
    cfg = env.cfg
    gamma, chi, psi, alloc = env.cost_terms(v, codec)
    ok = privacy_ok(cfg.phis[v - 1], cfg.total_params, cfg.epsilon) \
        and alloc.feasible
    lat = chi + psi if np.isfinite(chi + psi) else 0.0
    cost = cfg.w * gamma + chi + psi if ok else cfg.penalty
    return {"latency": lat, "cost": cost}


def fixed_cut_policy_cost(env: CuttingPointEnv, v: int, rounds: int = 20) -> Dict:
    """Benchmark: fixed cutting layer with optimal resource allocation."""
    env.reset()
    lat, cost = 0.0, 0.0
    for _ in range(rounds):
        r = _baseline_round_cost(env, v)
        lat += r["latency"]
        cost += r["cost"]
        env.gains = env._draw_gains()
    return {"latency": lat, "cost": cost}


def fixed_alloc_policy_cost(env: CuttingPointEnv, v: int, rounds: int = 20) -> Dict:
    """Benchmark: fixed cut AND fixed (equal-split) resources."""
    env.reset()
    cfg = env.cfg
    lat, cost = 0.0, 0.0
    for _ in range(rounds):
        comp = scale_by_cut(env.base_comp, cfg.flop_fracs[v - 1])
        X_bits = cfg.smashed_elems[v - 1] * cfg.batch * cfg.bytes_per_elem * 8
        r = latency_fixed_alloc(env.gains, X_bits, cfg.batch, env.comm, comp)
        lat += r["total"]
        # equal-split is always "feasible" (no pooled budget to violate),
        # but the privacy constraint still binds — same penalty as eq. 35
        ok = privacy_ok(cfg.phis[v - 1], cfg.total_params, cfg.epsilon)
        cost += cfg.w * env.gamma_fn(v) + r["total"] if ok else cfg.penalty
        env.gains = env._draw_gains()
    return {"latency": lat, "cost": cost}


def random_cut_policy_cost(env: CuttingPointEnv, rounds: int = 20,
                           seed: int = 0) -> Dict:
    rng = np.random.RandomState(seed)
    env.reset()
    lat, cost = 0.0, 0.0
    for _ in range(rounds):
        v, codec = env.decode_action(int(rng.randint(env.n_actions)))
        r = _baseline_round_cost(env, v, codec)
        lat += r["latency"]
        cost += r["cost"]
        env.gains = env._draw_gains()
    return {"latency": lat, "cost": cost}
