"""Fig. 7 on the port — Algorithm 1 reward convergence under privacy
constraints.

Paper claim: rewards converge within a few hundred episodes; tighter ε
(stronger privacy) forces deeper cuts => lower (more negative) converged
reward.

``--backend torch`` rolls each privacy setting's episodes in waves of B
envs on the device (one fused step a round); ``numpy`` runs the scalar
env with the DDQN on the device. Each setting's wall time is logged.

Run:  PYTHONPATH=src:. python benchmarks/torch_fig7_ddqn_convergence.py
      [--backend numpy|torch] [--device cpu] [--episodes E] [--n-envs B]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from benchmarks.torch_common import FULL, device_arg, device_name
from repro_torch import obs
from repro_torch.ccc.env import (BatchedCuttingPointEnv, CuttingPointEnv,
                                 cnn_env_config)
from repro_torch.ccc.strategy import run_algorithm1, run_algorithm1_batched


def run(episodes: int = None, backend: str = "numpy", n_envs: int = 32,
        device="cuda"):
    episodes = episodes or (300 if FULL else 80)
    out = []
    for eps in (0.0001, 0.001, 0.01):
        cfg = cnn_env_config(horizon=10, batch=16, epsilon=eps, seed=3)
        t0 = time.perf_counter()
        if backend == "torch":
            env = BatchedCuttingPointEnv(cfg, n_envs=min(n_envs, episodes),
                                         device=device)
            res = run_algorithm1_batched(env, episodes=episodes)
        else:
            res = run_algorithm1(CuttingPointEnv(cfg), episodes=episodes,
                                 device=device)
        k = max(1, episodes // 10)
        out.append({
            "epsilon": eps,
            "first_rewards": float(np.mean(res.episode_rewards[:k])),
            "last_rewards": float(np.mean(res.episode_rewards[-k:])),
            "greedy_policy": res.greedy_policy,
            "curve": res.episode_rewards,
            "wall_s": time.perf_counter() - t0,
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("numpy", "torch"), default="numpy")
    device_arg(ap)
    ap.add_argument("--episodes", type=int, default=None)
    ap.add_argument("--n-envs", type=int, default=32)
    args = ap.parse_args(argv)
    obs.log(f"# fig7 DDQN reward convergence vs privacy epsilon "
            f"({args.backend}) [{device_name(args.device)}]")
    for row in run(episodes=args.episodes, backend=args.backend,
                   n_envs=args.n_envs, device=args.device):
        obs.log(f"  eps={row['epsilon']}: reward {row['first_rewards']:.1f} "
                f"-> {row['last_rewards']:.1f}, greedy "
                f"v={row['greedy_policy']}, wall {row['wall_s']:.2f} s")


if __name__ == "__main__":
    main()
