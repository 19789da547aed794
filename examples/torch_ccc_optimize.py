"""Joint CCC strategy (paper Algorithm 1) walkthrough on the port.

Mirrors ``examples/ccc_optimize.py`` on ``repro_torch``: learns the
cutting-point policy with DDQN while solving the convex
resource-allocation subproblem P2.1 inside every reward, then compares
the learned policy against fixed/random benchmarks under two privacy
budgets. A final section widens the action space to cut × transport
codec (the compression extension): the agent jointly picks where to
split AND how many bits per element cross the cut. The learned policy is
exported as a ``CutSchedule``.

Runs on the GPU by default and fails without one; ``--device cpu``
runs the same on the CPU.

Run:  PYTHONPATH=src python examples/torch_ccc_optimize.py
      PYTHONPATH=src python examples/torch_ccc_optimize.py --backend torch

``--backend torch`` swaps the per-episode numpy env for the batched env
on the device: B envs a fused step, the P2.1 oracle solved for the whole
batch at once. With ``numpy`` the env is the scalar numpy one and the
DDQN runs on the device.
"""
import argparse

import numpy as np

from repro_torch.ccc.env import (BatchedCuttingPointEnv, CuttingPointEnv,
                                 cnn_env_config)
from repro_torch.ccc.strategy import (fixed_cut_policy_cost,
                                      random_cut_policy_cost, run_algorithm1,
                                      run_algorithm1_batched)


def _train(cfg, backend: str, episodes: int, n_envs: int, device: str,
           log_every: int = 0):
    if backend == "torch":
        env = BatchedCuttingPointEnv(cfg, n_envs=min(n_envs, episodes),
                                     device=device)
        return run_algorithm1_batched(env, episodes=episodes,
                                      log_every=log_every)
    return run_algorithm1(CuttingPointEnv(cfg), episodes=episodes,
                          log_every=log_every, device=device)


def cutting_point_only(backend: str, episodes: int, n_envs: int,
                       device: str):
    for eps in (0.001, 0.01):
        print(f"\n=== privacy threshold eps={eps} ({backend}) ===")
        cfg = cnn_env_config(horizon=10, batch=16, epsilon=eps, seed=5)
        res = _train(cfg, backend, episodes, n_envs, device, log_every=20)
        r0 = float(np.mean(res.episode_rewards[:6]))
        r1 = float(np.mean(res.episode_rewards[-6:]))
        print(f"Algorithm 1: episode reward {r0:.1f} -> {r1:.1f}; "
              f"greedy cutting points per round: {res.greedy_policy}")
        for v in (1, 2, 3):
            c = fixed_cut_policy_cost(
                CuttingPointEnv(cnn_env_config(horizon=10, batch=16,
                                               epsilon=eps, seed=5)), v, 10)
            print(f"  fixed v={v} + optimal allocation: cost={c['cost']:.1f}")
        c = random_cut_policy_cost(
            CuttingPointEnv(cnn_env_config(horizon=10, batch=16,
                                           epsilon=eps, seed=5)), 10)
        print(f"  random cut + optimal allocation: cost={c['cost']:.1f}")
        # the learned policy as a per-round cut source for live training
        sched = res.cut_schedule()
        print(f"  exported CutSchedule '{sched.name}': "
              f"{[sched(t) for t in range(10)]}")


def joint_cut_and_codec(backend: str, episodes: int, n_envs: int,
                        device: str, eps: float = 0.001):
    """Widened action space: v × {fp32, bf16, int8, int4}. Lower-bit
    codecs shrink X_t(v) (cheaper uplink, lower χ) but pay a
    quantization-distortion penalty in the convergence term."""
    print(f"\n=== joint cut + codec, eps={eps} ({backend}) ===")
    codecs = ("fp32", "bf16", "int8", "int4")
    cfg = cnn_env_config(horizon=10, batch=16, epsilon=eps, seed=5,
                         codecs=codecs)
    n_acts = len(cfg.phis) * len(codecs)
    print(f"action space: {n_acts} = {len(cfg.phis)} cuts x "
          f"{len(codecs)} codecs")
    res = _train(cfg, backend, episodes, n_envs, device, log_every=20)
    r0 = float(np.mean(res.episode_rewards[:6]))
    r1 = float(np.mean(res.episode_rewards[-6:]))
    print(f"Algorithm 1 (joint): episode reward {r0:.1f} -> {r1:.1f}")
    print(f"greedy (v, codec) per round: {res.greedy_policy}")
    # what the chosen codecs save on the wire at the greedy cuts
    env = CuttingPointEnv(cfg)
    for v, codec in sorted(set(res.greedy_policy)):
        fp32 = env.smashed_bits(v, "fp32")
        got = env.smashed_bits(v, codec)
        print(f"  v={v} {codec}: X_t(v) {got/8e3:.1f} kB "
              f"({fp32/got:.2f}x smaller than fp32)")
    sched = res.cut_schedule(env)  # re-queries the agent every round
    print(f"  live CutSchedule '{sched.name}' at round 0: v="
          f"{sched(0, env.reset())}")
    # fp32-only baseline on the same seeds: did codec freedom help?
    bres = _train(cnn_env_config(horizon=10, batch=16, epsilon=eps, seed=5),
                  backend, episodes, n_envs, device)
    print(f"fp32-only final reward "
          f"{float(np.mean(bres.episode_rewards[-6:])):.1f} vs joint {r1:.1f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("numpy", "torch"), default="numpy")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--episodes", type=int, default=None,
                    help="episodes per training run (default 60/80)")
    ap.add_argument("--n-envs", type=int, default=32,
                    help="parallel envs for --backend torch")
    args = ap.parse_args(argv)
    cutting_point_only(args.backend, args.episodes or 60, args.n_envs,
                       args.device)
    joint_cut_and_codec(args.backend, args.episodes or 80, args.n_envs,
                        args.device)


if __name__ == "__main__":
    main()
