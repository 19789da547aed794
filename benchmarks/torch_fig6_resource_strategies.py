"""Fig. 6 on the port — latency under different resource strategies.

Compares Algorithm 1 (DDQN cut + convex allocation) against:
fixed-cut + optimal allocation, fixed-cut + fixed (equal-split)
allocation, and random-cut + optimal allocation. Metric: cumulative
latency + weighted cost over a horizon.

``--backend torch`` trains Algorithm 1 on the batched path (B envs on
the device a fused step); ``numpy`` on the scalar env, with the DDQN on
the device. The learned policy is then evaluated on the same scalar
numpy env as every baseline, so the rows stay comparable across
backends.

Run:  PYTHONPATH=src:. python benchmarks/torch_fig6_resource_strategies.py
      [--backend numpy|torch] [--device cpu] [--episodes E] [--n-envs B]
"""
from __future__ import annotations

import argparse

from benchmarks.torch_common import FULL, device_arg, device_name
from repro_torch import obs
from repro_torch.ccc.env import (BatchedCuttingPointEnv, CuttingPointEnv,
                                 cnn_env_config)
from repro_torch.ccc.strategy import (fixed_alloc_policy_cost,
                                      fixed_cut_policy_cost,
                                      random_cut_policy_cost, run_algorithm1,
                                      run_algorithm1_batched)


def run(episodes: int = None, horizon: int = 10, backend: str = "numpy",
        n_envs: int = 32, device="cuda"):
    episodes = episodes or (200 if FULL else 60)
    kw = dict(horizon=horizon, batch=16, epsilon=0.001)

    def mk(seed):
        return CuttingPointEnv(cnn_env_config(seed=seed, **kw))

    if backend == "torch":
        benv = BatchedCuttingPointEnv(cnn_env_config(seed=7, **kw),
                                      n_envs=min(n_envs, episodes),
                                      device=device)
        res = run_algorithm1_batched(benv, episodes=episodes)

        def act(s):
            return int(res.agent.act(s)[0])
    else:
        res = run_algorithm1(mk(7), episodes=episodes, device=device)

        def act(s):
            return res.agent.act(s, greedy=True)

    env = mk(7)
    s = env.reset()
    alg1_lat, alg1_cost, done = 0.0, 0.0, False
    while not done:
        s, r, done, info = env.step(act(s))
        alg1_lat += info["latency"]
        alg1_cost += -r
    rows = [{"strategy": f"algorithm1(ddqn+convex,{backend})",
             "latency": alg1_lat, "cost": alg1_cost,
             "policy": res.greedy_policy}]
    for v in (1, 2):
        f = fixed_cut_policy_cost(mk(7), v, rounds=horizon)
        rows.append({"strategy": f"fixed_cut_v{v}_opt_alloc", **f})
        g = fixed_alloc_policy_cost(mk(7), v, rounds=horizon)
        rows.append({"strategy": f"fixed_cut_v{v}_fixed_alloc", **g})
    rows.append({"strategy": "random_cut_opt_alloc",
                 **random_cut_policy_cost(mk(7), rounds=horizon)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("numpy", "torch"), default="numpy")
    device_arg(ap)
    ap.add_argument("--episodes", type=int, default=None)
    ap.add_argument("--n-envs", type=int, default=32)
    args = ap.parse_args(argv)
    obs.log(f"# fig6 resource strategies (10-round horizon, {args.backend}) "
            f"[{device_name(args.device)}]")
    for row in run(episodes=args.episodes, backend=args.backend,
                   n_envs=args.n_envs, device=args.device):
        extra = f" policy={row['policy']}" if "policy" in row else ""
        obs.log(f"  {row['strategy']}: latency={row['latency']:.2f}s "
                f"cost={row['cost']:.2f}{extra}")


if __name__ == "__main__":
    main()
