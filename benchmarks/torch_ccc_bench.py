"""CCC throughput on the port: the batched path on the device vs the
numpy loop.

Times the levels of the stack (CSV ``name,us_per_call,derived``):

* ``p21_solve``         — scalar numpy ``solve_p21`` per round.
* ``p21_solve_batched`` — ``solve_p21_batched`` per round (B at once, f32
  on the device).
* ``env_step``          — scalar ``CuttingPointEnv.step`` (reward incl. solve).
* ``env_step_batched``  — ``BatchedCuttingPointEnv.step`` per env-step.
* ``fused_train_step``  — the full act+observe+update fused DDQN step.

The acceptance bar is the reference's (``benchmarks/ccc_bench.py``): the
batched env step at B envs must be ≥ 10× faster per env-step than the
numpy loop; the script exits 1 when it is not. On CUDA, ``# profile``
lines then give each batched call's kernel launches and the device's
busy share of its wall time (``torch.profiler``, one call each after the
timed ones).

Run:  PYTHONPATH=src:. python benchmarks/torch_ccc_bench.py [--quick]
      [--n-envs 64] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from benchmarks.torch_common import device_arg, device_name


def _timeit(fn, iters: int, warmup: int = 1) -> float:
    """Seconds per call (``fn`` ends in a device sync where it must)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def _profile(fn, n: int = 2):
    """(kernel launches, device-busy ms, wall ms) per call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    return sum(e.count for e in kernels) / n, busy_ms, wall_ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="fewer timing iterations (CI smoke)")
    ap.add_argument("--n-envs", type=int, default=64)
    device_arg(ap)
    args = ap.parse_args(argv)

    from repro_torch import require_device
    from repro_torch.ccc.convex import solve_p21, solve_p21_batched
    from repro_torch.ccc.ddqn import BatchedDDQNAgent, DDQNConfig
    from repro_torch.ccc.env import (BatchedCuttingPointEnv, CuttingPointEnv,
                                     cnn_env_config)
    from repro_torch.sysmodel.comm import CommParams, path_loss_gain
    from repro_torch.sysmodel.comp import CompParams

    dev = require_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    print(f"# device {device_name(dev)}")
    B = args.n_envs
    iters = 3 if args.quick else 10
    np_iters = 4 if args.quick else 16

    # ---- P2.1 solver ------------------------------------------------
    rng = np.random.RandomState(0)
    N = 10
    gains = np.stack([path_loss_gain(rng.uniform(0.05, 0.5, N), rng)
                      for _ in range(B)])
    X = rng.uniform(1e5, 5e7, B)
    comm, comp = CommParams(), CompParams()

    t_np = _timeit(lambda: solve_p21(gains[0], X[0], 16, comm, comp),
                   np_iters)
    print(f"p21_solve,{t_np*1e6:.0f},numpy per-round")

    gt = torch.tensor(gains, dtype=torch.float32, device=dev)
    xt = torch.tensor(X, dtype=torch.float32, device=dev)

    def solve():
        solve_p21_batched(gt, xt, 16.0, comm, comp)
        sync()

    t_b = _timeit(solve, iters)
    print(f"p21_solve_batched,{t_b/B*1e6:.0f},B={B} per-round "
          f"({t_b*1e3:.2f} ms a call) speedup={t_np/(t_b/B):.1f}x")

    # ---- env reward step (solve + tables + fading redraw) ----------
    cfg = cnn_env_config(horizon=10, batch=16, epsilon=0.001, seed=0)
    senv = CuttingPointEnv(cfg)
    senv.reset()
    arng = np.random.RandomState(1)

    def np_step():
        senv.step(int(arng.randint(senv.n_actions)))

    t_np_env = _timeit(np_step, np_iters)
    print(f"env_step,{t_np_env*1e6:.0f},numpy per-env-step")

    benv = BatchedCuttingPointEnv(cfg, n_envs=B, device=dev)
    state, _ = benv.reset()
    actions = torch.tensor(arng.randint(0, benv.n_actions, B), device=dev)

    def env_step():
        benv.step(state, actions)
        sync()

    t_env = _timeit(env_step, iters)
    env_speedup = t_np_env / (t_env / B)
    print(f"env_step_batched,{t_env/B*1e6:.0f},B={B} per-env-step "
          f"({t_env*1e3:.2f} ms a call) speedup={env_speedup:.1f}x")

    # ---- fused DDQN train step (act+env+replay+update+sync) --------
    agent = BatchedDDQNAgent(DDQNConfig(state_dim=benv.state_dim,
                                        n_actions=benv.n_actions, seed=0),
                             device=dev)
    st, ob = benv.reset()
    holder = {"st": st, "ob": ob}

    def fused():
        holder["st"], holder["ob"], *_ = agent.fused_step(
            benv, holder["st"], holder["ob"])
        sync()

    for _ in range(-(-agent.cfg.batch // B)):  # past warm-up: updates run
        fused()
    t_fused = _timeit(fused, iters)
    print(f"fused_train_step,{t_fused/B*1e6:.0f},B={B} act+observe+update "
          f"per-env-step ({t_fused*1e3:.2f} ms a call)")

    if dev.type == "cuda":
        for name, fn in (("p21_solve_batched", solve),
                         ("env_step_batched", env_step),
                         ("fused_train_step", fused)):
            n, busy, wall = _profile(fn)
            print(f"# profile {name}: {n:.0f} kernel launches a call, "
                  f"device busy {busy:.3f} of {wall:.2f} ms "
                  f"({100 * busy / wall:.1f} %)")

    ok = env_speedup >= 10.0
    print(f"# batched-vs-numpy env-step speedup {env_speedup:.1f}x "
          f"(target >=10x): {'OK' if ok else 'BELOW TARGET'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
