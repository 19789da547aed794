"""Fig. 10 (extension) on the port: closed-loop dynamic splitting, end to
end.

Each resource strategy's cut schedule drives
``repro_torch.core.closed_loop.run_closed_loop``: live cut migration in
``FedSimulator`` (priced by ``sysmodel.traffic.migration_bits`` and
``sysmodel.latency.migration_latency``), each round's wall-clock from
the P2.1 allocation (or the equal-split baseline), accuracy on held-out
data against the cumulative wall-clock.

Regime: the paper's §V-A constants make latency compute-bound (a 0.1 GHz
client CPU dwarfs every comm term), where neither the allocation nor the
cut moves wall-clock. So this runs fig. 8's comm-bound corner, 1 MHz of
uplink band and 1 GHz edge-accelerator clients, where X(v) and the
bandwidth split dominate the round.

Strategies (same data, same fading seed; baselines at v = 1):

* ``dynamic_ddqn``    Algorithm 1's policy queried on the live channel
* ``fixed_cut_v1``    constant cut, optimal allocation
* ``random_cut``      uniform cut a round, optimal allocation
* ``fixed_alloc_v1``  constant cut, equal-split resources (no P2.1)

Each row: accuracy at the dynamic run's wall-clock budget, final
accuracy, wall-clock, traffic (migration included), migrations, the
cuts, and the host time of the run.

Run:  PYTHONPATH=src:. python benchmarks/torch_fig10_closed_loop.py
          [--rounds R] [--episodes E] [--device cpu]
Defaults: 60 rounds, 40 episodes (REPRO_BENCH_FULL=1: 120 and 200), 10
clients, batch 16, the light CNN: the reference's settings.
"""
from __future__ import annotations

import argparse
import time

from benchmarks.torch_common import FULL, device_arg, device_name, fed_setup
from repro_torch import obs
from repro_torch.ccc.env import CuttingPointEnv, cnn_env_config
from repro_torch.ccc.strategy import run_algorithm1
from repro_torch.configs.paper_cnn import LIGHT_CONFIG
from repro_torch.core.closed_loop import CutSchedule, run_closed_loop
from repro_torch.core.simulator import FedSimulator, SimConfig
from repro_torch.sysmodel.comm import CommParams
from repro_torch.sysmodel.comp import CompParams

BASELINE_CUT = 1
COMM = CommParams(total_bandwidth=1e6)     # below fig. 8's 5 MHz low end
COMP = CompParams(client_cpu_max=1e9)      # edge accelerator, not 0.1 GHz


def _sim(n_clients, batch, rho, seed, device, cut: int = BASELINE_CUT):
    return FedSimulator(LIGHT_CONFIG,
                        SimConfig(scheme="sfl_ga", cut=cut,
                                  n_clients=n_clients, batch=batch),
                        rho=rho, seed=seed, device=device)


def _env(n_clients, batch, seed):
    return CuttingPointEnv(cnn_env_config(n_clients=n_clients, batch=batch,
                                          seed=seed), comm=COMM, comp=COMP)


def run(rounds: int = None, episodes: int = None, dataset: str = "mnist",
        n_clients: int = 10, batch: int = 16, seed: int = 0,
        eval_every: int = 10, device="cuda"):
    rounds = rounds or (120 if FULL else 60)
    episodes = episodes or (200 if FULL else 40)
    train, test, parts, rho = fed_setup(dataset, n_clients=n_clients,
                                        seed=seed)

    # Algorithm 1: learn the cut policy on the channel MDP first (no
    # training data involved), then execute it against live training
    res = run_algorithm1(_env(n_clients, batch, seed), episodes=episodes,
                         device=device)

    def loop(schedule, alloc="opt", name=None):
        t0 = time.perf_counter()
        r = run_closed_loop(
            _sim(n_clients, batch, rho, seed, device),
            _env(n_clients, batch, seed), schedule, train, test, parts,
            rounds=rounds, alloc=alloc, eval_every=eval_every,
            batch_seed=seed, name=name)
        return r, time.perf_counter() - t0

    runs = [loop(res.cut_schedule(_env(n_clients, batch, seed)),
                 name="dynamic_ddqn"),
            loop(CutSchedule.constant(BASELINE_CUT),
                 name=f"fixed_cut_v{BASELINE_CUT}"),
            loop(CutSchedule.random(_env(n_clients, batch, seed), rounds,
                                    seed=seed), name="random_cut"),
            loop(CutSchedule.constant(BASELINE_CUT), alloc="fixed",
                 name=f"fixed_alloc_v{BASELINE_CUT}")]
    budget = runs[0][0].total_latency_s  # acc at the dynamic run's end
    rows = []
    for r, host_s in runs:
        rows.append({
            "strategy": r.name, "final_acc": r.final_acc,
            "wall_clock_s": r.total_latency_s,
            "acc_at_budget": r.acc_at_time(budget),
            "total_mb": r.total_bits / 8e6,
            "migration_mb": r.migration_bits_total / 8e6,
            "n_migrations": r.n_migrations, "cuts": r.cuts,
            "curve": r.curve, "host_s": host_s})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--episodes", type=int, default=None)
    ap.add_argument("--dataset", default="mnist")
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_name(args.device)
    rows = run(rounds=args.rounds, episodes=args.episodes,
               dataset=args.dataset, device=args.device)
    budget = rows[0]["wall_clock_s"]
    print(f"# fig10 closed-loop dynamic splitting (sfl_ga, "
          f"acc@budget={budget:.1f}s) on {dev}")
    for r in rows:
        cuts = r["cuts"]
        cut_str = ",".join(map(str, cuts[:12])) + ("..." if len(cuts) > 12
                                                   else "")
        print(f"  {r['strategy']:>15}: acc@budget={r['acc_at_budget']:.3f} "
              f"final_acc={r['final_acc']:.3f} wall={r['wall_clock_s']:.1f}s "
              f"traffic={r['total_mb']:.1f}MB "
              f"(migrated {r['migration_mb']:.1f}MB in "
              f"{r['n_migrations']} moves) cuts=[{cut_str}] "
              f"host={r['host_s']:.2f}s")
    dyn, fx_alloc = rows[0], rows[3]
    verdict = dyn["acc_at_budget"] > fx_alloc["acc_at_budget"]
    obs.log(f"  dynamic beats fixed-alloc at its own budget: {verdict} "
            f"({dyn['acc_at_budget']:.3f} vs {fx_alloc['acc_at_budget']:.3f})")
    return rows


if __name__ == "__main__":
    main()
