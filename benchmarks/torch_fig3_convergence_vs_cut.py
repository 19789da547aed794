"""Fig. 3 on the port — convergence vs cutting point.

Paper claim: SFL (benchmark) converges fastest; SFL-GA degrades as the
cutting point v grows (bigger client model => bigger aggregation
discrepancy Γ(φ(v))). Sweeps v ∈ {1..4} for SFL-GA plus the SFL
reference on the port's ``FedSimulator`` and reports accuracy after R
rounds, the measured client drift (the Γ proxy of Assumption 4) and the
B1 launches of each run (one a round for sfl_ga on the card).

Run:  PYTHONPATH=src:. python benchmarks/torch_fig3_convergence_vs_cut.py
      [--device cpu] [--rounds R]
"""
from __future__ import annotations

import argparse

from benchmarks.torch_common import (FULL, device_arg, device_name,
                                     run_scheme)
from repro_torch import obs


def run(dataset: str = "mnist", rounds: int = None, device="cuda"):
    rounds = rounds or (150 if FULL else 60)
    out = []
    for cut in (1, 2, 3, 4):
        r = run_scheme("sfl_ga", cut, rounds, dataset, device=device)
        out.append({"scheme": f"sfl_ga_v{cut}", "final_acc": r["final_acc"],
                    "drift": r["drifts"][-1], "launches": r["launches"],
                    "curve": list(zip(r["rounds"], r["accs"]))})
    ref = run_scheme("sfl", 2, rounds, dataset, device=device)
    out.append({"scheme": "sfl_ref", "final_acc": ref["final_acc"],
                "drift": 0.0, "launches": ref["launches"],
                "curve": list(zip(ref["rounds"], ref["accs"]))})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--rounds", type=int, default=None)
    args = ap.parse_args(argv)
    datasets = ["mnist", "fmnist", "cifar10"] if FULL else ["mnist"]
    for ds in datasets:
        obs.log(f"# fig3 dataset={ds} [{device_name(args.device)}]")
        for row in run(ds, args.rounds, args.device):
            obs.log(f"  {row['scheme']}: final_acc={row['final_acc']:.3f} "
                    f"drift={row['drift']:.3e} "
                    f"B1 launches={row['launches']['grad_agg']}")


if __name__ == "__main__":
    main()
