"""Fig. 4 on the port — communication overhead vs test accuracy across
schemes.

Paper claim: SFL-GA reaches a given accuracy with far less traffic than
traditional SFL; PSL sits between (no client-model aggregation, but
per-client gradient unicast).

All traffic numbers come from the port's ``sysmodel.traffic`` (the
simulator's ``comm_bytes_per_round`` is a thin adapter over it, checked
equal here); the codec-projection table at the end prices the same
workload under int8/int4 transports without retraining.

Run:  PYTHONPATH=src:. python benchmarks/torch_fig4_comm_overhead.py
      [--device cpu] [--rounds R]
"""
from __future__ import annotations

import argparse

from benchmarks.torch_common import (FULL, device_arg, device_name,
                                     run_scheme)
from repro_torch import obs


def unified_traffic(scheme: str, cut: int, codec: str = "fp32",
                    n_clients: int = 10, batch: int = 16,
                    tau: int = 1) -> dict:
    """Per-round bytes straight from sysmodel.traffic (no simulator)."""
    from repro_torch.configs.paper_cnn import LIGHT_CONFIG
    from repro_torch.models import cnn
    from repro_torch.sysmodel.traffic import round_traffic_bytes

    cfg = LIGHT_CONFIG
    split = scheme != "fl"
    return round_traffic_bytes(
        scheme, n_clients=n_clients, tau=tau,
        smashed_elems=cnn.smashed_numel(cfg, cut) * batch if split else 0,
        label_bits=batch * 32,
        client_model_bits=cnn.phi(cfg, cut) * 32 if split else 0,
        full_model_bits=cnn.total_params(cfg) * 32,
        uplink_codec=codec, downlink_codec=codec)


def run(dataset: str = "mnist", rounds: int = None, device="cuda"):
    rounds = rounds or (150 if FULL else 60)
    out = []
    for scheme in ("sfl_ga", "psl", "sfl", "fl"):
        r = run_scheme(scheme, 2, rounds, dataset, device=device)
        per_round = r["comm"]["total_bytes"]
        unified = unified_traffic(scheme, 2)["total_bytes"]
        if per_round != unified:
            raise RuntimeError(f"{scheme}: simulator prices {per_round} B "
                               f"a round, sysmodel.traffic {unified}")
        curve = [(per_round * rr / 1e6, a) for rr, a in zip(r["rounds"],
                                                            r["accs"])]
        out.append({"scheme": scheme, "mb_per_round": per_round / 1e6,
                    "final_acc": r["final_acc"], "mb_acc_curve": curve,
                    "launches": r["launches"]})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--rounds", type=int, default=None)
    args = ap.parse_args(argv)
    datasets = ["mnist", "fmnist", "cifar10"] if FULL else ["mnist"]
    for ds in datasets:
        obs.log(f"# fig4 dataset={ds} [{device_name(args.device)}]")
        rows = run(ds, args.rounds, args.device)
        for row in rows:
            obs.log(f"  {row['scheme']}: {row['mb_per_round']:.3f} MB/round, "
                    f"final_acc={row['final_acc']:.3f}, "
                    f"B1 launches={row['launches']['grad_agg']}")
        # traffic to reach 90% of the best final accuracy
        target = 0.9 * max(r["final_acc"] for r in rows)
        for row in rows:
            hit = next((mb for mb, a in row["mb_acc_curve"] if a >= target),
                       None)
            obs.log(f"  {row['scheme']}: MB to reach acc {target:.3f}: "
                    f"{'%.2f' % hit if hit else 'not reached'}")
    # codec projection: the same workload priced under compressed
    # transports (sysmodel.traffic directly; cut-layer payloads only)
    obs.log("# codec projection (MB/round, cut=2)")
    for scheme in ("sfl_ga", "psl", "sfl"):
        row = {c: unified_traffic(scheme, 2, c)["total_bytes"] / 1e6
               for c in ("fp32", "int8", "int4")}
        obs.log(f"  {scheme}: " + "  ".join(
            f"{c}={v:.3f}" for c, v in row.items()))


if __name__ == "__main__":
    main()
