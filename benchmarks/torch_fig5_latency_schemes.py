"""Fig. 5 on the port — accuracy vs wall-clock latency across schemes.

Latency per round comes from the wireless system model (eq. 29) with
optimal resource allocation (P2.1); FL pays full-model on-device compute
(the paper's point: it is slowest to converge in wall-clock). Training
runs on the port's ``FedSimulator`` (B1 a round for sfl_ga on the card);
``--backend torch`` solves P2.1 with the batched solver on the device in
f32 instead of the scalar numpy solver.

Run:  PYTHONPATH=src:. python benchmarks/torch_fig5_latency_schemes.py
      [--backend numpy|torch] [--device cpu] [--rounds R]
"""
from __future__ import annotations

import argparse

import numpy as np

from benchmarks.torch_common import (FULL, device_arg, device_name,
                                     run_scheme, solve_round)
from repro_torch import obs


def _round_latency(scheme: str, cut: int, seed: int = 0,
                   backend: str = "numpy", device="cuda") -> float:
    """Expected per-round latency under the paper's §V-A system constants."""
    from repro_torch.configs.paper_cnn import LIGHT_CONFIG
    from repro_torch.models import cnn
    from repro_torch.sysmodel.comm import (CommParams, downlink_rate,
                                           path_loss_gain, uplink_rate)
    from repro_torch.sysmodel.comp import CompParams

    rng = np.random.RandomState(seed)
    gains = path_loss_gain(rng.uniform(0.05, 0.5, 10), rng)
    comm, comp = CommParams(), CompParams()
    batch = 16
    if scheme == "fl":
        # full model on client CPU + model exchange, no split
        w = (comp.client_fwd_flops + comp.client_bwd_flops
             + comp.server_fwd_flops + comp.server_bwd_flops)
        t_comp = batch * w / comp.client_cpu_max
        q_bits = cnn.total_params(LIGHT_CONFIG) * 32
        bw = np.full(10, comm.total_bandwidth / 10)
        r_up = uplink_rate(bw, np.full(10, comm.client_power), gains, comm)
        t_up = float(np.max(q_bits / r_up))
        t_dn = float(np.max(q_bits / downlink_rate(gains, comm)))
        return t_comp + t_up + t_dn
    X_bits = cnn.smashed_numel(LIGHT_CONFIG, cut) * batch * 32
    lat = solve_round(gains, X_bits, batch, comm, comp, backend,
                      device)["total"]
    if scheme == "sfl":  # client-model aggregation round-trips
        phi_bits = cnn.phi(LIGHT_CONFIG, cut) * 32
        bw = np.full(10, comm.total_bandwidth / 10)
        r_up = uplink_rate(bw, np.full(10, comm.client_power), gains, comm)
        lat += float(np.max(phi_bits / r_up)) \
            + float(np.max(phi_bits / downlink_rate(gains, comm)))
    return lat


def run(dataset: str = "mnist", rounds: int = None, backend: str = "numpy",
        device="cuda"):
    rounds = rounds or (150 if FULL else 60)
    out = []
    for scheme in ("sfl_ga", "sfl", "psl", "fl"):
        r = run_scheme(scheme, 2, rounds, dataset, device=device)
        lat = _round_latency(scheme, 2, backend=backend, device=device)
        out.append({"scheme": scheme, "latency_per_round_s": lat,
                    "final_acc": r["final_acc"], "launches": r["launches"],
                    "time_acc_curve": [(lat * rr, a) for rr, a in
                                       zip(r["rounds"], r["accs"])]})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("numpy", "torch"), default="numpy")
    device_arg(ap)
    ap.add_argument("--rounds", type=int, default=None)
    args = ap.parse_args(argv)
    obs.log(f"# fig5 accuracy vs latency (mnist, P2.1 {args.backend}) "
            f"[{device_name(args.device)}]")
    for row in run(rounds=args.rounds, backend=args.backend,
                   device=args.device):
        obs.log(f"  {row['scheme']}: {row['latency_per_round_s']:.3f} "
                f"s/round, final_acc={row['final_acc']:.3f}, "
                f"time_to_final={row['time_acc_curve'][-1][0]:.1f}s, "
                f"B1 launches={row['launches']['grad_agg']}")


if __name__ == "__main__":
    main()
