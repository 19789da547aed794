"""Fig. 8 on the port — per-round latency vs total bandwidth, per scheme.

Paper claim: all schemes speed up with bandwidth; SFL-GA is lowest
(broadcast downlink + no model aggregation); SFL slightly above PSL
(client-model aggregation traffic); FL worst (full-model exchange +
on-device training). ``--backend torch`` solves each P2.1 with the
batched solver on the device in f32 instead of the scalar numpy solver.

Run:  PYTHONPATH=src:. python benchmarks/torch_fig8_latency_vs_bandwidth.py
      [--backend numpy|torch] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from benchmarks.torch_common import device_arg, device_name, solve_round
from repro_torch import obs
from repro_torch.configs.paper_cnn import LIGHT_CONFIG
from repro_torch.models import cnn
from repro_torch.sysmodel.comm import (CommParams, downlink_rate,
                                       path_loss_gain, uplink_rate)
from repro_torch.sysmodel.comp import CompParams

BANDWIDTHS = (5e6, 10e6, 20e6, 40e6)


def _lat(scheme: str, comm: CommParams, gains, cut=2, batch=16,
         backend: str = "numpy", device="cuda") -> float:
    comp = CompParams()
    N = len(gains)
    if scheme == "fl":
        w = (comp.client_fwd_flops + comp.client_bwd_flops
             + comp.server_fwd_flops + comp.server_bwd_flops)
        t_comp = batch * w / comp.client_cpu_max
        q_bits = cnn.total_params(LIGHT_CONFIG) * 32
        bw = np.full(N, comm.total_bandwidth / N)
        r_up = uplink_rate(bw, np.full(N, comm.client_power), gains, comm)
        return t_comp + float(np.max(q_bits / r_up)) \
            + float(np.max(q_bits / downlink_rate(gains, comm)))
    X_bits = cnn.smashed_numel(LIGHT_CONFIG, cut) * batch * 32
    lat = solve_round(gains, X_bits, batch, comm, comp, backend,
                      device)["total"]
    if scheme == "psl":
        # unicast downlink instead of single broadcast: N gradient payloads
        # share the band — approximate as N sequential broadcasts
        r_dn = downlink_rate(gains, comm)
        lat += (N - 1) * float(np.max(X_bits / r_dn))
    if scheme == "sfl":
        r_dn = downlink_rate(gains, comm)
        lat += (N - 1) * float(np.max(X_bits / r_dn))
        phi_bits = cnn.phi(LIGHT_CONFIG, cut) * 32
        bw = np.full(N, comm.total_bandwidth / N)
        r_up = uplink_rate(bw, np.full(N, comm.client_power), gains, comm)
        lat += float(np.max(phi_bits / r_up)) \
            + float(np.max(phi_bits / downlink_rate(gains, comm)))
    return lat


def run(backend: str = "numpy", device="cuda"):
    rng = np.random.RandomState(0)
    gains = path_loss_gain(rng.uniform(0.05, 0.5, 10), rng)
    rows = []
    for bw in BANDWIDTHS:
        comm = CommParams(total_bandwidth=bw)
        rows.append({"bandwidth_mhz": bw / 1e6,
                     **{s: _lat(s, comm, gains, backend=backend,
                                device=device)
                        for s in ("sfl_ga", "psl", "sfl", "fl")}})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("numpy", "torch"), default="numpy")
    device_arg(ap)
    args = ap.parse_args(argv)
    obs.log(f"# fig8 latency (s/round) vs bandwidth (MHz), P2.1 "
            f"{args.backend} [{device_name(args.device)}]")
    obs.log("  MHz, sfl_ga, psl, sfl, fl")
    for row in run(args.backend, args.device):
        obs.log(f"  {row['bandwidth_mhz']:.0f}, {row['sfl_ga']:.3f}, "
                f"{row['psl']:.3f}, {row['sfl']:.3f}, {row['fl']:.3f}")


if __name__ == "__main__":
    main()
