"""Shared helpers for the port's paper-figure runs (``torch_fig*.py``):
the port's counterparts of ``benchmarks/common.py`` on ``repro_torch``.

The runs default to the LIGHT CNN (the reference's benchmark default,
same V=5 structure) and the reference's round counts; set
REPRO_BENCH_FULL=1 for its paper-scale settings. Everything runs on the
card unless ``--device cpu`` is passed; the eq. 5 aggregation and the
int codecs are then the kernels' plain versions. These figures train
the full cohort on IID partitions; ``torch_fig11_scale.py`` runs the
cohort samplers and the client banks.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np

FULL = bool(int(os.environ.get("REPRO_BENCH_FULL", "0")))


def device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")


def device_name(device) -> str:
    """The device a run's numbers come from (the card's name on CUDA)."""
    import torch

    from repro_torch import require_device

    dev = require_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def kernel_launches() -> Dict[str, int]:
    """B1/B2/B3 launch counters (CUDA launches only; the CPU's plain
    versions count none)."""
    from repro_torch.kernels import grad_agg as ga
    from repro_torch.kernels import quantize as qz

    return {"grad_agg": ga.grad_agg_reduce.launches,
            "quantize": qz.quantize_pack.launches,
            "dequant_agg": qz.dequant_agg_reduce.launches}


def fed_setup(dataset: str = "mnist", n: int = 2400, n_clients: int = 10,
              seed: int = 0):
    from repro_torch.data import (iid_partition, make_image_dataset,
                                  rho_weights)

    ds = make_image_dataset(dataset, n=n, seed=seed)
    train, test = ds.split(0.9, seed=seed)
    parts = iid_partition(len(train.x), n_clients, seed=seed)
    return train, test, parts, rho_weights(parts)


def run_scheme(scheme: str, cut: int, rounds: int, dataset: str = "mnist",
               n_clients: int = 10, batch: int = 16, tau: int = 1,
               lr: float = 0.05, eval_every: int = 20, seed: int = 0,
               uplink_codec: str = "fp32", downlink_codec: str = "fp32",
               device="cuda") -> Dict:
    """Train one scheme on the port's simulator; returns the accuracy
    curve, the comm accounting and the run's B1/B2/B3 launches."""
    from repro_torch.configs.paper_cnn import LIGHT_CONFIG
    from repro_torch.core.simulator import FedSimulator, SimConfig
    from repro_torch.data import round_batches

    train, test, parts, rho = fed_setup(dataset, n_clients=n_clients,
                                        seed=seed)
    sim = FedSimulator(LIGHT_CONFIG,
                       SimConfig(scheme=scheme, cut=cut, n_clients=n_clients,
                                 batch=batch, tau=tau, lr=lr,
                                 uplink_codec=uplink_codec,
                                 downlink_codec=downlink_codec),
                       rho=rho, seed=seed, device=device)
    rng = np.random.RandomState(seed)
    before = kernel_launches()
    accs, rounds_axis, losses, drifts = [], [], [], []
    for r in range(rounds):
        idx, _ = sim.cohort_for_round(sim._t)
        xs, ys = round_batches(train, parts, batch, tau, rng, idx=idx)
        m = sim.run_round(xs, ys)
        losses.append(m["loss"])
        drifts.append(m["client_drift"])
        if (r + 1) % eval_every == 0 or r == rounds - 1:
            accs.append(sim.evaluate(test.x, test.y))
            rounds_axis.append(r + 1)
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    cb = sim.comm_bytes_per_round()
    # plain-SGD training oscillates; report the mean of the last few evals
    tail = accs[-3:] if len(accs) >= 3 else accs
    return {"scheme": scheme, "cut": cut, "accs": accs, "rounds": rounds_axis,
            "losses": losses, "drifts": drifts, "comm": cb,
            "comm_bits": sim.comm_bits_per_round(),
            "final_acc": float(np.mean(tail)), "launches": launches}


def solve_round(gains, X_bits: float, n_samples: float, comm, comp,
                backend: str = "numpy", device="cuda") -> Dict[str, float]:
    """One round's P2.1 solve: the scalar numpy ``solve_p21``, or the
    batched solver (``backend="torch"``) on ``device`` in f32 as one
    row."""
    if backend == "numpy":
        from repro_torch.ccc.convex import solve_p21

        r = solve_p21(gains, X_bits, n_samples, comm, comp)
        return {"chi": r.chi, "psi": r.psi, "total": r.total}
    import torch

    from repro_torch import require_device
    from repro_torch.ccc.convex import solve_p21_batched

    dev = require_device(device)
    r = solve_p21_batched(
        torch.tensor(np.asarray(gains)[None], dtype=torch.float32,
                     device=dev),
        torch.tensor([X_bits], dtype=torch.float32, device=dev),
        float(n_samples), comm, comp)
    chi, psi = float(r.chi[0]), float(r.psi[0])
    return {"chi": chi, "psi": psi, "total": chi + psi}

