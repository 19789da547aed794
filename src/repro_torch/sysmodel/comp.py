"""Computation model (§II-D, eqs. 14-16) and §V-A constants: a copy of
``repro.sysmodel.comp``.

Backend-agnostic (``sysmodel.backend``): the latency formulas accept
numpy or torch inputs and answer in kind. ``CompParams``/``scale_by_cut``
also take tensor-valued FLOP fields (shape ``(B, 1)``), so one dataclass
describes a whole batch of per-cut workload splits inside the batched
P2.1 solver.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.sysmodel.backend import maximum


@dataclass(frozen=True)
class CompParams:
    client_cpu_max: float = 0.1e9  # f_max^{n,c}: 0.1 GHz (paper §V-A)
    server_cpu_max: float = 100e9  # f_max^s: 100 GHz total
    # workload per sample (FLOPs) — §V-A: client 5.6 MFLOPs, server 86.01
    client_fwd_flops: float = 5.6e6
    client_bwd_flops: float = 5.6e6
    server_fwd_flops: float = 86.01e6
    server_bwd_flops: float = 86.01e6
    flops_per_cycle: float = 1.0  # CPU-cycle model: latency = FLOPs / f


def scale_by_cut(base: "CompParams", frac_client) -> "CompParams":
    """Re-split the total per-sample workload by the cutting point: the
    paper's γ^n(v)/γ^s(v). frac_client = fraction of total FLOPs below v
    (a float, or a ``(B, 1)`` array or tensor for a batch of cuts)."""
    total_f = base.client_fwd_flops + base.server_fwd_flops
    total_b = base.client_bwd_flops + base.server_bwd_flops
    return CompParams(
        client_cpu_max=base.client_cpu_max,
        server_cpu_max=base.server_cpu_max,
        client_fwd_flops=total_f * frac_client,
        client_bwd_flops=total_b * frac_client,
        server_fwd_flops=total_f * (1 - frac_client),
        server_bwd_flops=total_b * (1 - frac_client),
        flops_per_cycle=base.flops_per_cycle,
    )


def client_fp_latency(n_samples, comp: CompParams, f_client):
    """eq. (14)."""
    return n_samples * comp.client_fwd_flops / (maximum(f_client, 1e-3)
                                                * comp.flops_per_cycle)


def server_latency(n_samples, comp: CompParams, f_server):
    """eq. (15): server FP + BP."""
    w = comp.server_fwd_flops + comp.server_bwd_flops
    return n_samples * w / (maximum(f_server, 1e-3) * comp.flops_per_cycle)


def client_bp_latency(n_samples, comp: CompParams, f_client):
    """eq. (16)."""
    return n_samples * comp.client_bwd_flops / (maximum(f_client, 1e-3)
                                                * comp.flops_per_cycle)
