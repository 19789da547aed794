"""Per-round latency (§IV eq. 29) and the per-token latency of split
decoding: a copy of the parts of ``repro.sysmodel.latency`` that the port
uses.

l_t = max_n { l^U + l^F + l^s } + max_n { l^D + l^B }

chi_t (uplink + client FP + server compute) and psi_t (downlink + client
BP) are the auxiliary variables of P2 (eq. 31). ``chi_terms`` and
``psi_terms`` are backend-agnostic (``sysmodel.backend``): numpy in,
numpy float64 out; a tensor in, a tensor out. ``round_latency`` is a
host-side float summary. The cohort sampler's ``latency`` kind reads
them through ``core.cohort.channel_latency_fn``; the async engine's
per-client completion times come from ``completion_time_fn`` (or the
zero-spread ``constant_completion_fn``), and the closed loop prices a
cut move with ``migration_latency``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.sysmodel.backend import maximum
from repro_torch.sysmodel.comm import CommParams, downlink_rate, uplink_rate
from repro_torch.sysmodel.comp import (CompParams, client_bp_latency,
                                       client_fp_latency, server_latency)


@dataclass
class LatencyModel:
    comm: CommParams
    comp: CompParams
    smashed_bits: float  # X_t(v) in bits
    n_samples_per_client: float  # D^n (mini-batch per round)

    def chi_terms(self, bw, p_tx, gains, f_client, f_server):
        """Per-client uplink + client-FP + server latency (constraint 31b)."""
        r_up = uplink_rate(bw, p_tx, gains, self.comm)
        l_u = self.smashed_bits / maximum(r_up, 1e-9)
        l_f = client_fp_latency(self.n_samples_per_client, self.comp, f_client)
        l_s = server_latency(self.n_samples_per_client, self.comp, f_server)
        return l_u + l_f + l_s

    def psi_terms(self, gains, f_client):
        """Per-client downlink + client-BP latency (constraint 31c)."""
        r_dn = downlink_rate(gains, self.comm)
        l_d = self.smashed_bits / maximum(r_dn, 1e-9)
        l_b = client_bp_latency(self.n_samples_per_client, self.comp, f_client)
        return l_d + l_b


def round_latency(model: LatencyModel, bw, p_tx, gains, f_client,
                  f_server) -> Dict[str, float]:
    chi = float(np.max(model.chi_terms(bw, p_tx, gains, f_client, f_server)))
    psi = float(np.max(model.psi_terms(gains, f_client)))
    return {"chi": chi, "psi": psi, "total": chi + psi}


def token_comm_latency(up_bits: float, down_bits: float, gains,
                       comm: CommParams) -> np.ndarray:
    """Per-user comm latency of ONE decode step: each live user ships
    ``up_bits`` (its boundary activation) on a 1/N sub-band at max power
    and receives ``down_bits`` (the sampled token) on a 1/N share of the
    server's unicast band. ``gains`` covers the step's LIVE users --
    retired slots free their sub-band, so per-token latency improves as
    the batch drains. Returns seconds, shape of ``gains``; the engine
    adds the measured compute latency and checks the sum against the
    per-token SLO."""
    g = np.asarray(gains, np.float64)
    N = max(1, g.shape[-1])
    bw = np.full_like(g, comm.total_bandwidth / N)
    r_up = uplink_rate(bw, comm.client_power, g, comm)
    r_dn = downlink_rate(g, comm) / N
    return (float(up_bits) / np.maximum(r_up, 1e-9)
            + float(down_bits) / np.maximum(r_dn, 1e-9))


def completion_time_fn(n_clients: int, seed: int = 0, *,
                       straggler_factor: float = 4.0,
                       smashed_bits: float = 1e6, batch: int = 32,
                       comm: CommParams = None, comp: CompParams = None):
    """Per-client heterogeneous round-completion times for the async
    engine (``core.async_engine``): ``fn(t) -> (N,)`` seconds.

    Each client's time is its own chi+psi (eq. 29 terms, equal-split
    bandwidth at max power, fresh Rayleigh block fading per ``t``)
    scaled by a fixed per-client compute-speed factor log-spaced over
    ``[1, straggler_factor]`` and permuted by ``seed``: persistent device
    heterogeneity on top of the paper's per-round channel draws. Pure in
    ``(seed, t)``, so a resumed run replays the identical event schedule
    with no stored RNG state (the ``cohort_rng`` contract)."""
    from repro_torch.core.cohort import cohort_rng
    from repro_torch.sysmodel.comm import path_loss_gain

    comm = comm or CommParams()
    comp = comp or CompParams()
    model = LatencyModel(comm, comp, smashed_bits, float(batch))
    rng0 = np.random.RandomState(seed)
    dists = rng0.uniform(0.05, 0.5, n_clients)
    factor = max(float(straggler_factor), 1.0)
    speed = np.exp(np.linspace(0.0, np.log(factor), n_clients))
    speed = speed[rng0.permutation(n_clients)]
    bw = np.full(n_clients, comm.total_bandwidth / n_clients)

    def fn(t: int) -> np.ndarray:
        gains = path_loss_gain(dists, cohort_rng(seed ^ 0x3C3C3C3C, t))
        chi = model.chi_terms(bw, comm.client_power, gains,
                              comp.client_cpu_max, comp.server_cpu_max)
        psi = model.psi_terms(gains, comp.client_cpu_max)
        return np.asarray((chi + psi) * speed, np.float64)

    return fn


def constant_completion_fn(n_clients: int, value: float = 1.0):
    """Zero-spread completion times: every client finishes at ``value``.
    The degenerate schedule under which the async engine's buffered
    merge is the synchronous barrier round."""
    times = np.full(n_clients, float(value), np.float64)

    def fn(t: int) -> np.ndarray:
        return times.copy()

    return fn


def migration_latency(up_bits: float, down_bits: float, gains,
                      comm: CommParams) -> float:
    """Wall-clock cost of a cut migration (per-client bits on each link).

    ``gains`` covers the round's participants (under partial
    participation the K cohort gains: the band is shared K ways). The
    migration happens before the round's P2.1 allocation exists, so
    resources are split equally at max power: uplink clients get B/N
    sub-bands; the downlink is N per-client unicasts sharing the server
    band, each at 1/N of its eq. 11 full-band rate (matching
    ``traffic.migration_bits``). The round stalls until the slowest
    client has uploaded its departing layers and received the arriving
    ones, one phase after the other."""
    if up_bits <= 0 and down_bits <= 0:
        return 0.0
    g = np.asarray(gains, np.float64)
    N = g.shape[-1]
    bw = np.full(N, comm.total_bandwidth / N)
    t_up = 0.0
    if up_bits > 0:
        r_up = uplink_rate(bw, comm.client_power, g, comm)
        t_up = float(np.max(up_bits / np.maximum(r_up, 1e-9)))
    t_dn = 0.0
    if down_bits > 0:
        r_dn = downlink_rate(g, comm) / N  # equal share of N unicasts
        t_dn = float(np.max(down_bits / np.maximum(r_dn, 1e-9)))
    return t_up + t_dn
