"""Per-round latency (§IV eq. 29) and the per-token latency of split
decoding: a copy of the parts of ``repro.sysmodel.latency`` that the port
uses.

l_t = max_n { l^U + l^F + l^s } + max_n { l^D + l^B }

chi_t (uplink + client FP + server compute) and psi_t (downlink + client
BP) are the auxiliary variables of P2 (eq. 31). ``chi_terms`` and
``psi_terms`` are backend-agnostic (``sysmodel.backend``): numpy in,
numpy float64 out; a tensor in, a tensor out. ``round_latency`` is a
host-side float summary. The cohort sampler's ``latency`` kind reads
them through ``core.cohort.channel_latency_fn``.
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
