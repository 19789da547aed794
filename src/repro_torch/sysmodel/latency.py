"""Per-token communication latency of split decoding: the serving part
of ``repro.sysmodel.latency``, copied (numpy)."""
from __future__ import annotations

import numpy as np

from repro_torch.sysmodel.comm import CommParams, downlink_rate, uplink_rate


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
