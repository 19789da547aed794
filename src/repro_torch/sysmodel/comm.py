"""Wireless communication model (§II-C, eqs. 10-11): a copy of
``repro.sysmodel.comm``.

Uplink: orthogonal sub-channels, per-client bandwidth B^n, rate eq. (10).
Downlink: full-band transmission at server power P, rate eq. (11).
Channel: path loss 128.1 + 37.6 log10(d_km) dB with Rayleigh fading.

Backend-agnostic (``sysmodel.backend``): numpy in, numpy float64 out (the
parity oracle); a torch tensor in, a tensor out on its device and dtype
(the batched P2.1 solver and the batched env).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.sysmodel.backend import array_namespace, as_f64_if_np, maximum


@dataclass(frozen=True)
class CommParams:
    total_bandwidth: float = 20e6  # B (Hz)
    noise_psd_dbm: float = -174.0  # N0 (dBm/Hz)
    client_power_dbm: float = 25.0  # p_max^n
    server_power_dbm: float = 33.0  # P

    @property
    def noise_psd(self) -> float:
        return 10 ** ((self.noise_psd_dbm - 30) / 10)

    @property
    def client_power(self) -> float:
        return 10 ** ((self.client_power_dbm - 30) / 10)

    @property
    def server_power(self) -> float:
        return 10 ** ((self.server_power_dbm - 30) / 10)


def path_loss_linear(d_km):
    """Deterministic linear gain from the 128.1 + 37.6 log10(d) dB model.
    Fading is the caller's job (numpy ``RandomState`` in
    ``path_loss_gain``, a torch generator in the batched env)."""
    xp = array_namespace(d_km)
    pl_db = 128.1 + 37.6 * xp.log10(maximum(d_km, 1e-3))
    return 10 ** (-pl_db / 10)


def path_loss_gain(d_km: np.ndarray, rng: np.random.RandomState = None) -> np.ndarray:
    """Linear channel gain: 128.1 + 37.6 log10(d) dB path loss × Rayleigh."""
    g = path_loss_linear(d_km)
    if rng is not None:
        ray = rng.exponential(1.0, size=np.shape(d_km))  # |h|^2 ~ Exp(1)
        g = g * ray
    return g


def uplink_rate(bw, power, gain, p: CommParams):
    """eq. (10): r = B^n log2(1 + p g / (B^n N0)). Safe at bw -> 0."""
    xp = array_namespace(bw, power, gain)
    bw = maximum(as_f64_if_np(bw, xp), 1e-9)
    snr = power * gain / (bw * p.noise_psd)
    return bw * xp.log2(1.0 + snr)


def downlink_rate(gain, p: CommParams):
    """eq. (11): full-band transmission from the server."""
    xp = array_namespace(gain)
    snr = p.server_power * gain / (p.total_bandwidth * p.noise_psd)
    return p.total_bandwidth * xp.log2(1.0 + snr)
