"""Wireless communication model (§II-C, eqs. 10-11): a numpy copy of
``repro.sysmodel.comm``.

Uplink: orthogonal sub-channels, per-client bandwidth B^n, rate eq. (10).
Downlink: full-band transmission at server power P, rate eq. (11).
Channel: path loss 128.1 + 37.6 log10(d_km) dB with Rayleigh fading.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
    """Deterministic linear gain from the 128.1 + 37.6 log10(d) dB model."""
    pl_db = 128.1 + 37.6 * np.log10(np.maximum(d_km, 1e-3))
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
    bw = np.maximum(np.asarray(bw, np.float64), 1e-9)
    snr = power * gain / (bw * p.noise_psd)
    return bw * np.log2(1.0 + snr)


def downlink_rate(gain, p: CommParams):
    """eq. (11): full-band transmission from the server."""
    snr = p.server_power * gain / (p.total_bandwidth * p.noise_psd)
    return p.total_bandwidth * np.log2(1.0 + snr)
