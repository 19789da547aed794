"""Shared summary statistics for latency reporting: a copy of
``repro.obs.stats``.

The linear-interpolation percentile (numpy's default
``method="linear"``), pure stdlib.
"""
from __future__ import annotations

from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile of ``values`` at ``q`` ∈ [0, 1].

    Matches ``np.percentile(values, 100 * q)`` (default linear method):
    the virtual rank ``q * (n - 1)`` interpolates between the two
    nearest order statistics. Empty input returns NaN.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    s = sorted(float(v) for v in values)
    if not s:
        return float("nan")
    if len(s) == 1:
        return s[0]
    rank = q * (len(s) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    frac = rank - lo
    return s[lo] + (s[hi] - s[lo]) * frac
