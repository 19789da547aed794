"""Privacy model (§II-E, eq. 17): log(1 + φ(v)/q) >= ε. A copy of
``repro.sysmodel.privacy``.

A deeper cut (bigger client-side model) makes input reconstruction from
smashed data harder, so the constraint lower-bounds φ(v).
"""
from __future__ import annotations

import numpy as np


def privacy_leakage(phi_v: float, q: float) -> float:
    """The privacy score log(1 + φ(v)/q) — larger is more private."""
    return float(np.log1p(phi_v / q))


def privacy_ok(phi_v: float, q: float, epsilon: float) -> bool:
    """eq. (17) / constraint (30e)."""
    return privacy_leakage(phi_v, q) >= epsilon


def min_cut_for_privacy(phis, q: float, epsilon: float):
    """Smallest v whose φ(v) satisfies eq. (17); None if infeasible."""
    for v, phi_v in enumerate(phis, start=1):
        if privacy_ok(phi_v, q, epsilon):
            return v
    return None
