"""Cohort statistics: the part of ``repro.core.cohort`` that the
simulator's identity cohort needs (``cohort_stats`` for the per-round
``cohort`` event). The samplers themselves -- partial participation --
come with the client bank in a later slice. Pure numpy.
"""
from __future__ import annotations

import numpy as np


def cohort_stats(idx, w, n_clients: int) -> dict:
    """Summarize one round's cohort for the obs event stream: who
    participated, how far the Horvitz-Thompson weights are from the
    uniform 1/K, and how much of the bank the round touched. Pure
    numpy so recorders can call it per round for free."""
    idx = np.asarray(idx)
    w = np.asarray(w, np.float64)
    return {
        "participants": [int(i) for i in idx],
        "k": int(idx.size),
        "n_clients": int(n_clients),
        "distinct": int(np.unique(idx).size),
        "bank_fraction": float(np.unique(idx).size / max(n_clients, 1)),
        "w_sum": float(w.sum()),
        "w_min": float(w.min()) if w.size else 0.0,
        "w_max": float(w.max()) if w.size else 0.0,
        "w_mean": float(w.mean()) if w.size else 0.0,
    }
