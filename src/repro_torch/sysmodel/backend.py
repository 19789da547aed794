"""Array dispatch for the system model: the port's copy of
``repro.sysmodel.backend``, with torch in place of jax.numpy.

The wireless/compute formulas in ``comm`` and ``comp`` serve two callers:
the host-side numpy oracle (``ccc.convex.solve_p21``, the scalar env,
the benchmarks -- float64, eager) and the batched P2.1 solver on torch
tensors (``ccc.convex.solve_p21_batched``, f32 on the card). They stay
single-sourced by dispatching on input type: numpy in, numpy float64 out;
a torch tensor in, a tensor out on the input's device and dtype.
"""
from __future__ import annotations

import numpy as np
import torch


def array_namespace(*xs):
    """numpy for numpy/scalar inputs; torch if ANY input is a tensor."""
    return torch if any(isinstance(x, torch.Tensor) for x in xs) else np


def as_f64_if_np(x, xp):
    """The numpy path computes in float64 (it is the parity oracle); the
    torch path keeps the caller's dtype (f32 on the card)."""
    return np.asarray(x, np.float64) if xp is np else x


def maximum(x, floor: float):
    """``np.maximum(x, floor)``; ``clamp_min`` on a tensor (torch's
    ``maximum`` takes no Python scalar)."""
    if isinstance(x, torch.Tensor):
        return x.clamp_min(floor)
    return np.maximum(x, floor)
