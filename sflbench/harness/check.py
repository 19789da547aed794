"""The numbers the output check compares, and the verdict.

Readings (of the program and of the reference alike): the losses of the
checked steps, each leaf's first gradient as the optimizer got it (its
first update over lr) and each leaf's change after the checked steps.
The numbers:

* ``loss_gap``   -- max over the checked steps of |L_prog - L_ref| / L_ref;
* ``grad_gap``   -- max over leaves of | ||g_prog|| - ||g_ref|| |, over the
  larger of ||g_ref|| and the median leaf's;
* ``change_gap`` -- the same for the change after the checked steps;
* ``grad_gap_median``, ``change_gap_median`` -- the same gaps, of the
  median leaf instead of the worst: steady from seed to seed where the
  worst leaf is a small one whose gradient is a sum with much
  cancellation (Mamba-2's per-head ``dt_bias``, ``A_log`` and ``D``).

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of both norm numbers. A
leaf missing on one side reads infinity. ``limits/<cell>.json`` gives
each compared number its limit; the run is correct when every compared
number is finite and at most its limit.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict

TINY = 1e-3  # a leaf under this share of the median gradient is left out


def _bare(key: str) -> str:
    return key.split(".", 1)[1]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              ref_grad: Dict[str, float]):
    """Each kept leaf's gap, or None when the leaves differ."""
    if set(prog) != set(ref):
        return None
    grad = {_bare(k): v for k, v in ref_grad.items()}
    med_g = statistics.median(grad.values())
    kept = [k for k in ref if grad[_bare(k)] >= TINY * med_g]
    med = statistics.median(ref[k] for k in kept)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in kept]


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    if len(prog["losses"]) != len(ref["losses"]):
        loss = math.inf
    else:
        loss = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    if not all(math.isfinite(x) for x in prog["losses"]):
        loss = math.inf
    out = {"loss_gap": loss}
    for key in ("grad", "change"):
        gaps = leaf_gaps(prog[key], ref[key], ref["grad"])
        out[f"{key}_gap"] = math.inf if gaps is None else max(gaps)
        out[f"{key}_gap_median"] = (math.inf if gaps is None
                                    else statistics.median(gaps))
    return out


def worst(prog: dict, ref: dict) -> dict:
    """The leaf behind each norm number (for reading a calibration)."""
    out = {}
    for key in ("grad", "change"):
        p, r = prog[key], ref[key]
        if set(p) != set(r):
            out[key] = None
            continue
        med = statistics.median(r.values())
        k = max(r, key=lambda n: abs(p[n] - r[n]) / max(r[n], med))
        out[key] = [k, p[k], r[k], med]
    return out


def verdict(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the limited numbers."""
    shown = {k: {"value": nums[k], "limit": limits[k]}
             for k in sorted(limits) if k in nums}
    ok = bool(shown) and all(math.isfinite(v["value"])
                             and v["value"] <= v["limit"]
                             for v in shown.values())
    return ok, shown
