"""The traffic ledger: bits that ACTUALLY crossed each protocol boundary.

A copy of ``repro.obs.ledger``. ``sysmodel/traffic.py`` *predicts*
traffic from closed-form structure; this ledger *measures* it: the code
that really ran a transport op adds the bits of the payload it really
produced, and per step the two are reconciled category by category. Any
divergence is a pricing bug in one of them.

Pure stdlib; the categories and event fields are the reference's, so the
reference's report CLI reads the port's metrics directory as it is.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Tuple

# One category per priced flow. ``up_*`` ride the client→server link,
# ``down_*`` the server→client link; the migration categories cover
# set_cut boundary moves (priced outside the round's protocol traffic).
LEDGER_CATEGORIES: Tuple[str, ...] = (
    "up_smashed",   # per-participant smashed-data payloads X(v)
    "up_labels",    # labels riding the uplink, uncompressed
    "up_model",     # client-model sync up (sfl φ, fl q)
    "up_adapter",   # PEFT adapter sync up (lora φ̂ — DESIGN.md §17)
    "up_activation",  # split-inference boundary activations (DESIGN.md §18)
    "down_grad",    # cut-layer gradients (ONE broadcast for sfl_ga)
    "down_model",   # client-model sync down (sfl φ, fl q)
    "down_adapter",  # PEFT adapter sync down
    "down_token",   # split-inference sampled token ids back to the user
)
UP_CATEGORIES: Tuple[str, ...] = ("up_smashed", "up_labels", "up_model",
                                  "up_adapter", "up_activation")
DOWN_CATEGORIES: Tuple[str, ...] = ("down_grad", "down_model",
                                    "down_adapter", "down_token")


class TrafficLedger:
    """Thread-safe per-category bit counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bits: Dict[str, int] = {c: 0 for c in LEDGER_CATEGORIES}

    def add(self, category: str, bits: int) -> None:
        if category not in self._bits:
            raise KeyError(f"unknown ledger category {category!r}; "
                           f"known: {LEDGER_CATEGORIES}")
        with self._lock:
            self._bits[category] += int(bits)

    def peek(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._bits)

    def snapshot_and_reset(self) -> Dict[str, int]:
        """Atomically read-and-zero — called at each round boundary so
        every round's taps land in exactly one snapshot."""
        with self._lock:
            snap = dict(self._bits)
            for c in self._bits:
                self._bits[c] = 0
        return snap


def totals(bits: Dict[str, int]) -> Dict[str, int]:
    """Collapse a category dict to the up/down/total view of
    ``sysmodel.traffic.round_traffic_bits``."""
    up = sum(bits.get(c, 0) for c in UP_CATEGORIES)
    down = sum(bits.get(c, 0) for c in DOWN_CATEGORIES)
    return {"up_bits": up, "down_bits": down, "total_bits": up + down}


def reconcile(measured: Dict[str, int],
              modeled: Dict[str, int]) -> List[Dict[str, int]]:
    """Diff two category dicts; returns one row per category that
    DISAGREES (empty list = the prices check out exactly)."""
    rows = []
    for c in sorted(set(measured) | set(modeled)):
        m, p = int(measured.get(c, 0)), int(modeled.get(c, 0))
        if m != p:
            rows.append({"category": c, "measured_bits": m,
                         "modeled_bits": p, "delta_bits": m - p})
    return rows


def reconcile_events(events: Iterable[dict]) -> Tuple[List[dict], int]:
    """Run the reconciliation over a decoded event stream.

    Consumes ``kind == "traffic"`` (per-round protocol ledger vs
    ``round_traffic_breakdown``) and ``kind == "migration"`` (actual
    moved parameters vs ``migration_bits``) events. Returns
    ``(rows, n_mismatched)`` where each row summarizes one event:
    round, scheme/cut context, measured/modeled totals and the exact
    per-category mismatches (empty when the event reconciles).
    """
    rows: List[dict] = []
    bad = 0
    for ev in events:
        kind = ev.get("kind")
        if kind not in ("traffic", "migration"):
            continue
        measured = ev.get("measured") or {}
        modeled = ev.get("modeled") or {}
        mism = reconcile(measured, modeled)
        rows.append({
            "kind": kind, "round": ev.get("round"),
            "scheme": ev.get("scheme"), "cut": ev.get("cut"),
            "measured": totals(measured) if kind == "traffic" else measured,
            "modeled": totals(modeled) if kind == "traffic" else modeled,
            "mismatches": mism,
        })
        bad += bool(mism)
    return rows, bad
