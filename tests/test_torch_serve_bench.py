"""The port's serving benchmark (``benchmarks/torch_serve_bench.py``)
against the reference's (``benchmarks/serve_bench.py``) on the CPU, both
on the reference's reduced granite-8b.

The schedule is set by integers (no EOS, fixed lengths), so every row's
scheduler, users, slots, tokens and decode steps are the reference's
exactly, and so is the count of traffic events; both sides reconcile
every event (0 mismatches). The port's continuous batching must clear
the reference's gate, >= 2x the sequential baseline's tok/s at equal
slots. The reference's rows (users, tokens, steps): continuous 4/56/47,
8/112/48, 16/224/57; sequential 16/224/188; 342 traffic events.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmarks' namespace package
    sys.path.insert(0, str(ROOT))

from benchmarks import serve_bench as jbench  # noqa: E402
from benchmarks import torch_serve_bench as bench  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

KEYS = ("scheduler", "users", "slots", "tokens", "steps")


def test_port_serve_bench_gives_the_reference_schedule():
    ref = jbench.run()
    got = bench.run(device="cpu")
    assert [tuple(r[k] for k in KEYS) for r in got["rows"]] \
        == [tuple(r[k] for k in KEYS) for r in ref["rows"]] == [
            ("continuous", 4, 4, 56, 47), ("continuous", 8, 4, 112, 48),
            ("continuous", 16, 4, 224, 57), ("sequential", 16, 4, 224, 188)]
    assert got["traffic_events"] == ref["traffic_events"] == 342
    assert got["traffic_mismatches"] == ref["traffic_mismatches"] == 0
    assert got["speedup"] >= 2.0
    # every decode step, the two one-step warm-ups included
    assert got["decode_steps"] == 2 + sum(r["steps"] for r in got["rows"])
    assert got["finite"]
    for r in got["rows"]:
        assert r["p50_s"] <= r["p99_s"] and 0.0 <= r["slo_attainment"] <= 1.0
