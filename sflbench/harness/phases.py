"""Where the traced steps' device time goes, phase by phase of the port's
training step.

The port opens a ``torch.profiler`` range ``repro_torch.<span>`` at each
phase boundary of its step (``repro_torch.obs`` spans):
``client_forward``, ``uplink``, ``server_forward``, ``backward`` (which
holds ``downlink``, run on autograd's own thread on the card) and
``optimizer``, and ``resplit`` at a cut change. :func:`attribute` reads
the Chrome trace of a :class:`harness.trace.Tracer` session:

* each device operation inside the ``sflbench.traced`` window goes to
  the innermost program span (the latest started, on any thread) whose
  host interval holds the launch that queued it: the ``cuda_runtime`` or
  ``cuda_driver`` event of the same ``correlation``. This is self time:
  ``backward`` leaves out the ``downlink`` nested in it;
* each stretch of the window in which no device operation ran goes to
  the innermost program span open on the host then, if any.

What the harness queues outside the step (the batch's copy, the loss's
copy), and idle time while no program span is open, go to no phase. A
trace with no program span, as a program without these spans gives, has
no readings. Every program span name is kept, also one that no reading
here names: ``device_us`` and ``idle_us`` hold them all.

The helpers that ``harness/trace.py`` shares (the Chrome trace's events,
interval union, the innermost open span) live here.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN = "sflbench."  # the benchmark's own spans (``harness.trace.Tracer``)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROGRAM = "repro_torch."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the step's phases, whose device time is the step's; resplit is a cut
# change's
STEP_PHASES = ("client_forward", "uplink", "server_forward", "backward",
               "downlink", "optimizer")


@dataclass
class Phases:
    steps: int
    busy_us: float                   # union of the window's device ops
    window_us: float
    spans: List[Tuple[float, float, str]]  # the program's, (start, end, name)
    device_us: Dict[str, float] = field(default_factory=dict)
    idle_us: Dict[str, float] = field(default_factory=dict)

    def per_step_ms(self, us: float) -> float:
        return us / 1e3 / self.steps

    @property
    def coverage(self) -> float:
        """The step phases' device time over the window's busy time."""
        return sum(self.device_us.get(p, 0.0) for p in STEP_PHASES) \
            / self.busy_us

    def readings(self) -> Dict[str, float]:
        """A step's client forward, server forward, backward (less the
        downlink), boundary (uplink and downlink, in us), optimizer
        device time and device-idle time under any program span; empty
        without program spans."""
        if not self.spans:
            return {}
        dev = self.device_us.get
        ms = self.per_step_ms
        return {
            "client_fwd_ms": ms(dev("client_forward", 0.0)),
            "server_fwd_ms": ms(dev("server_forward", 0.0)),
            "backward_ms": ms(dev("backward", 0.0)),
            "boundary_us": (dev("uplink", 0.0) + dev("downlink", 0.0))
            / self.steps,
            "optimizer_ms": ms(dev("optimizer", 0.0)),
            "program_idle_ms": ms(sum(self.idle_us.values())),
        }


def _union(intervals):
    busy, merged = 0.0, []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for s, e in merged:
        busy += e - s
    return busy, merged


def _innermost(spans, t):
    """The deepest span (start, end, name) open at t, or None."""
    best = None
    for s, e, name in spans:
        if s <= t < e and (best is None or s >= best[0]):
            best = (s, e, name)
    return best


def events(prof) -> list:
    """The Chrome trace events of a finished ``torch.profiler`` session."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def attribute(trace_events: list, steps: int) -> Phases:
    window = None
    spans, dev = [], []
    launches: Dict[int, float] = {}
    for ev in trace_events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            dev.append((s, e, args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = s
        elif cat == "user_annotation":
            if name == SPAN + "traced":
                window = (s, e)
            elif name.startswith(PROGRAM):
                spans.append((s, e, name[len(PROGRAM):]))
    if window is None:
        raise RuntimeError("the trace has no sflbench.traced span")
    t0, t1 = window
    dev = [(max(s, t0), min(e, t1), c) for s, e, c in dev
           if s < t1 and e > t0]
    busy, merged = _union([(s, e) for s, e, _ in dev])
    device_us: Dict[str, float] = defaultdict(float)
    for s, e, corr in dev:
        at = launches.get(corr)
        span = _innermost(spans, at) if at is not None else None
        if span is not None:
            device_us[span[2]] += e - s
    holes = [(merged[k][1], merged[k + 1][0])
             for k in range(len(merged) - 1)]
    holes = [(t0, merged[0][0])] + holes + [(merged[-1][1], t1)] \
        if merged else [(t0, t1)]
    idle_us: Dict[str, float] = defaultdict(float)
    for s, e in holes:
        cuts = sorted({s, e} | {x for sp in spans for x in sp[:2]
                                if s < x < e})
        for a, b in zip(cuts, cuts[1:]):
            span = _innermost(spans, (a + b) / 2)
            if span is not None:
                idle_us[span[2]] += b - a
    return Phases(steps=steps, busy_us=busy, window_us=t1 - t0,
                  spans=spans, device_us=dict(device_us),
                  idle_us=dict(idle_us))
