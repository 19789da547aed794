"""The traced sub-window: torch.profiler over a few steps, read back.

:class:`Tracer` wraps the harness's own calls in ``record_function``
spans (``sflbench.batch``, ``sflbench.step``, ``sflbench.loss_copy``,
``sflbench.migration``, and ``sflbench.traced`` around the whole
sub-window) and profiles the host and the device. :func:`read` exports
the Chrome trace the profiler writes (under ``TMPDIR``; deleted once
read) once, after the profiled steps, into a :class:`Trace`: every
device operation (kernels, copies, sets) inside the sub-window, the
union of their intervals (busy time), the program's phases
(``harness.phases.attribute`` over the same events: device and idle time
by each ``repro_torch.<span>``), and the longest idle gaps, each named
``<harness span>/<program span>/<host op>`` by what was open at its
midpoint.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from harness.phases import (DEVICE_CATS, SPAN, Phases, _innermost, _union,
                            attribute, events)


@dataclass
class Trace:
    kernels: List[Tuple[str, float, float]]  # (name, start_us, dur_us)
    window_us: Tuple[float, float]
    busy_us: float
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    steps: int = 0
    phases: Optional[Phases] = None

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        by: Dict[str, float] = defaultdict(float)
        for name, _, dur in self.kernels:
            by[name] += dur / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]


class Tracer:
    """Spans while tracing, nothing otherwise. ``cuda`` False profiles
    the host alone (the CPU tests)."""

    def __init__(self, cuda: bool = True):
        self.prof = None
        self.cuda = cuda

    def span(self, name: str):
        if self.prof is None:
            return nullcontext()
        import torch

        return torch.profiler.record_function(SPAN + name)

    @contextmanager
    def session(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=acts) as prof:
            self.prof = prof
            try:
                with torch.profiler.record_function(SPAN + "traced"):
                    yield
                    if self.cuda:
                        torch.cuda.synchronize()
            finally:
                self.prof = None
        self.last = prof

    def warm(self):
        """Start and stop the profiler once, so that its first start (the
        CUPTI set-up) falls in the set-up."""
        import torch

        with self.session():
            torch.zeros(1, device="cuda" if self.cuda else "cpu").add_(1)
        self.last = None


def read(prof, steps: int, gaps: int = 10) -> Trace:
    evs = events(prof)
    window = None
    spans, ops, dev = [], [], []
    for ev in evs:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((name, s, e - s))
        elif cat == "user_annotation" and name.startswith(SPAN):
            if name == SPAN + "traced":
                window = (s, e)
            else:
                spans.append((s, e, name[len(SPAN):]))
        elif cat == "cpu_op":
            ops.append((s, e, name))
    if window is None:
        raise RuntimeError("the trace has no sflbench.traced span")
    phases = attribute(evs, steps)
    t0, t1 = window
    dev = [(n, max(s, t0), min(s + d, t1) - max(s, t0))
           for n, s, d in dev if s < t1 and s + d > t0]
    busy, merged = _union([(s, s + d) for _, s, d in dev])
    holes = [(merged[k][1], merged[k + 1][0])
             for k in range(len(merged) - 1)]
    if merged:
        holes = [(t0, merged[0][0])] + holes + [(merged[-1][1], t1)]
    holes = sorted(holes, key=lambda h: h[0] - h[1])[:gaps]
    ops.sort()
    starts = [o[0] for o in ops]
    named = []
    for s, e in holes:
        mid = (s + e) / 2
        span = _innermost(spans, mid)
        inner = _innermost(phases.spans, mid)
        k = bisect.bisect_right(starts, mid)
        near = [o for o in ops[max(0, k - 2000):k] if o[1] > mid]
        op = max(near, key=lambda o: o[0])[2] if near else None
        label = "/".join([span[2] if span else "between_spans"]
                         + [x for x in (inner and inner[2], op) if x])
        named.append((label, (e - s) / 1e6))
    return Trace(kernels=dev, window_us=window, busy_us=busy, gaps=named,
                 steps=steps, phases=phases)
