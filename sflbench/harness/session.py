"""One run of a cell: set-up with the checked steps, the measured window,
the output check and the metrics.

* :func:`setup` makes the weights from the seed, builds the program's one
  training object (``program.Trainer``) and drives it through the set-up
  steps of the traffic's schedule, the window's own call and feed. The
  first ``CHECKED`` steps are recorded: their losses, each leaf's first
  update over lr (the first gradient as sgd got it) and each leaf's
  change after them. The rest warm up every cut the window will use.
* :func:`window` runs that same object for ``seconds``, one step after
  another, each timed from its start (a cut change counts in the step it
  precedes) to the host copy of its loss; with a :class:`trace.Tracer`
  it profiles the steps ``[trace_start, trace_start + trace_steps)`` and
  sums the program's ``obs`` counters over them (``program.counting``).
* :func:`reference_readings` makes the weights and the checked steps'
  batches again from the seed and runs the plain reference on them.
"""
from __future__ import annotations

import math
import time
from contextlib import ExitStack
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from harness import feed, program, spec, weights
from harness.trace import Trace, Tracer
from reference import sfl

CHECKED = 3  # steps the reference follows


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Setup:
    trainer: object
    batches: object
    next_step: int
    checked: dict
    timing: dict


def setup(cell: spec.Cell, seed: int, device) -> Setup:
    model, t = cell.config["model"], cell.traffic
    sched = feed.CutSchedule.of(t)
    if len(sched.setup_cuts) < CHECKED:
        raise ValueError(f"setup_cuts needs at least {CHECKED} steps")
    clock = time.perf_counter()
    timing = {}

    def lap(name):
        nonlocal clock
        sync(device)
        now = time.perf_counter()
        timing[name] = round(now - clock, 4)
        clock = now

    init = weights.make(model, seed, device, spec.family(cell.config))
    lap("weights")
    trainer = program.Trainer(cell.config, t, init, device, sched.cuts,
                              sched.setup_cuts[0], seed)
    lap("program")
    batches = feed.token_batches(model["vocab_size"],
                                 t["cohort"] * t["batch"], t["seq"], seed,
                                 t.get("zipf_a", 1.2))
    checked = {"losses": []}
    for i, v in enumerate(sched.setup_cuts):
        if v != trainer.cut:
            trainer.migrate(v)
        loss = trainer.step(batches, feed.round_seed(seed, i))
        lap(f"step{i}")
        if i < CHECKED:
            checked["losses"].append(loss)
        if i == 0:
            checked["grad"] = sfl.update_norms(init, trainer.named(),
                                               1.0 / float(t["lr"]))
        if i == CHECKED - 1:
            checked["change"] = sfl.update_norms(init, trainer.named())
    return Setup(trainer, batches, len(sched.setup_cuts), checked, timing)


@dataclass
class Window:
    seconds: float
    steps: List[float] = field(default_factory=list)      # every step, s
    traced: List[bool] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    migrations_ms: List[float] = field(default_factory=list)
    trace: Optional[Trace] = None
    counters: Dict[str, float] = field(default_factory=dict)


def window(su: Setup, cell: spec.Cell, seed: int, seconds: float,
           tracer: Optional[Tracer] = None) -> Window:
    from harness import trace as trace_mod

    t = cell.traffic
    sched = feed.CutSchedule.of(t)
    lo = t.get("trace_start", 2) if tracer else -1
    hi = lo + t.get("trace_steps", 3) if tracer else -1
    trainer = su.trainer
    span = tracer.span if tracer else Tracer().span
    w = Window(seconds=seconds)
    with ExitStack() as stack:
        start = time.perf_counter()
        i = 0
        while True:
            if i == lo:
                stack.enter_context(tracer.session())
                counts = stack.enter_context(program.counting())
            t0 = time.perf_counter()
            v = sched.window_cut(i)
            if v != trainer.cut:
                with span("migration"):
                    trainer.migrate(v)
                    if tracer:
                        sync(trainer.device)
                        w.migrations_ms.append(
                            (time.perf_counter() - t0) * 1e3)
            loss = trainer.step(su.batches,
                                feed.round_seed(seed, su.next_step + i),
                                span)
            t1 = time.perf_counter()
            w.steps.append(t1 - t0)
            w.traced.append(lo <= i < hi)
            w.losses.append(loss)
            i += 1
            if i == hi:
                stack.close()
                w.counters = dict(counts)
                w.trace = trace_mod.read(tracer.last, hi - lo)
            if t1 - start >= seconds and (hi < 0 or i >= hi):
                break
        sync(trainer.device)
        w.seconds = time.perf_counter() - start
    return w


def checked_inputs(cell: spec.Cell, seed: int, device):
    """The checked steps' (tokens, labels) on ``device``, codec seeds and
    cuts, made again from the seed."""
    import torch

    model, t = cell.config["model"], cell.traffic
    it = feed.token_batches(model["vocab_size"], t["cohort"] * t["batch"],
                            t["seq"], seed, t.get("zipf_a", 1.2))
    shape = (t["cohort"], t["batch"], t["seq"])
    batches = []
    for _ in range(CHECKED):
        toks, labels = next(it)
        batches.append(tuple(torch.from_numpy(a.reshape(shape)).to(device)
                             for a in (toks, labels)))
    seeds = [feed.round_seed(seed, i) for i in range(CHECKED)]
    cuts = list(feed.CutSchedule.of(t).setup_cuts[:CHECKED])
    return batches, seeds, cuts


def reference_readings(cell: spec.Cell, seed: int, device, *,
                       tf32: bool = False, fault=None) -> dict:
    model, family = cell.config["model"], spec.family(cell.config)
    init = weights.make(model, seed, device, family)
    batches, seeds, cuts = checked_inputs(cell, seed, device)
    return sfl.run(model, cell.traffic, init, batches, seeds, cuts, family,
                   tf32=tf32, fault=fault)


@dataclass
class RunRecord:
    """What a per-layer metric's reader sees."""
    cell: spec.Cell
    peaks: Optional[dict]
    window: Window
    step_flops: float
    peak_bytes: int = 0

    @property
    def model(self) -> dict:
        return self.cell.config["model"]

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def trace(self) -> Optional[Trace]:
        return self.window.trace

    @property
    def counters(self) -> Dict[str, float]:
        """The program's ``obs`` counters summed over the profiled steps."""
        return self.window.counters

    @property
    def untraced_steps(self) -> List[float]:
        return [s for s, tr in zip(self.window.steps, self.window.traced)
                if not tr]


def end_to_end(w: Window, cell: spec.Cell, setup_s: float) -> dict:
    t = cell.traffic
    tokens = t["cohort"] * t["batch"] * t["seq"] * len(w.steps)
    values = {
        "train_tokens_per_s": tokens / w.seconds,
        "step_ms_p90": float(np.percentile(np.asarray(w.steps) * 1e3, 90)),
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(record: RunRecord) -> dict:
    out = {}
    for m in record.cell.per_layer:
        value = spec.metric_reader(m["name"]).read(record)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _num(x: float):
    return x if math.isfinite(x) else str(x)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, setup_clock=None, log=print) -> dict:
    """Set-up, window, check: the result line's object (``check`` last).
    ``setup_clock()`` reads the set-up time when the window opens."""
    import gc

    import torch

    from harness import check, peaks

    cuda = torch.device(device).type == "cuda"
    tracer = Tracer(cuda) if trace else None
    if tracer:
        tracer.warm()
    t0 = time.perf_counter()
    su = setup(cell, seed, device)
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = setup_clock() if setup_clock else time.perf_counter() - t0
    log(f"sflbench: set-up {setup_s:.4f} s, of which "
        f"{time.perf_counter() - t0:.4f} s after the imports: {su.timing}")

    w = window(su, cell, seed, seconds, tracer)

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    failed = sum(1 for x in w.losses if not math.isfinite(x))
    log(f"sflbench: {cell.name} seed {seed}: {len(w.steps)} steps in "
        f"{w.seconds:.4f} s, setup {setup_s:.4f} s, card {kind}")
    record = RunRecord(cell=cell, peaks=peaks.for_device(kind), window=w,
                       step_flops=spec.counts(cell.config["name"]).step_flops(
                           cell.config["model"], cell.traffic),
                       peak_bytes=int(peak))
    checked = su.checked
    del su
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = reference_readings(cell, seed, device)
    nums = check.numbers(checked, ref)
    ok, shown = check.verdict(nums, cell.limits.get("limits", {}))
    log(f"sflbench: the reference took {time.perf_counter() - t_check:.2f} "
        f"s; losses {checked['losses']} against {ref['losses']}")

    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        metrics = per_layer(record)
        dev["busy_s"] = w.trace.busy_s
        dev["window_s"] = w.trace.window_s
    else:
        metrics = end_to_end(w, cell, setup_s)
    result = {"correct": ok and failed == 0, "attempted": len(w.steps),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": w.trace.device_ops(),
                               "idle_gaps": w.trace.gaps}
    result["check"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                       for k, v in shown.items()}
    return result
