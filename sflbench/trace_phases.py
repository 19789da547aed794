"""Where one cell's traced steps spend the device's time, by the port's
phase spans (``harness/phases.py``); not run by the benchmark's own runs.

    python3 sflbench/trace_phases.py --workload <cell> --seed <n> \
        [--seconds S] [--out FILE]

on the card: the run's set-up, then the window with the cell's traced
steps profiled as ``run.py --trace 1`` profiles them, and no output
check. One JSON line on standard output, also appended to ``--out``: per
phase its device ms and device-idle ms a step, the six readings of
``Phases.readings``, the step phases' share of the busy time, the busy
ms and the idle ms a step under the program's spans and outside them,
the program's counters over the traced steps, and the traced and the
untraced steps' times.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import session  # noqa: E402
from harness.trace import Tracer  # noqa: E402


def reading(cell, seed: int, seconds: float, device) -> dict:
    tracer = Tracer()
    tracer.warm()
    su = session.setup(cell, seed, device)
    w = session.window(su, cell, seed, seconds, tracer)
    ph = w.trace.phases
    ms = ph.per_step_ms
    idle = ph.window_us - ph.busy_us
    program_idle = sum(ph.idle_us.values())
    return {
        "workload": cell.name, "seed": seed, "steps": ph.steps,
        "device_ms": {k: ms(v) for k, v in sorted(ph.device_us.items())},
        "idle_ms": {k: ms(v) for k, v in sorted(ph.idle_us.items())},
        "readings": ph.readings(),
        "coverage": ph.coverage if ph.busy_us else None,
        "busy_ms": ms(ph.busy_us),
        "program_idle_ms": ms(program_idle),
        "harness_idle_ms": ms(idle - program_idle),
        "counters": w.counters,
        "traced_step_ms": [s * 1e3 for s, t in zip(w.steps, w.traced) if t],
        "untraced_step_ms": [s * 1e3 for s, t in zip(w.steps, w.traced)
                             if not t],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from harness import spec
    from run import _power_limit

    if not torch.cuda.is_available():
        print("trace_phases: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = reading(spec.cell(args.workload), args.seed, args.seconds,
                  torch.device("cuda", 0))
    out["card"] = _power_limit()
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
