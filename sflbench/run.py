"""Run one cell of the SFL-GA training benchmark once.

    python3 sflbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Set-up (the time ``setup_s`` reports, from process start): imports,
CUDA, the port's kernel build (kept in ``src/repro_torch/kernels/build/``
of the checkout, so only a checkout's first run compiles), weights made
on the card from the seed, and the set-up steps: the checked steps, and
a warm-up of every cut the window uses. Then the window: the same
training object, step after step, for ``--seconds``, ending in a
``torch.cuda.synchronize()``. Then the output check: the program's state
is freed and the plain reference (``sflbench/reference``) recomputes the
checked steps from the same seed. The last line of standard output is
one JSON object; the numbers compared, with their limits, are the last
lines of standard error and the result's last key.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1``
profiles a few steps of the window and reports its per-layer metrics,
the device's busy time and a breakdown. Exits 2 without a result when
there is no card or too few.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

# every build or kernel cache of the run stays in the checkout
CACHE = BENCH / "_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _since_process_start() -> float:
    """Seconds since this process started (``/proc``; else since this
    module's first line)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import session, spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"sflbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {n}", file=sys.stderr)
        return 2
    if not cell.limits.get("limits"):
        print(f"sflbench: no limits for {args.workload}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = session.run_cell(
        cell, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), setup_clock=_since_process_start,
        log=lambda m: print(m, file=sys.stderr))
    print(f"sflbench: card {_power_limit()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"sflbench: the run loaded {bad}; the port must not import "
              f"JAX or the JAX package", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
