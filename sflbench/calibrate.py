"""Readings that the output check's limits are set from (not run by the
benchmark's own runs).

    python3 sflbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault-seeds 7,8,9] [--out FILE]

in one process, on the card: for each of ``--seeds`` the program's
checked steps (the run's own set-up) against the reference -- the lower
readings; for each of ``--control-seeds`` the reference in TF32 against
the reference in float32 -- the control; for each of ``--fault-seeds``
the reference with each planted fault (``reference.sfl.FAULTS``) against
the reference. One JSON line a reading, on standard output and appended
to ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def readings(cell, device, seeds, control_seeds, fault_seeds, emit):
    import torch

    from harness import check, session
    from reference import sfl

    def free():
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

    for seed in seeds:
        t0 = time.perf_counter()
        su = session.setup(cell, seed, device)
        prog = su.checked
        del su
        free()
        ref = session.reference_readings(cell, seed, device)
        emit({"kind": "program", "seed": seed,
              "numbers": check.numbers(prog, ref),
              "worst": check.worst(prog, ref),
              "losses": prog["losses"], "ref_losses": ref["losses"],
              "seconds": time.perf_counter() - t0})
        free()
    for seed in control_seeds:
        ref = session.reference_readings(cell, seed, device)
        ctl = session.reference_readings(cell, seed, device, tf32=True)
        emit({"kind": "control_tf32", "seed": seed,
              "numbers": check.numbers(ctl, ref),
              "worst": check.worst(ctl, ref)})
        free()
    for seed in fault_seeds:
        ref = session.reference_readings(cell, seed, device)
        for fault in sfl.FAULTS:
            bad = session.reference_readings(cell, seed, device, fault=fault)
            emit({"kind": f"fault_{fault}", "seed": seed,
                  "numbers": check.numbers(bad, ref)})
            free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec = dict(rec, cell=args.workload,
                   card=torch.cuda.get_device_name(0))
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        readings(cell, torch.device("cuda", 0), _seeds(args.seeds),
                 _seeds(args.control_seeds), _seeds(args.fault_seeds), emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
