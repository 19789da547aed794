"""Roofline table of the port (after ``benchmarks/roofline.py``): reads
the port's dry-run JSONL and prints §Roofline rows (per arch x shape x
mesh: three terms, bottleneck, useful-FLOP ratio), then the worst
useful-FLOP ratio and the most collective-bound case.

The rows come from ``python -m repro_torch.launch.dryrun --out PATH``: a
CPU run over fake tensors, priced on the card each row names
(``device``, the H100's data-sheet peaks).

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
          --mesh both --out results/torch_dryrun.jsonl
      PYTHONPATH=src:. python benchmarks/torch_roofline.py \\
          [results/torch_dryrun.jsonl]
"""
from __future__ import annotations

import json
import os
import sys

from repro_torch import obs

DEFAULT_PATHS = ("results/torch_dryrun.jsonl",)


def load(path=None):
    paths = [path] if path else DEFAULT_PATHS
    rows = {}
    for p in paths:
        if p and os.path.exists(p):
            with open(p) as f:
                for line in f:
                    r = json.loads(line)
                    key = (r.get("arch"), r.get("shape"), r.get("mesh"))
                    rows[key] = r  # later lines win (re-runs)
    return list(rows.values())


def fmt_row(r):
    if r.get("status") == "skipped":
        return (f"  {r['arch']:<20} {r['shape']:<12} {r['mesh']:<6} SKIPPED "
                f"({r.get('reason','')})")
    if r.get("status") == "error":
        return (f"  {r['arch']:<20} {r['shape']:<12} {r['mesh']:<6} ERROR "
                f"{r.get('error','')[:80]}")
    return (f"  {r['arch']:<20} {r['shape']:<12} {r['mesh']:<6} "
            f"Tc={r['t_compute_s']:>9.4f}s Tm={r['t_memory_s']:>9.4f}s "
            f"Tcoll={r['t_collective_s']:>9.4f}s -> {r['bottleneck']:<10} "
            f"useful={r['useful_flops_ratio']:.3f}")


def main(path=None):
    rows = load(path)
    if not rows:
        obs.log("# roofline: no dry-run results found "
                "(run python -m repro_torch.launch.dryrun --all "
                "--out results/torch_dryrun.jsonl first)")
        return
    rows.sort(key=lambda r: (r.get("arch", ""), r.get("shape", ""),
                             r.get("mesh", "")))
    devices = sorted({r["device"] for r in rows if r.get("device")})
    obs.log(f"# roofline table (from dry-run artifacts; priced on "
            f"{', '.join(devices) or 'no device'})")
    for r in rows:
        obs.log(fmt_row(r))
    ok = [r for r in rows if r.get("status") == "ok"]
    if ok:
        worst = min(ok, key=lambda r: r.get("useful_flops_ratio", 1.0))
        coll = max(ok, key=lambda r: r.get("t_collective_s", 0.0))
        obs.log(f"# worst useful-FLOP ratio: {worst['arch']} x "
                f"{worst['shape']} ({worst['useful_flops_ratio']:.3f})")
        obs.log(f"# most collective-bound: {coll['arch']} x {coll['shape']}"
                f" (Tcoll={coll['t_collective_s']:.3f}s)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
