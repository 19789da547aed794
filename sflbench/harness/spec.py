"""Where the benchmark's data lives, and how a cell is resolved by name.

Everything that belongs to one configuration, one traffic mix, one
per-layer metric or one cell's limits is a file of its own, found by the
name that ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``  -- the model as it is run (widths, depth cut,
  precision, the deployment it stands for, and in ``family_module`` the
  stem of its family's reference module, ``reference/<stem>.py``; the
  default family ``reference/model.py`` when absent);
* ``traffic/<traffic>.json`` -- the training traffic: scheme, codecs,
  clients, batch, sequence, learning rate, the cut schedule;
* ``metrics/<metric>.py``    -- one reader a per-layer metric;
* ``counts/<name>.py``       -- model FLOPs a configuration, bytes a kernel;
* ``limits/<cell>.json``     -- the limit of each number the output check
  compares in that cell.

Adding a configuration, a traffic mix, a cell or a metric is adding files
here and an entry in ``BENCHMARK.json``; no code changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A Python file as a module, by path (file names may hold '-')."""
    mod_name = "sflbench_" + path.stem.replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads``: a configuration under a traffic mix."""
    name: str
    chips: int
    config: dict     # configs/<config>.json
    traffic: dict    # traffic/<traffic>.json
    limits: dict     # limits/<cell>.json
    end_to_end: tuple  # the end-to-end metric entries this cell reports
    per_layer: tuple   # the per-layer metric entries this cell reports


def benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bj = benchmark(root)
    entries = {w["name"]: w for w in bj["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(entries)}")
    w = entries[name]
    limits_path = bench_dir / "limits" / f"{name}.json"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load_json(bench_dir / "configs" / f"{w['config']}.json"),
        traffic=_load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(limits_path) if limits_path.exists() else {},
        end_to_end=tuple(m for m in bj["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bj["per_layer"] if _reports(m, name)))


def family_path(config: dict, bench_dir: Path = BENCH_DIR) -> Path:
    """``reference/<stem>.py`` of the configuration's family."""
    stem = config.get("family_module", "model")
    return bench_dir / "reference" / f"{stem}.py"


def family(config: dict):
    """The configuration's family (``reference.Family``), imported from
    the ``reference`` package on ``sys.path``."""
    import reference

    stem = family_path(config).stem
    return reference.Family(importlib.import_module(f"reference.{stem}"))


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``metrics/<name>.py``: a module with ``LAYER``, ``UNIT``, ``MOVES``
    and ``read(run) -> float | None``."""
    return load_module(bench_dir / "metrics" / f"{name}.py")


def counts(name: str, bench_dir: Path = BENCH_DIR):
    """``counts/<name>.py``: frozen operation and byte counts."""
    return load_module(bench_dir / "counts" / f"{name}.py")


def listed_files(root: Path = ROOT,
                 bench_dir: Path = BENCH_DIR) -> Dict[str, List[Path]]:
    """Every data file the benchmark names, by kind (for the tests)."""
    bj = benchmark(root)
    return {
        "configs": [bench_dir / "configs" / f"{c['name']}.json"
                    for c in bj["configs"]],
        "traffic": sorted({bench_dir / "traffic" / f"{w['traffic']}.json"
                           for w in bj["workloads"]}),
        "limits": [bench_dir / "limits" / f"{w['name']}.json"
                   for w in bj["workloads"]],
        "metrics": [bench_dir / "metrics" / f"{m['name']}.py"
                    for m in bj["per_layer"]],
        "counts": [bench_dir / "counts" / f"{c['name']}.py"
                   for c in bj["configs"]],
        "families": [family_path(_load_json(root / c["file"]), bench_dir)
                     for c in bj["configs"]],
    }
