"""The port's package boundary: ``repro_torch``, ``chip_smoke.py`` and
the port's scripts (``benchmarks/torch_*.py``, ``examples/torch_*.py``)
import torch and numpy, never jax and nothing of the JAX package."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
print(" ".join(names), file=sys.stderr)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names))
print(" ".join(bad))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n_modules, bad = (out.stdout.splitlines() + [""])[:2]
    # every module of the port was imported (83 since the dry-run
    # slice): a package that fails to import drops its modules from the
    # walk
    assert int(n_modules) >= 83
    walked = set(out.stderr.split())
    for name in ("tree", "optim", "optim.optimizers", "optim.schedules",
                 "core.split", "core.algorithms", "models.moe",
                 "configs.qwen3_moe_30b_a3b", "configs.jamba_v01_52b",
                 "models.encdec", "configs.whisper_tiny", "launch.mesh",
                 "launch.shardings", "obs.report", "launch.specs",
                 "launch.dryrun", "analysis.roofline"):
        assert f"repro_torch.{name}" in walked, name
    assert bad == "", f"the port pulled in: {bad}"


def test_port_mirrors_reference_module_paths():
    """Each port module has its counterpart at the same path in the
    reference (``_build``, ``convert``, ``tree``, G1's ``kernels/gemm``,
    M1's ``kernels/moe_combine`` and M2's ``kernels/moe_count``, which
    replace no TPU kernel, are the port's own)."""
    def modules(pkg):
        base = ROOT / "src" / pkg
        return {str(p.relative_to(base)) for p in base.rglob("*.py")
                if p.name != "__init__.py" and "build" not in p.parts}

    own = {"kernels/_build.py", "kernels/gemm.py", "kernels/moe_combine.py",
           "kernels/moe_count.py", "convert.py", "tree.py"}
    missing = modules("repro_torch") - own - modules("repro")
    assert not missing, sorted(missing)


def _imported(node):
    """The dotted names an import node brings in (``from benchmarks import
    x`` gives ``benchmarks.x``)."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom):
        mod = node.module or ""
        if mod == "benchmarks":
            return [f"benchmarks.{a.name}" for a in node.names]
        return [mod]
    return []


def test_port_scripts_import_no_jax_and_nothing_of_repro():
    """Reads the imports of every port script without running it: no
    ``jax*``, no ``repro.*``, and of ``benchmarks.*`` only the port's own
    ``benchmarks.torch_*`` modules (the reference's scripts import jax);
    ``repro_torch`` and ``chip_smoke`` are fine."""
    scripts = sorted([*ROOT.glob("benchmarks/torch_*.py"),
                      *ROOT.glob("examples/torch_*.py")])
    # 19 benchmark scripts and 4 examples since the last slice (A7)
    assert len(scripts) >= 23
    bad = []
    for path in scripts:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            for name in _imported(node):
                top, _, rest = name.partition(".")
                if top in ("jax", "jaxlib", "repro") or (
                        top == "benchmarks"
                        and not rest.startswith("torch_")):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_script_check_catches_a_reference_benchmark_import():
    """The check above, on a script that imports a reference benchmark
    module in each of the two forms."""
    for text in ("from benchmarks import fig8_latency_vs_bandwidth",
                 "from benchmarks.common import fed_setup"):
        names = [n for node in ast.walk(ast.parse(text))
                 for n in _imported(node)]
        assert names and not names[0].partition(".")[2].startswith(
            "torch_"), names
