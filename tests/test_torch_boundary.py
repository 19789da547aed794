"""The port's package boundary: ``repro_torch`` and ``chip_smoke.py``
import torch and numpy, never jax and nothing of the JAX package."""
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
    # every module of the port was imported (46 since the SSM slice): a
    # package that fails to import drops its modules from the walk
    assert int(n_modules) >= 46
    assert bad == "", f"the port pulled in: {bad}"


def test_port_mirrors_reference_module_paths():
    """Each port module has its counterpart at the same path in the
    reference (``_build`` and ``convert`` are the port's own)."""
    def modules(pkg):
        base = ROOT / "src" / pkg
        return {str(p.relative_to(base)) for p in base.rglob("*.py")
                if p.name != "__init__.py" and "build" not in p.parts}

    own = {"kernels/_build.py", "convert.py"}
    missing = modules("repro_torch") - own - modules("repro")
    assert not missing, sorted(missing)
