"""No run loads JAX or the JAX package, compared by whole top-level
module names (``repro_torch`` begins with ``repro``, and is the program);
the reference imports nothing of the program."""
import ast
import json
import subprocess
import sys

from conftest import BENCH

RUN_TINY = """
import json, sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[1] + "/tests")
import torch
torch.set_num_threads(1)
from conftest import tiny_cell
from harness import session, spec
import run
for name in ("granite8b-4l.sflga-int8-cutmig-s1024",
             "mamba2-130m.sflga-fp32-b2-s1024"):
    session.run_cell(tiny_cell(spec.cell(name)), 5, 0.2, False, "cpu",
                     log=lambda m: None)
print(json.dumps({"forbidden": run.forbidden_modules(),
                  "program": "repro_torch" in sys.modules}))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", RUN_TINY, str(BENCH)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "program": True}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in run.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "contextlib", "typing", "math", "torch",
               "reference"}
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert set(_imports(path)) <= allowed, path


def test_only_the_program_adapter_imports_the_program():
    for path in sorted(BENCH.rglob("*.py")):
        if path.name == "program.py" or "tests" in path.parts:
            continue
        mods = set(_imports(path))
        assert not mods & {"repro_torch", "repro", "jax", "jaxlib",
                           "flax"}, path
