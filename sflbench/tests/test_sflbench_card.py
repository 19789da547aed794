"""On the card, at each cell's own size (run on the machine with the
card: ``python -m pytest -q sflbench/tests/test_sflbench_card.py``):
the program's checked steps pass every limit of the cell, its control --
the reference in TF32 put in the program's place -- fails one, and one
short run of ``run.py`` prints a correct result line."""
import json
import subprocess
import sys

import pytest

from conftest import BENCH
from harness import check, spec

CELLS = ("granite8b-4l.sflga-fp32-s1024",
         "mamba2-130m.sflga-fp32-b2-s1024",
         "granite8b-4l.sflga-int8-cutmig-s1024")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(name, card):
    import calibrate

    cell = spec.cell(name)
    limits = cell.limits["limits"]
    got = []
    calibrate.readings(cell, card, [2 ** 31 + 1234], [2 ** 31 + 4321], [],
                       got.append)
    prog, ctl = got
    assert check.verdict(prog["numbers"], limits)[0], prog
    assert not check.verdict(ctl["numbers"], limits)[0], ctl


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_prints_a_correct_line(name, card):
    out = subprocess.run(
        [sys.executable, "sflbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 555), "--seconds", "3", "--trace", "0"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line
    assert list(line)[-1] == "check"
