"""The port's report CLI (``repro_torch.obs.report``) against the
reference's (``repro.obs.report``) on the same metrics directories:
port runs of the CNN launcher (a closed-loop run with cohorts and cut
migrations; an async run), each as written and with one traffic record
altered, a directory with no events, and ``--strict`` on a run without
traffic. Standard output, standard error and the exit code must be
equal."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.obs import report as jreport  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]

BASE = ["--arch", "paper-cnn", "--n-samples", "300", "--batch", "8",
        "--cut", "2", "--log-every", "100", "--quiet", "--device", "cpu",
        "--clients", "8", "--cohort", "4"]
RUNS = {"closed_loop": ["--rounds", "3", "--dynamic-cut", "2,1",
                        "--sampler", "uniform", "--uplink-codec", "int8"],
        "async": ["--rounds", "3", "--async", "--buffer", "2"]}


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("report")
    out = {}
    for name, args in RUNS.items():
        out[name] = base / name
        train.main(BASE + args + ["--metrics-dir", str(out[name])])
    return out


def _both(capsys, argv):
    """(stdout, stderr, exit code) of the reference's and the port's."""
    got = []
    for mod in (jreport, report):
        rc = mod.main(list(argv))
        cap = capsys.readouterr()
        got.append((cap.out, cap.err, rc))
    return got


def _alter(src: Path, dst: Path) -> None:
    """A copy of the run with one more bit measured on the first traffic
    event's busiest category."""
    shutil.copytree(src, dst)
    path = dst / "events.jsonl"
    lines = path.read_text().splitlines()
    for i, line in enumerate(lines):
        ev = json.loads(line)
        if ev.get("kind") == "traffic":
            cat = max(ev["measured"], key=lambda c: ev["measured"][c])
            ev["measured"][cat] += 1
            lines[i] = json.dumps(ev)
            break
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("name", sorted(RUNS))
@pytest.mark.parametrize("altered", [False, True])
def test_report_matches_reference(run_dirs, capsys, tmp_path, name,
                                  altered):
    d = run_dirs[name]
    if altered:
        _alter(d, tmp_path / name)
        d = tmp_path / name
    ref, port = _both(capsys, [str(d)])
    assert port == ref
    assert port[2] == (1 if altered else 0)
    if altered:
        assert "RECONCILIATION FAILED: 1 mismatched events" in port[1]
    else:
        assert "== traffic reconciliation" in port[0]


def test_report_missing_and_strict(capsys, tmp_path):
    ref, port = _both(capsys, [str(tmp_path)])
    assert port == ref and port[2] == 2
    (tmp_path / "events.jsonl").write_text(json.dumps(
        {"kind": "log", "name": "log", "msg": "hello"}) + "\n")
    ref, port = _both(capsys, [str(tmp_path), "--strict"])
    assert port == ref and port[2] == 1


def test_report_cli(run_dirs, capsys):
    """``python -m repro_torch.obs.report DIR`` prints what ``main`` does."""
    d = str(run_dirs["closed_loop"])
    want = _both(capsys, [d])[1]
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", d],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"})
    assert (out.stdout, out.stderr, out.returncode) == want
