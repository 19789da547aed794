"""The benchmark's files: every one ``BENCHMARK.json`` names exists and
parses, the file keeps to the contract's shapes, and a cell, a traffic
mix, a configuration, a model family or a metric added as new files is
found with no edit."""
import json
import os
import re
import shutil
import subprocess
import sys


from conftest import BENCH
from harness import spec

ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bj():
    return spec.benchmark()


def test_top_level_keys():
    bj = _bj()
    assert set(bj) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert bj["paths"] == ["sflbench"]
    assert bj["command"] == ["python3", "sflbench/run.py"]
    assert 1 <= bj["run_seconds"] <= 51
    assert os.path.getsize(ROOT / "BENCHMARK.json") <= 64 * 1024


def test_entries_keep_to_their_keys_and_names():
    bj = _bj()
    for c in bj["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("sflbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bj["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    metrics = bj["end_to_end"] + bj["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in bj["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bj["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bj["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bj["end_to_end"]}


def test_every_listed_file_parses_and_agrees():
    bj = _bj()
    files = spec.listed_files()
    for kind in ("configs", "traffic", "limits"):
        for path in files[kind]:
            assert path.exists(), path
            json.loads(path.read_text())
    for c in bj["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for path in files["counts"]:
        assert callable(spec.load_module(path).step_flops)
    for c, path in zip(bj["configs"], files["families"]):
        assert path.exists(), path
        cfg = json.loads((ROOT / c["file"]).read_text())
        fam = spec.family(cfg)
        assert callable(fam.layer_leaves) and callable(fam.module.layer)
        assert cfg["model"]["arch_type"] in fam.tiny
    for m in bj["per_layer"]:
        reader = spec.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == \
            (m["layer"], m["unit"], m["moves"])
    for w in bj["workloads"]:
        cell = spec.cell(w["name"])
        lim = cell.limits["limits"]
        assert set(lim) <= {"loss_gap", "grad_gap", "change_gap",
                            "grad_gap_median", "change_gap_median"} and lim
        assert all(0 < v < 1 for v in lim.values())
        assert cell.per_layer and len(cell.end_to_end) >= 2


def test_check_fits_the_time_limit():
    """2 + 14 runs a cell of run_seconds + 60 s, 180 s a cell to compile
    and 1,200 s spare fit 43,200 s with the full 24 cells."""
    rs = _bj()["run_seconds"]
    assert 24 * (14 * (rs + 60) + 180) + 2 * (rs + 60) + 1200 <= 43200


TINY_CONFIG = {
    "name": "tiny-dense", "source": "https://arxiv.org/abs/2405.04324",
    "model": {"arch_type": "dense", "num_layers": 3, "d_model": 32,
              "num_heads": 4, "num_kv_heads": 2, "head_dim": 8, "d_ff": 64,
              "vocab_size": 128, "rope_theta": 10000.0, "mlp_act": "swiglu",
              "norm_eps": 1e-5, "tie_embeddings": False},
    "reduced": [], "assumed": [], "precision": "float32",
    "deployment": "a CPU-sized copy for a test"}
TINY_TRAFFIC = {
    "name": "tiny-sflga", "scheme": "sfl_ga", "uplink_codec": "int8",
    "downlink_codec": "int8", "clients": 2, "cohort": 2, "batch": 1,
    "seq": 16, "tau": 1, "optimizer": "sgd", "lr": 0.01,
    "setup_cuts": [1, 2, 1], "cut_cycle": [1, 2], "steps_per_cut": 2}
STEPS_SEEN = '''"""Steps the window ran (a test's metric)."""
LAYER = "window"
UNIT = "steps"
MOVES = "train_tokens_per_s"


def read(run):
    return float(len(run.window.steps))
'''


def test_new_files_alone_add_a_cell(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell and a metric as new files and entries of BENCHMARK.json, and
    runs the new cell on the CPU with the harness unedited."""
    shutil.copytree(BENCH, tmp_path / "sflbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    os.symlink(ROOT / "src", tmp_path / "src")
    b = tmp_path / "sflbench"
    (b / "configs" / "tiny-dense.json").write_text(json.dumps(TINY_CONFIG))
    (b / "traffic" / "tiny-sflga.json").write_text(json.dumps(TINY_TRAFFIC))
    (b / "limits" / "tiny-dense.tiny-sflga.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-3}}))
    shutil.copy(b / "counts" / "granite-8b-4l.py",
                b / "counts" / "tiny-dense.py")
    (b / "metrics" / "steps_seen.py").write_text(STEPS_SEEN)
    bj = _bj()
    bj["configs"].append({"name": "tiny-dense", "source": TINY_CONFIG[
        "source"], "file": "sflbench/configs/tiny-dense.json",
        "reduced": [], "why": "a test"})
    bj["workloads"].append({"name": "tiny-dense.tiny-sflga",
                            "config": "tiny-dense", "traffic": "tiny-sflga",
                            "chips": 1, "why": "a test"})
    bj["per_layer"].append({"name": "steps_seen", "unit": "steps",
                            "better": "higher", "source": "host_clock",
                            "layer": "window", "moves": "train_tokens_per_s",
                            "workloads": ["tiny-dense.tiny-sflga"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bj))
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1]);"
        "import torch; torch.set_num_threads(1);"
        "from harness import spec, session;"
        "c = spec.cell('tiny-dense.tiny-sflga');"
        "r = session.run_cell(c, 2**31 + 5, 0.5, False, 'cpu',"
        " log=lambda m: None);"
        "print(json.dumps({'correct': r['correct'],"
        " 'metrics': sorted(r['metrics']),"
        " 'per_layer': [m['name'] for m in c.per_layer],"
        " 'where': spec.BENCH_DIR.as_posix()}))")
    out = subprocess.run([sys.executable, "-c", code, str(b)],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["where"] == b.as_posix()
    assert r["correct"] is True
    assert r["metrics"] == sorted(m["name"] for m in bj["end_to_end"])
    assert "steps_seen" in r["per_layer"]


HYBRID = BENCH / "tests" / "hybrid_moe"
HYBRID_CELL = "tiny-hybrid-moe.tiny-sflga-hybrid"
RUN_HYBRID = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from harness import check, session, spec, weights
from reference import sfl

c = spec.cell(sys.argv[2])
seed = 2 ** 31 + 7
quiet = dict(log=lambda m: None)
plain = session.run_cell(c, seed, 0.3, False, "cpu", **quiet)
traced = session.run_cell(c, seed, 0.3, True, "cpu", **quiet)
fam = spec.family(c.config)
fam.aux_weight = 0.0  # the balance loss left out of the reference
model = c.config["model"]
ref = sfl.run(model, c.traffic, weights.make(model, seed, "cpu", fam),
              *session.checked_inputs(c, seed, "cpu"), fam)
nobal = check.numbers(session.setup(c, seed, "cpu").checked, ref)
print(json.dumps({
    "correct": [plain["correct"], traced["correct"]],
    "metrics": sorted(plain["metrics"]), "traced": traced["metrics"],
    "no_balance_loss": check.verdict(nobal, c.limits["limits"])[0],
    "families": [p.as_posix() for p in spec.listed_files()["families"]]}))
"""


def test_new_family_enters_as_files_only(tmp_path):
    """A copy of the benchmark gains a model family -- Jamba's shape at
    CPU size (``tests/hybrid_moe``): a period of Mamba-2 and attention
    mixers with MoE and SwiGLU FFNs, its reference module, configuration,
    counts, traffic (with ``remat``), limits and a metric that reads
    ``run.trace.phases`` -- as new files and new entries of
    BENCHMARK.json, and runs its cell on the CPU, plain and traced, with
    ``correct`` true. The configuration's capacity_factor, num_experts /
    top_k, gives every expert room for every token of a forward, so no
    token is dropped and routing alone decides the experts' rows. The
    same reference with the balance loss left out fails the check: the
    comparison covers the MoE term."""
    shutil.copytree(BENCH, tmp_path / "sflbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    os.symlink(ROOT / "src", tmp_path / "src")
    b = tmp_path / "sflbench"
    added = sorted(p.relative_to(HYBRID) for p in HYBRID.rglob("*")
                   if p.is_file() and "__pycache__" not in p.parts)
    assert added and not any((b / p).exists() for p in added)
    shutil.copytree(HYBRID, b, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((HYBRID / "configs" / "tiny-hybrid-moe.json")
                     .read_text())
    bj = _bj()
    bj["configs"].append({"name": cfg["name"], "source": cfg["source"],
                          "file": "sflbench/configs/tiny-hybrid-moe.json",
                          "reduced": [], "why": "a test"})
    bj["workloads"].append({"name": HYBRID_CELL, "config": cfg["name"],
                            "traffic": "tiny-sflga-hybrid", "chips": 1,
                            "why": "a test"})
    bj["per_layer"].append({"name": "program_spans_seen", "unit": "spans",
                            "better": "higher", "source": "program_span",
                            "layer": "train step, core/algorithms.py "
                                     "make_train_step",
                            "moves": "train_tokens_per_s",
                            "workloads": [HYBRID_CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bj))
    out = subprocess.run([sys.executable, "-c", RUN_HYBRID, str(b),
                          HYBRID_CELL], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] == [True, True]
    assert r["metrics"] == sorted(m["name"] for m in bj["end_to_end"])
    # the traced steps cross a cut change: the step's six spans and resplit
    assert r["traced"]["program_spans_seen"]["value"] == 7.0
    assert r["no_balance_loss"] is False
    assert (b / "reference" / "hybrid_moe.py").as_posix() in r["families"]
