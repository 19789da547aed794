"""The port's roofline (``repro_torch.analysis.roofline``): its op
counter on the reference's synthetic program and on DTensor matmuls
(run in a process of its own over a fake 8-rank group,
``_torch_dist.worker_roofline``), its peaks table and its rows.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.analysis.roofline import Roofline as JRoofline  # noqa: E402
from repro.analysis.roofline import analyze_hlo  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from _torch_dist import run_worker  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401
from test_launch_analysis import SYNTH_HLO  # noqa: E402


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    out = tmp_path_factory.mktemp("roofline") / "counted.json"
    run_worker("roofline", out)
    return json.loads(out.read_text())


def test_synthetic_program_counts_as_the_reference_parses_it(counted):
    """5 x (8,16)@(16,16) with an all-reduce each, then an all-gather to
    (64,16): the reference's ``analyze_hlo(SYNTH_HLO)`` and the port's
    counter over the same program run eagerly agree."""
    ref = analyze_hlo(SYNTH_HLO)
    got = counted["synth"]
    assert got["flops"] == ref.flops == 20480
    assert got["coll_bytes_by_kind"] == ref.coll_bytes_by_kind \
        == {"all-reduce": 5 * 512, "all-gather": 4096}
    assert got["coll_count_by_kind"]["all-reduce"] \
        == ref.coll_count_by_kind["all-reduce"] == 5
    # a collective of a group that is no mesh axis
    assert got["coll_bytes_by_axes"] == {"all-reduce@?": 2560,
                                         "all-gather@?": 4096}
    # each matmul reads (8,16) and (16,16) and writes (8,16), in f32
    assert got["dot_bytes"] == 5 * 4 * (128 + 256 + 128)


def test_sharded_and_replicated_matmuls_count_local_flops(counted):
    """x (64, 64) over "data" (2) times w (64, 128) over "model" (4): rank
    0 multiplies (32, 64) by (64, 32), 2*32*64*32 FLOPs; replicated w
    makes it (32, 64) by (64, 128), four times as many. The global op is
    2*64*64*128 either way (what FlopCounterMode would report)."""
    sh, rep = counted["sharded"], counted["replicated"]
    assert sh["flops"] == 2 * 32 * 64 * 32 == 131072
    assert rep["flops"] == 2 * 32 * 64 * 128 == 4 * sh["flops"]
    assert sh["global_flops"] == rep["global_flops"] == 2 * 64 * 64 * 128
    assert sh["coll_bytes_by_kind"] == rep["coll_bytes_by_kind"] == {}
    # gathering x's 2 row shards of (32, 64) f32 over "data"
    assert counted["gather"]["coll_bytes_by_axes"] == {
        "all-gather@data": 64 * 64 * 4}


def test_worker_imported_no_jax(counted):
    assert counted["clean"] == "ok"


def test_peaks_table():
    p = rl.device_peaks("NVIDIA H100 80GB HBM3")
    assert (p.hbm_bytes_per_s, p.f32_flop_per_s, p.tf32_flop_per_s,
            p.bf16_flop_per_s, p.link_bytes_per_s, p.nvlink_bytes_per_s) \
        == (3.35e12, 67e12, 495e12, 989e12, 50e9, 450e9)
    assert "data sheet" in p.source
    assert p.flop_per_s("bfloat16") == 989e12
    assert p.flop_per_s("float32") == 67e12
    assert p.flop_per_s("tf32") == 495e12
    with pytest.raises(KeyError, match="no peaks"):
        rl.device_peaks("TPU v5e")
    with pytest.raises(ValueError, match="no compute peak"):
        p.flop_per_s("int8")


def test_roofline_row_has_the_reference_keys():
    stats = rl.OpStats(flops=2e12, bytes=6.7e11, coll_bytes_by_axes={
        "all-reduce@data": 10**9}, coll_bytes_by_kind={"all-reduce": 10**9},
        global_flops=5e14, peak_bytes=123)
    r = rl.analyze(stats, arch="a", shape="s", mesh_tag="single", chips=256,
                   model_flops=256e12, dtype="float32")
    ref = JRoofline(arch="a", shape="s", mesh="single", chips=256,
                    hlo_flops=1.0, hlo_bytes=1.0, coll_bytes=1.0,
                    model_flops=1.0, coll_detail={}).to_dict()
    d = r.to_dict()
    assert set(d) == (set(ref) | {"device"}) - {"coll_bytes_tpu_per_dev",
                                                "t_collective_tpu_s"}
    assert d["t_compute_s"] == pytest.approx(2e12 / 67e12)
    assert d["t_memory_s"] == pytest.approx(0.2)
    assert d["t_collective_s"] == pytest.approx(0.02)
    assert d["bottleneck"] == "memory"
    assert d["useful_flops_ratio"] == pytest.approx(0.5)
    assert d["xla_flops"] == 5e14 and d["per_device_mem_bytes"] == 123
    assert d["coll_detail"] == {"all-reduce@data": 10**9}
    with pytest.raises(KeyError):
        rl.analyze(stats, arch="a", shape="s", mesh_tag="single", chips=1,
                   model_flops=1.0, device="TPU v5e")


def test_counter_on_plain_tensors_counts_matmuls_and_bytes():
    """No DTensor and no group: an (8,16)@(16,4) product and a ReLU."""
    c = rl.OpCounter()
    a, w = torch.ones(8, 16), torch.ones(16, 4)
    with c:
        y = torch.relu(a @ w)
    assert y.shape == (8, 4)
    assert c.stats.flops == 2 * 8 * 16 * 4
    assert c.stats.dot_bytes == 4 * (128 + 64 + 32)
    assert c.stats.bytes == c.stats.dot_bytes + 4 * (32 + 32)
    assert c.stats.coll_bytes == 0


def _load_script(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_roofline_table_prints_the_reference_rows(tmp_path, capsys):
    """``benchmarks/torch_roofline.py`` on a dry-run JSONL (two ok rows, a
    skipped and an error row) prints each row and the two closing lines
    as the reference's ``benchmarks/roofline.py`` prints them."""
    rows = []
    for i, (arch, coll) in enumerate((("granite-8b", 10**9),
                                      ("kimi-k2-1t-a32b", 10**12))):
        st = rl.OpStats(flops=1e13 * (i + 1), bytes=1e12,
                        coll_bytes_by_kind={"all-reduce": coll},
                        coll_bytes_by_axes={"all-reduce@data": coll})
        r = rl.analyze(st, arch=arch, shape="train_4k", mesh_tag="single",
                       chips=256, model_flops=1e15).to_dict()
        r.update(status="ok", compile_s=1.0, meta={}, memory_analysis="")
        rows.append(r)
    rows.append({"arch": "whisper-tiny", "shape": "long_500k",
                 "mesh": "single", "status": "skipped",
                 "reason": "long_500k unsupported for this family"})
    rows.append({"arch": "mamba2-130m", "shape": "decode_32k",
                 "mesh": "multi", "status": "error",
                 "error": "RuntimeError: boom"})
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    _load_script("torch_roofline").main(str(path))
    port = capsys.readouterr().err.splitlines()
    _load_script("roofline").main(str(path))
    ref = capsys.readouterr().err.splitlines()
    assert port[0].startswith("# roofline table") \
        and "NVIDIA H100 80GB HBM3" in port[0]
    assert port[1:] == ref[1:] and len(port) == 7
    assert port[-1].startswith("# most collective-bound: kimi-k2-1t-a32b")
