"""The port's runs of the reference's scripts on the CPU:
``examples/torch_serve_decode.py``, ``benchmarks/torch_kernels_bench.py``
and the figure driver ``benchmarks/torch_run.py``.

* The example serves 4 users of 12 tokens on each arch (48 tokens), and
  the metrics directory of each is read by the port's report and by the
  reference's (the event schema is the reference's), both exiting 0
  with every traffic event reconciled.
* The kernels bench gives the reference's seven rows at the reference's
  shapes, named with ``_plain`` in place of ``_ref`` (on the CPU only
  the plain versions run).
* The driver writes its manifest's fields, gives the reference's fig8
  string for the same figure, records an entry that raises as ``error``
  and then exits non-zero (the reference exits 0).
"""
import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmarks' namespace package
    sys.path.insert(0, str(ROOT))

from benchmarks import run as jrun  # noqa: E402
from benchmarks import torch_fig8_latency_vs_bandwidth as fig8  # noqa: E402
from benchmarks import torch_kernels_bench as kbench  # noqa: E402
from benchmarks import torch_run  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

# the reference's rows (benchmarks/kernels_bench.py), in its order
REFERENCE_KERNEL_ROWS = [
    "flash_attention_ref_256", "ssd_ref_256", "grad_agg_ref_8x1024x512",
    "quantize_int8_ref_8x1024x512", "dequant_agg_int8_ref_8x1024x512",
    "quantize_int4_ref_8x1024x512", "dequant_agg_int4_ref_8x1024x512"]


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_serve_decode", ROOT / "examples" / "torch_serve_decode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _report(main, run_dir):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(run_dir), "--strict"])
    return rc, buf.getvalue()


def test_serve_example_and_both_reports(tmp_path):
    engines = _example().main(["--device", "cpu", "--quiet",
                               "--metrics-dir", str(tmp_path)])
    for arch, engine in engines.items():
        s = engine.summary()
        assert (s["users"], s["tokens"]) == (4, 48), arch
        for main in (report.main, jreport.main):
            rc, text = _report(main, tmp_path / arch)
            assert rc == 0, text
            assert "reconcile exactly" in text, text


def test_kernels_bench_rows_on_the_cpu():
    """The seven rows at the reference's shapes: flash (1, 256, 4/2
    heads, 64), SSD (1, 256, 4, 64) at chunk 64 with B/C (1, 256, 1, 64),
    and grad_agg, quantize and dequant_agg (int8, int4) at (8, 1024,
    512)."""
    rows = kbench.run(device="cpu")
    assert [n.replace("_plain_", "_ref_") for n, _ in rows] \
        == REFERENCE_KERNEL_ROWS
    assert all(us > 0 for _, us in rows)
    fns = kbench.cases(torch.device("cpu"))
    shapes = {stem: fns[stem][1]().shape for stem in
              ("flash_attention", "ssd", "grad_agg")}
    assert shapes == {"flash_attention": (1, 256, 4, 64),
                      "ssd": (1, 256, 4, 64), "grad_agg": (1024, 512)}
    q, s = fns["quantize_int4"][1]()
    assert (q.shape, s.shape) == ((8, 1024, 256), (8, 4, 2))


def test_driver_manifest_and_the_reference_fig8_string(tmp_path):
    out = tmp_path / "bench.json"
    rc = torch_run.main(["--only", "fig8,roofline", "--device", "cpu",
                         "--json", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    man = got["manifest"]
    assert man["schema"] == "repro.bench.v1"
    assert {"timestamp", "git_sha", "platform", "python", "torch_version",
            "cuda", "device"} <= set(man)
    assert man["torch_version"] == torch.__version__
    assert set(got["results"]) == {"fig8_latency_vs_bandwidth",
                                   "roofline_table"}
    assert all(r["status"] == "ok" for r in got["results"].values())
    assert got["results"]["fig8_latency_vs_bandwidth"]["derived"] \
        == jrun.bench_fig8()


def test_driver_exits_non_zero_when_an_entry_fails(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("broken on purpose")

    monkeypatch.setattr(fig8, "run", broken)
    out = tmp_path / "bench.json"
    rc = torch_run.main(["--only", "fig8,roofline", "--device", "cpu",
                         "--json", str(out)])
    assert rc != 0
    res = json.loads(out.read_text())["results"]
    assert res["fig8_latency_vs_bandwidth"]["status"] == "error"
    assert res["fig8_latency_vs_bandwidth"]["derived"] == \
        "ERROR:RuntimeError"
    assert res["roofline_table"]["status"] == "ok"
