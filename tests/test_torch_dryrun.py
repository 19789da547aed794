"""The port's dry run (``repro_torch.launch.dryrun``): granite-8b at
full widths and 3 layers on the (16, 16) mesh, run over DTensors of fake
tensors as rank 0 of a fake 256-rank group, in a process of its own
(``_torch_dist.worker_dryrun``).

* One case of each kind (train, prefill, decode) ends ``ok`` with the
  reference's row keys, plus ``device`` and minus the TPU projection
  (``coll_bytes_tpu_per_dev``, ``t_collective_tpu_s``).
* The paper's comparison (EXPERIMENTS.md §Roofline): sfl_ga's eq. 5
  aggregate of the smashed-data gradients is one all-reduce over the
  client axis ("data") of X(v) in f32, b S d elements a rank; sfl's
  client-model average is one all-reduce over that axis for each client
  leaf, of the rank's shard of it in f32. Every other collective is the
  same in both, so the difference of the two rows' ``all-reduce@data``
  bytes and counts is held exactly to what those placements give.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.analysis.roofline import Roofline as JRoofline  # noqa: E402
from repro.configs import INPUT_SHAPES, get_config  # noqa: E402
from _torch_dist import ROW_ARCH, run_worker  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "rows.json"
    run_worker("dryrun", out)
    return json.loads(out.read_text())


def _reference_keys():
    """The keys of a row the reference's ``run_case`` writes."""
    r = JRoofline(arch="a", shape="s", mesh="m", chips=1, hlo_flops=1.0,
                  hlo_bytes=1.0, coll_bytes=1.0, model_flops=1.0,
                  coll_detail={})
    return set(r.to_dict()) | {"status", "compile_s", "meta",
                               "memory_analysis"}


@pytest.mark.parametrize("name", ["sfl_ga", "prefill", "decode"])
def test_row_of_each_kind(rows, name):
    r = rows[name]
    assert r["status"] == "ok", r
    want = (_reference_keys() | {"device"}) - {"coll_bytes_tpu_per_dev",
                                               "t_collective_tpu_s"}
    assert set(r) == want, set(r) ^ want
    assert r["device"] == "NVIDIA H100 80GB HBM3"
    assert r["meta"]["torch"] == torch.__version__  # the counts' maker
    assert r["chips"] == 256 and r["mesh"] == "single"
    assert r["hlo_flops_per_dev"] > 0 and r["hlo_bytes_per_dev"] > 0
    assert r["xla_flops"] >= r["hlo_flops_per_dev"]
    assert r["per_device_mem_bytes"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert sum(r["coll_detail"].values()) == r["coll_bytes_per_dev"]
    # priced on the H100's data-sheet peaks: bf16 989 TFLOP/s, 3.35 TB/s
    # HBM, 50 GB/s a GPU across nodes
    assert r["t_compute_s"] == pytest.approx(r["hlo_flops_per_dev"] / 989e12)
    assert r["t_memory_s"] == pytest.approx(r["hlo_bytes_per_dev"] / 3.35e12)
    assert r["t_collective_s"] == pytest.approx(
        r["coll_bytes_per_dev"] / 50e9)


def test_sfl_ga_and_sfl_differ_by_their_client_axis_reduction(rows):
    ga, sfl = rows["sfl_ga"], rows["sfl"]
    assert ga["meta"]["algo"] == "sfl_ga" and sfl["meta"]["algo"] == "sfl"
    cfg = get_config(ROW_ARCH)
    shape = INPUT_SHAPES["train_4k"]
    b = shape.global_batch // ga["meta"]["n_clients"]  # one client a rank
    x_v = 4 * b * shape.seq_len * cfg.d_model  # f32 (b, S, d)
    phi = [4 * n for n in rows["client_local"]]  # f32 client shards
    assert x_v == 1073741824 and len(phi) == 19
    key = "all-reduce@data"
    assert ga["coll_detail"][key] - sfl["coll_detail"][key] \
        == x_v - sum(phi) == 914292736
    assert ga["coll_detail"][key] >= x_v
    # every other collective is the same in the two runs
    others = (set(ga["coll_detail"]) | set(sfl["coll_detail"])) - {key}
    assert {k: ga["coll_detail"].get(k) for k in others} \
        == {k: sfl["coll_detail"].get(k) for k in others}


def test_remat_recomputes_the_forward_and_lowers_the_peak(rows):
    """The train rows rematerialize each layer (``remat``, the default):
    the recompute adds its FLOPs and the forward's collectives over
    "model" (the layers' all-gathers and reduce-scatters there), every
    collective over "data" is the same (eq. 5's X(v) sits at the
    boundary, outside the layers), and rank 0's peak live storage
    falls."""
    ga, plain = rows["sfl_ga"], rows["sfl_ga_no_remat"]
    assert ga["meta"]["remat"] is True and plain["meta"]["remat"] is False
    assert "remat" not in rows["prefill"]["meta"]
    assert ga["hlo_flops_per_dev"] > plain["hlo_flops_per_dev"]
    assert ga["per_device_mem_bytes"] < plain["per_device_mem_bytes"]
    for kind in ("all-gather@model", "reduce-scatter@model"):
        assert ga["coll_detail"][kind] > plain["coll_detail"][kind]
    data = {k for k in ga["coll_detail"] if k.endswith("@data")}
    assert data and {k: ga["coll_detail"][k] for k in data} \
        == {k: plain["coll_detail"][k] for k in data}


def test_worker_imported_no_jax(rows):
    assert rows["clean"] == "ok"


def test_expert_parallel_moe_runs_over_dtensors(rows):
    """Under ``expert_parallel`` (``expert_axis="data"``, 2 routing
    groups) a reduced qwen3-moe MoE runs forward and backward over
    DTensors on a (2, 2) mesh: its routing groups, split over "data",
    are made whole on every rank before the loop over them (the 2 x 16
    tokens of d 256 in f32, 32,768 B gathered over "data"), and the
    dispatched tokens are pinned to ("data", None, "model")."""
    got = rows["moe_ep"]
    assert got["flops"] > 0
    assert got["coll_bytes_by_axes"]["all-gather@data"] >= 2 * 16 * 256 * 4
