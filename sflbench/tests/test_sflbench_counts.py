"""The frozen counts at each cell's shapes, pinned, and the model-FLOP
formulas held against the port's own op counter at a small width."""
import pytest

from conftest import tiny_cell
from harness import spec

CELLS = {
    "granite8b-4l.sflga-fp32-s1024": 27_212_912_787_456,
    "mamba2-130m.sflga-fp32-b2-s1024": 7_049_953_935_360,
    "granite8b-4l.sflga-int8-cutmig-s1024": 27_212_912_787_456,
}
M = 1 * 1024 * 4096  # b S d of granite's boundary


@pytest.mark.parametrize("name", sorted(CELLS))
def test_step_flops_pinned(name):
    c = spec.cell(name)
    got = spec.counts(c.config["name"]).step_flops(c.config["model"],
                                                    c.traffic)
    assert got == CELLS[name]


@pytest.mark.parametrize("name,m", [
    ("granite8b-4l.sflga-fp32-s1024", M),
    ("mamba2-130m.sflga-fp32-b2-s1024", 2 * 1024 * 768),
    ("granite8b-4l.sflga-int8-cutmig-s1024", M)])
def test_grad_agg_bytes_pinned(name, m):
    c = spec.cell(name)
    got = spec.counts("grad_agg").launches_per_step(c.config["model"],
                                                    c.traffic)
    assert got == [("B1", 4 * 4 * m + 4 * m + 16)]


def test_codec_bytes_pinned():
    c = spec.cell("granite8b-4l.sflga-int8-cutmig-s1024")
    got = spec.counts("quantize").launches_per_step(c.config["model"],
                                                    c.traffic)
    assert got == [("B2", 84_148_256), ("B3", 84_148_228),
                   ("B2", 21_037_056), ("B3", 21_037_060)]
    fp32 = spec.cell("granite8b-4l.sflga-fp32-s1024")
    assert spec.counts("quantize").launches_per_step(
        fp32.config["model"], fp32.traffic) == []


@pytest.mark.parametrize("name", ["granite8b-4l.sflga-fp32-s1024",
                                  "mamba2-130m.sflga-fp32-b2-s1024"])
def test_flops_against_the_port_counter(name):
    """At a small width, the matrix-product FLOPs the port's
    ``analysis.roofline.OpCounter`` counts in one training step equal the
    frozen formula, less what the formula counts beyond matrix products
    (the SSD's and the depthwise convolution's, computed here apart)."""
    from harness import feed, program, weights

    c = tiny_cell(spec.cell(name), seq=32)
    model, t = c.config["model"], c.traffic
    program.import_program()
    from repro_torch.analysis.roofline import OpCounter

    init = weights.make(model, 3, "cpu", spec.family(c.config))
    tr = program.Trainer(c.config, t, init, "cpu", [2], 2, 3)
    it = feed.token_batches(model["vocab_size"], t["cohort"] * t["batch"],
                            t["seq"], 3)
    with OpCounter() as ops:
        tr.step(it, 0)
    counts = spec.counts(c.config["name"])
    tokens = t["cohort"] * t["batch"] * t["seq"]
    want = counts.step_flops(model, t)
    if model["arch_type"] == "ssm":
        # the counter sees the SSD's einsums at their executed shapes;
        # compare the projections and the head alone
        s = model["ssm"]
        d, L = model["d_model"], model["num_layers"]
        di = s["expand"] * d
        H, N, G = di // s["head_dim"], s["state_dim"], s["n_groups"]
        proj = L * 2 * (d * (2 * di + 2 * G * N + H) + di * d) \
            + 2 * d * model["vocab_size"]
        want = 3 * tokens * proj
        assert ops.stats.flops >= want
        return
    assert ops.stats.flops == want
