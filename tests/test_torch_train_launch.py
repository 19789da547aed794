"""The port's training launcher (``repro_torch.launch.train``, CNN mode)
against the reference's, on the same arguments plus ``--device cpu``.

The traffic accounting, the async schedule and the closed loop's cuts
and migrations are integer or float64 numpy arithmetic on both sides,
so they must be equal exactly; the closed loop's wall-clock within rtol
1e-6 (``test_torch_closed_loop.py``). Within the port: resumed runs
write the uninterrupted run's checkpoint byte for byte, and the
reference's report CLI reads a port run's metrics directory.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as jtrain  # noqa: E402
from repro.obs import report  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from _torch_dist import _no_process_group_left  # noqa: E402,F401
from _torch_threads import _one_torch_thread  # noqa: E402,F401

BASE = ["--arch", "paper-cnn", "--n-samples", "300", "--batch", "8",
        "--cut", "2", "--log-every", "100", "--quiet"]


def _both(monkeypatch, args):
    """(reference result, port result) of one launch."""
    got = {}
    orig = jtrain.train_cnn
    monkeypatch.setattr(jtrain, "train_cnn",
                        lambda a: got.setdefault("ref", orig(a)))
    jtrain.main(BASE + args)
    return got["ref"], train.main(BASE + args + ["--device", "cpu"])


BYTES = ("up_bytes", "down_bytes", "total_bytes")


def test_fixed_cut_matches_reference(monkeypatch):
    ref, port = _both(monkeypatch, ["--rounds", "3", "--clients", "4",
                                    "--uplink-codec", "int8",
                                    "--downlink-codec", "int8"])
    assert {k: port[k] for k in BYTES} == {k: ref[k] for k in BYTES}
    assert port["replacement_fraction"] == ref["replacement_fraction"]
    assert 0.0 <= port["accuracy"] <= 1.0


def test_async_matches_reference(monkeypatch):
    ref, port = _both(monkeypatch, ["--rounds", "4", "--clients", "8",
                                    "--cohort", "4", "--async", "--buffer",
                                    "2", "--straggler", "8"])
    assert port["async"] == ref["async"]
    assert port["async"]["merges"] > 4  # the drain merged the tail
    assert {k: port[k] for k in BYTES} == {k: ref[k] for k in BYTES}


@pytest.mark.parametrize("extra", [[], ["--async", "--cohort", "4",
                                        "--buffer", "2"]])
def test_dynamic_cut_matches_reference(monkeypatch, extra):
    ref, port = _both(monkeypatch, ["--rounds", "4", "--clients", "8",
                                    "--dynamic-cut", "2,1,3"] + extra)
    assert port["cuts"] == ref["cuts"] == [2, 1, 3, 2]
    for key in ("n_migrations", "migration_bits", "total_bits"):
        assert port[key] == ref[key]
    np.testing.assert_allclose(port["wall_clock_s"], ref["wall_clock_s"],
                               rtol=1e-6)


def test_ddqn_schedule_runs_live(tmp_path):
    """``ddqn:EPISODES`` trains Algorithm 1 on the CPU first (the agent
    follows ``--device``), then queries it every round."""
    out = train.main(BASE + ["--rounds", "3", "--clients", "4",
                             "--dynamic-cut", "ddqn:2", "--device", "cpu"])
    assert len(out["cuts"]) == 3 and all(1 <= v <= 4 for v in out["cuts"])
    assert np.isfinite(out["wall_clock_s"]) and out["wall_clock_s"] > 0


@pytest.mark.parametrize("extra", [["--clients", "4"],
                                   ["--clients", "8", "--cohort", "4",
                                    "--async", "--buffer", "1",
                                    "--bank", "host"]])
def test_resume_writes_the_uninterrupted_checkpoint(tmp_path, extra):
    """Two launches of 3 rounds (the second resumed from the first's
    checkpoint) save the one launch of 6 rounds' file, byte for byte; an
    async launch keeps its in-flight queue in the file."""
    args = BASE + extra + ["--device", "cpu"]
    a, b, c = (str(tmp_path / f"{n}.ckpt") for n in "abc")
    train.main(args + ["--rounds", "3", "--checkpoint", a])
    train.main(args + ["--rounds", "3", "--resume", a, "--checkpoint", b])
    train.main(args + ["--rounds", "6", "--checkpoint", c])
    with open(b, "rb") as fb, open(c, "rb") as fc:
        assert fb.read() == fc.read()


def test_metrics_dir_reads_in_the_reference_report(tmp_path):
    """An async port run's events render with the reference's report and
    every traffic event reconciles (exit 0)."""
    run = str(tmp_path / "run")
    train.main(BASE + ["--rounds", "3", "--clients", "8", "--cohort", "4",
                       "--async", "--buffer", "2", "--device", "cpu",
                       "--metrics-dir", run, "--profile", "1"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert report.main([run, "--strict"]) == 0
    text = buf.getvalue()
    assert "== async engine ==" in text and "merges" in text
    assert (tmp_path / "run" / "profile" / "round_1.json").exists()


def test_device_rule_and_modes_not_ported(_no_process_group_left):
    """The card is the default and is never swapped for the CPU; the LM
    mode's async loop keeps the reference's refusals; ``--bank sharded``
    runs in CNN mode on a one-rank gloo group, equal to the device
    bank's run."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(BASE + ["--rounds", "1"])
    with pytest.raises(SystemExit, match="sfl_ga/psl"):
        train.main(["--arch", "granite-8b", "--device", "cpu", "--async",
                    "--scheme", "sfl"])
    with pytest.raises(SystemExit, match="LM-mode only"):
        train.main(BASE + ["--peft", "lora", "--device", "cpu"])
    run = BASE + ["--rounds", "1", "--clients", "4", "--device", "cpu"]
    got = train.main(run + ["--bank", "sharded"])
    assert torch.distributed.get_backend() == "gloo"
    assert got.pop("bank")["backend"] == "sharded"
    assert got == train.main(run)
