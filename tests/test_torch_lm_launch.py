"""The port's launcher in LM mode (``repro_torch.launch.train``) against
the reference's ``train_lm`` on the same flags plus ``--device cpu``, at
the smoke preset (granite-8b reduced to 3 layers, d 256) and sequences
of 32.

The port's random init draws from torch's RNG, so these runs carry the
reference's init over (``init_lm``/``init_lm_loras`` patched to convert
the reference's draw). Then the first and final losses agree within
1e-5 relative (float32 noise over four steps; an int8 run at its first
loss only, as its rounding-boundary flips compound), and the traffic
and migration accounting exactly. Within the port: every step's
traffic event and every migration event reconcile exactly (the
reference's report exits 0 with ``--strict``); a checkpoint the port
writes from the reference's state is the reference's file byte for byte;
a resumed run writes the uninterrupted run's file byte for byte; the
device and host banks train the same bits under LoRA.
"""
import io
import json
import os
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.configs.base import PeftSpec as JPeftSpec  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.obs import report  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint_meta,  # noqa: E402
                                    save_checkpoint)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

BASE = ["--arch", "granite-8b", "--preset", "smoke", "--layers", "3",
        "--seq", "32", "--log-every", "100", "--quiet"]
LOSS_RTOL = 1e-5
MIGRATING = ["--steps", "4", "--dynamic-cut", "1,2"]
LORA_HOST = ["--peft", "lora", "--cohort", "2", "--clients", "4",
             "--bank", "host"]


def _jplan(plan):
    jcfg = jreduced(jget_config("granite-8b")).with_overrides(
        num_layers=plan.cfg.num_layers)
    peft = None if plan.peft is None else JPeftSpec(
        rank=plan.peft.rank, alpha=plan.peft.alpha)
    return jlm.build_plan(jcfg, plan.cut, peft=peft)


@pytest.fixture
def reference_init(monkeypatch):
    """The port's launcher starts from the reference's draws: its init_lm
    (key(seed)) and init_lm_loras (fold_in(key(seed), 1))."""
    def init_lm(seed, plan, dtype=torch.float32, device="cuda"):
        p = jlm.init_lm(jax.random.key(seed), _jplan(plan), jnp.float32)
        return convert.params_from_jax(jax.tree.map(np.asarray, p), plan,
                                       device)

    def init_lm_loras(seed, plan, dtype=torch.float32, device="cuda"):
        key = jax.random.fold_in(jax.random.key(seed - 1), 1)
        lo = jlm.init_lm_loras(key, _jplan(plan), jnp.float32)
        return convert.loras_from_jax(jax.tree.map(np.asarray, lo), plan,
                                      device)

    monkeypatch.setattr(lm, "init_lm", init_lm)
    monkeypatch.setattr(lm, "init_lm_loras", init_lm_loras)


def _events(run):
    with open(os.path.join(run, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("extra", [
    MIGRATING + ["--uplink-codec", "int8", "--downlink-codec", "int8"],
    MIGRATING + LORA_HOST + ["--scheme", "sfl"],
    ["--steps", "3", "--tau", "2", "--optimizer", "momentum", "--cohort",
     "2", "--clients", "3", "--scheme", "psl", "--cut", "2"]],
    ids=["full-int8-migrating", "lora-host-sfl-migrating",
         "psl-tau2-momentum-cohort"])
def test_lm_launch_matches_reference(reference_init, monkeypatch, tmp_path,
                                     extra):
    """Losses, traffic and migrations against the reference's run; the
    port's own per-step traffic and migration events reconcile."""
    got = {}
    orig = jtrain.train_lm
    monkeypatch.setattr(jtrain, "train_lm",
                        lambda a: got.setdefault("ref", orig(a)))
    jtrain.main(BASE + extra)
    ref = got["ref"]
    run = str(tmp_path / "run")
    port = train.main(BASE + extra + ["--device", "cpu", "--metrics-dir",
                                      run])
    # an int codec's rounding-boundary flips compound over steps (C3):
    # its runs are held at the first loss, before any update
    keys = ("first_loss",) if "int8" in extra else ("first_loss",
                                                     "final_loss")
    for k in keys:
        assert abs(port[k] - ref[k]) <= LOSS_RTOL * abs(ref[k]), k
    assert port["comm"] == ref["comm"]
    assert port["migration_bits"] == ref["migration_bits"]
    assert port["n_migrations"] == ref["n_migrations"]
    events = _events(run)
    traffic = [e for e in events if e.get("name") == "step_traffic"]
    migrations = [e for e in events if e.get("kind") == "migration"]
    assert len(traffic) == len(port["losses"])
    assert len(migrations) == port["n_migrations"]
    for e in traffic + migrations:
        assert e["measured"] == e["modeled"]
    with redirect_stdout(io.StringIO()):
        assert report.main([run, "--strict"]) == 0


def _payload(path):
    with open(path, "rb") as f:
        data = f.read()
    unp = msgpack.Unpacker(raw=False)
    unp.feed(data)
    unp.unpack()
    return data[unp.tell():]


@pytest.mark.parametrize("extra", [
    ["--optimizer", "adamw", "--cut", "2", "--clients", "3"],
    LORA_HOST + ["--optimizer", "adamw", "--dynamic-cut", "1,2"]],
    ids=["full-adamw", "lora-host-adamw"])
def test_checkpoint_is_the_reference_file(tmp_path, extra):
    """The reference's run saves a checkpoint; the port loads it into its
    layout (``load_lm_state``) and writes it back: the same bytes."""
    ref_path, port_path = str(tmp_path / "ref.ckpt"), str(tmp_path / "p.ckpt")
    jtrain.main(BASE + extra + ["--steps", "2", "--checkpoint", ref_path])
    meta = load_checkpoint_meta(ref_path)
    from repro_torch.configs import PeftSpec
    from repro_torch.core import algorithms as alg
    from repro_torch.optim import make_optimizer

    peft = PeftSpec(rank=8, alpha=16.0) if "lora" in extra else None
    cfg = train._lm_config(SimpleNamespace(arch="granite-8b", preset="smoke",
                                           layers=3))
    plan = lm.build_plan(cfg, meta["cut"], peft=peft)
    n = 4 if "lora" in extra else 3
    base = lm.init_lm(0, plan, device="cpu")
    params = (alg.split_lm_params(base, n) if peft is None else
              alg.split_lm_lora_params(base, lm.init_lm_loras(
                  1, plan, device="cpu"), n))
    opt_state = make_optimizer("adamw", 0.05).init(
        alg.trainable_params(params))
    state = train.load_lm_state(ref_path, train.lm_state_like(
        params, opt_state, plan), plan, "cpu")
    save_checkpoint(port_path, convert.lm_state_to_jax(state, plan), meta)
    with open(ref_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("extra", [
    ["--optimizer", "adamw", "--cohort", "2", "--clients", "4"],
    LORA_HOST + ["--optimizer", "momentum", "--dynamic-cut", "1,2",
                 "--uplink-codec", "int8", "--downlink-codec", "int8"]],
    ids=["device-adamw-cohort", "lora-host-int8-migrating"])
def test_resume_writes_the_uninterrupted_checkpoint(tmp_path, extra):
    """2 + 2 resumed steps save the 4-step run's file byte for byte (the
    migrations replay from the absolute step index)."""
    args = BASE + extra + ["--device", "cpu"]
    a, b, c = (str(tmp_path / f"{k}.ckpt") for k in "abc")
    train.main(args + ["--steps", "2", "--checkpoint", a])
    train.main(args + ["--steps", "2", "--resume", a, "--checkpoint", b])
    train.main(args + ["--steps", "4", "--checkpoint", c])
    assert load_checkpoint_meta(b)["step"] == 4
    with open(b, "rb") as fb, open(c, "rb") as fc:
        assert fb.read() == fc.read()


def test_device_and_host_banks_train_the_same_bits(tmp_path):
    """LoRA + adamw + a migrating cut: the device and the host bank give
    the same checkpoint payload (the meta names the bank)."""
    flags = BASE + ["--peft", "lora", "--cohort", "2", "--clients", "4",
                    "--optimizer", "adamw", "--dynamic-cut", "1,2",
                    "--steps", "3", "--device", "cpu"]
    out = {}
    for bank in ("device", "host"):
        out[bank] = str(tmp_path / f"{bank}.ckpt")
        train.main(flags + ["--bank", bank, "--checkpoint", out[bank]])
    assert _payload(out["device"]) == _payload(out["host"])


def test_lm_refusals(tmp_path):
    """What waits for later slices names them; the reference's refusals
    hold (the async loop's and ``--bank sharded``'s, CNN mode only, among
    them); a schedule's cuts must fit the model."""
    cpu = BASE + ["--device", "cpu", "--steps", "1"]
    with pytest.raises(SystemExit, match="cut-static"):
        train.main(cpu + ["--async", "--dynamic-cut", "ddqn:2"])
    with pytest.raises(SystemExit, match="optimizer sgd"):
        train.main(cpu + ["--async", "--optimizer", "adamw"])
    with pytest.raises(SystemExit, match="CNN-mode only"):
        train.main(cpu + ["--bank", "sharded"])
    with pytest.raises(SystemExit, match="lora"):
        train.main(cpu + ["--bank", "host", "--cohort", "2",
                          "--dynamic-cut", "1,2"])
    with pytest.raises(SystemExit, match="cohort"):
        train.main(cpu + ["--bank", "host"])
    with pytest.raises(SystemExit, match="every cut"):
        train.main(cpu + ["--dynamic-cut", "1,3"])
    ck = str(tmp_path / "lora.ckpt")
    train.main(cpu + ["--peft", "lora", "--checkpoint", ck])
    with pytest.raises(SystemExit, match="peft"):
        train.main(cpu + ["--resume", ck])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(BASE + ["--steps", "1"])
