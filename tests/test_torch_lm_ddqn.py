"""The LM's cutting-point MDP (``ccc.env.lm_env_config``) and the LM
launcher's ``--dynamic-cut ddqn[:E]`` schedule on the port, on the CPU:

* ``lm_env_config`` equals the reference's field for field on
  granite-8b (full config, with and without LoRA), where both packages
  count the same leaves;
* the kept differences are pinned: on qwen3-moe-30b-a3b the port's φ(v)
  and q also count the QK-norm scales (2 x head_dim a layer), and on
  mamba2-130m, where the reference raises ``ZeroDivisionError`` (an
  attention-free config has no head_dim), the port's env prices the
  leaves that move;
* the scalar env over that config gives the reference's rewards, bit for
  bit, on a fixed action sequence that moves the cut (migrations priced
  at φ(v), or at the adapters under LoRA);
* ``--dynamic-cut ddqn:2`` in LM mode, at a seed whose rollout moves the
  cut, trains Algorithm 1, freezes its greedy rollout and follows it
  step by step, each migration's bits those of
  ``sysmodel.traffic.migration_bits``; 2 steps and a resume of 2 write
  the 4-step run's checkpoint byte for byte.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ccc import env as jenv  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import PeftSpec as JPeftSpec  # noqa: E402
from repro_torch.ccc import env  # noqa: E402
from repro_torch.checkpoint import load_checkpoint_meta  # noqa: E402
from repro_torch.configs import PeftSpec, get_config, reduced_config  # noqa: E402
from repro_torch.core import split  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.sysmodel.traffic import migration_bits  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

KW = dict(seq=256, n_clients=4, batch=2, seed=3)
BASE = ["--arch", "granite-8b", "--preset", "smoke", "--layers", "3",
        "--seq", "32", "--log-every", "100", "--quiet", "--device", "cpu",
        "--dynamic-cut", "ddqn:2"]


def _envs(arch, lora, cfg_fn=lambda c: c):
    peft, jpeft = (PeftSpec(), JPeftSpec()) if lora else (None, None)
    return (env.lm_env_config(cfg_fn(get_config(arch)), peft=peft, **KW),
            jenv.lm_env_config(cfg_fn(jget_config(arch)), peft=jpeft, **KW))


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
def test_lm_env_config_equals_reference(lora):
    """granite-8b at its 36 layers: φ(v), the migration payloads (φ(v),
    or the adapters under LoRA), X(v) = seq·d_model, the FLOP fractions
    and q, exactly."""
    got, want = _envs("granite-8b", lora)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert len(got.phis) == 35
    assert got.mig_phis == (tuple(
        split.client_adapter_numel(lm.build_plan(
            get_config("granite-8b"), v, peft=PeftSpec()))
        for v in range(1, 36)) if lora else got.phis)


def test_lm_env_config_kept_differences():
    """qwen3-moe: each layer on the client side adds its two QK-norm
    scales to φ(v), and every layer to q; the rest is the reference's.
    mamba2-130m: the reference raises, the port counts the leaves."""
    got, want = _envs("qwen3-moe-30b-a3b", False)
    cfg = get_config("qwen3-moe-30b-a3b")
    qk = 2 * cfg.resolved_head_dim
    assert [g - w for g, w in zip(got.phis, want.phis)] == \
        [qk * v for v in range(1, cfg.num_layers)]
    assert got.total_params - want.total_params == qk * cfg.num_layers
    same = {k for k, v in dataclasses.asdict(got).items()
            if v == dataclasses.asdict(want)[k]}
    assert set(dataclasses.asdict(got)) - same == {"phis", "mig_phis",
                                                   "total_params"}
    with pytest.raises(ZeroDivisionError):
        jenv.lm_env_config(jget_config("mamba2-130m"), **KW)
    m = env.lm_env_config(get_config("mamba2-130m"), **KW)
    plans = [lm.build_plan(get_config("mamba2-130m"), v) for v in
             range(1, 24)]
    assert m.phis == tuple(split.client_param_numel(p) for p in plans)
    assert m.smashed_elems == (256 * 768,) * 23


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
def test_env_rewards_equal_reference_on_fixed_actions(lora):
    """The scalar env over granite-8b cut to 6 layers: 20 actions that
    move the cut every few rounds; the rewards, the migration bits and
    the states are the reference's bit for bit."""
    got, want = _envs("granite-8b", lora,
                      lambda c: c.with_overrides(num_layers=6))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    e, je = env.CuttingPointEnv(got), jenv.CuttingPointEnv(want)
    np.testing.assert_array_equal(e.reset(), je.reset())
    actions = [0, 0, 3, 3, 1, 4, 4, 2, 0, 1, 1, 3, 2, 4, 0, 0, 2, 3, 1, 4]
    for a in actions:
        s, r, done, info = e.step(a)
        js, jr, jdone, jinfo = je.step(a)
        np.testing.assert_array_equal(s, js)
        assert r == jr and done == jdone
        assert info["mig_bits"] == jinfo["mig_bits"]
    assert done


def _events(run):
    with open(os.path.join(run, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _moving_seed(cfg):
    """The first seed whose frozen rollout moves the cut within 4 steps
    (the agent's float32 training is this CPU's; seed 1 moves it on the
    machines this was written on)."""
    from types import SimpleNamespace

    for seed in range(1, 9):
        sched = train._lm_ddqn_schedule("ddqn:2", SimpleNamespace(
            seed=seed, cohort=None), cfg, None, 4, 2, 32, "cpu")
        if len({sched(i) for i in range(4)}) > 1:
            return seed
    raise AssertionError("no seed in 1..8 moves the cut")


def test_lm_ddqn_follows_its_rollout_and_resumes(monkeypatch, tmp_path):
    cfg = reduced_config(get_config("granite-8b")).with_overrides(
        num_layers=3)
    argv = BASE + ["--seed", str(_moving_seed(cfg))]
    scheds = []
    orig = train._lm_ddqn_schedule
    monkeypatch.setattr(train, "_lm_ddqn_schedule", lambda *a: scheds.append(
        orig(*a)) or scheds[-1])
    a, b, c = (str(tmp_path / f"{k}.ckpt") for k in "abc")
    run = str(tmp_path / "run")
    res = train.main(argv + ["--steps", "4", "--checkpoint", c,
                             "--metrics-dir", run])
    sched = scheds[0]
    cuts = [sched(i) for i in range(4)]
    assert len(set(cuts)) > 1
    events = _events(run)
    assert [e["cut"] for e in events if e.get("name") == "step_traffic"] \
        == cuts
    migs = [e for e in events if e.get("kind") == "migration"]
    assert len(migs) == res["n_migrations"] == sum(
        x != y for x, y in zip(cuts, cuts[1:]))
    total = 0
    for e in migs:
        mb = migration_bits(
            split.client_param_numel(lm.build_plan(cfg, e["cut_from"])),
            split.client_param_numel(lm.build_plan(cfg, e["cut"])),
            n_clients=4, raw_bits_per_elem=32)
        assert e["modeled"] == e["measured"] == mb
        total += mb["total_bits"]
    assert res["migration_bits"] == total
    train.main(argv + ["--steps", "2", "--checkpoint", a])
    train.main(argv + ["--steps", "2", "--resume", a, "--checkpoint", b])
    assert all(s.cuts == sched.cuts for s in scheds)
    assert load_checkpoint_meta(b)["step"] == 4
    with open(b, "rb") as fb, open(c, "rb") as fc:
        assert fb.read() == fc.read()


def test_lm_ddqn_needs_a_cut_to_move():
    with pytest.raises(SystemExit, match="ddqn needs >= 2 layers"):
        train.main(BASE + ["--layers", "1", "--steps", "1"])
