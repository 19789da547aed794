"""The buffered-async LM loop on the port against the reference's on the
CPU, from the reference's weights:

* ``make_gen_step`` (the dispatch-time compute: tau local steps without
  the round-end aggregation) at tau 1 and 2 on reduced granite-8b (3
  layers, d 64, vocab 256): the loss within 1e-5 relative, the f32
  server delta and the absolute client rows within 2e-5 absolute; an int
  codec's case starts from the reference's state (ROADMAP C3). Schemes
  that aggregate client sides are refused with the reference's message.
* The launcher's LM ``--async`` (``_LMAsyncExecutor``) against the
  reference's ``train_lm`` on the same flags (smoke granite-8b, 3
  layers): the engine's stats (merges, dispatches, the virtual clock,
  staleness) and the traffic exactly, the first and final losses within
  1e-5 relative, the checkpoint's meta and tree the reference's; every
  ``async_traffic`` event of the port's run reconciles, and its metrics
  directory passes the reference's ``report --strict``.
* The reference's refusals of ``--async`` in LM mode hold, message for
  message.
"""
import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.obs import report  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (TrainConfig, get_config,  # noqa: E402
                                 reduced_config)
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

K, B, S, VOCAB = 3, 2, 16, 256
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
OVER = dict(num_layers=3, d_model=64, d_ff=128, vocab_size=VOCAB)
BASE = ["--arch", "granite-8b", "--preset", "smoke", "--layers", "3",
        "--seq", "32", "--log-every", "100", "--quiet"]
ASYNC = ["--steps", "3", "--clients", "8", "--cohort", "4", "--async",
         "--buffer", "2", "--straggler", "8"]


def _port(jtree, plan):
    return convert.split_from_jax(jax.tree.map(np.asarray, jtree), plan)


def _close(port, ref, atol=PARAM_ATOL):
    pl, rl = tree_leaves(port), tree_leaves(ref)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        torch.testing.assert_close(p, r, rtol=0, atol=atol)


@pytest.mark.parametrize("tau,algo,codec,cohort", [
    (1, "psl", "int8", True), (2, "sfl_ga", "fp32", False)])
def test_gen_step_matches_reference(tau, algo, codec, cohort):
    jcfg = jreduced(jget_config("granite-8b")).with_overrides(**OVER)
    cfg = reduced_config(get_config("granite-8b")).with_overrides(**OVER)
    jplan, plan = jlm.build_plan(jcfg, 1), lm.build_plan(cfg, 1)
    rng = np.random.RandomState(0)
    jsplit = jalg.split_lm_params(jlm.init_lm(jax.random.key(0), jplan,
                                              jnp.float32), K)
    jsplit = dict(jsplit, client=jax.tree.map(
        lambda x: x + jnp.asarray(rng.randn(*x.shape).astype(np.float32)
                                  * 0.01) if x.ndim >= 2 else x,
        jsplit["client"]))
    kw = dict(algo=algo, cut_layer=1, compute_dtype="float32",
              param_dtype="float32", lr=0.05, remat=False, tau=tau,
              uplink_codec=codec, downlink_codec=codec, seed=3)
    jopt, opt = jmake_optimizer("sgd", 0.05), make_optimizer("sgd", 0.05)
    jgen = jax.jit(jalg.make_gen_step(jplan, JTrainConfig(model=jcfg, **kw),
                                      jopt, K))
    gen = alg.make_gen_step(plan, TrainConfig(model=cfg, **kw), opt, K)
    shape = (K, B, S) if tau == 1 else (K, tau, B, S)
    toks = rng.randint(0, VOCAB, shape).astype(np.int32)
    labels = rng.randint(0, VOCAB, shape).astype(np.int32)
    seed = np.uint32(1000003 * 5)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "seed": seed}
    pb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
          "seed": seed}
    if cohort:
        w = np.array([0.9, 1.2, 0.6], np.float32)
        jb["rho"], pb["rho"] = jnp.asarray(w), w
    split = _port(jsplit, plan)
    jout, jst = jgen(jsplit, jopt.init(jsplit), jb)
    out, st = gen(split, opt.init(split), pb)
    want = float(jout["loss"])
    assert abs(float(out["loss"]) - want) <= LOSS_RTOL * abs(want)
    assert int(st["count"]) == int(jst["count"]) == tau
    # the delta is f32 against the dispatch-time server; the client rows
    # are absolute
    assert all(d.dtype == torch.float32
               for d in tree_leaves(out["server_delta"]))
    want = _port({"client": jout["client"], "server": jout["server_delta"]},
                 plan)
    _close(out["server_delta"], want["server"])
    _close(out["client"], want["client"])
    # the input was not changed in place
    for a, b in zip(tree_leaves(split), tree_leaves(_port(jsplit, plan))):
        assert torch.equal(a, b)


def test_gen_step_refuses_client_aggregation():
    cfg = reduced_config(get_config("granite-8b")).with_overrides(**OVER)
    jcfg = jreduced(jget_config("granite-8b")).with_overrides(**OVER)
    plan, jplan = lm.build_plan(cfg, 1), jlm.build_plan(jcfg, 1)
    msgs = []
    for fn, c, p in ((alg.make_gen_step, cfg, plan),
                     (jalg.make_gen_step, jcfg, jplan)):
        tc = (TrainConfig if c is cfg else JTrainConfig)(model=c, algo="sfl")
        with pytest.raises(ValueError, match="aggregates client") as e:
            fn(p, tc, make_optimizer("sgd", 0.05), K)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _header(path):
    with open(path, "rb") as f:
        return msgpack.Unpacker(f, raw=False).unpack()


@pytest.fixture
def reference_init(monkeypatch):
    """The port's launcher starts from the reference's ``init_lm`` draw."""
    def init_lm(seed, plan, dtype=torch.float32, device="cuda"):
        jcfg = jreduced(jget_config("granite-8b")).with_overrides(
            num_layers=plan.cfg.num_layers)
        p = jlm.init_lm(jax.random.key(seed), jlm.build_plan(jcfg, plan.cut),
                        jnp.float32)
        return convert.params_from_jax(jax.tree.map(np.asarray, p), plan,
                                       device)

    monkeypatch.setattr(lm, "init_lm", init_lm)


def test_async_launch_matches_reference(reference_init, monkeypatch,
                                        tmp_path):
    got = {}
    orig = jtrain.train_lm
    monkeypatch.setattr(jtrain, "train_lm",
                        lambda a: got.setdefault("ref", orig(a)))
    jck, ck = str(tmp_path / "ref.ckpt"), str(tmp_path / "port.ckpt")
    jtrain.main(BASE + ASYNC + ["--checkpoint", jck])
    ref = got["ref"]
    run = str(tmp_path / "run")
    port = train.main(BASE + ASYNC + ["--device", "cpu", "--metrics-dir",
                                      run, "--checkpoint", ck])
    assert port["async"] == ref["async"]
    assert port["async"]["merges"] > 3  # the drain merged the rest
    assert port["comm"] == ref["comm"]
    for k in ("first_loss", "final_loss"):
        assert abs(port[k] - ref[k]) <= LOSS_RTOL * abs(ref[k]), k
    # the header: the tree, shapes and dtypes, and the meta (its loss
    # within the losses' tolerance)
    jhead, head = _header(jck), _header(ck)
    jloss, loss = jhead["meta"].pop("final_loss"), head["meta"].pop(
        "final_loss")
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)
    assert head == jhead and list(head["meta"]) == list(jhead["meta"])
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    traffic = [e for e in events if e.get("name") == "async_traffic"]
    assert len(traffic) == port["async"]["merges"]
    assert sum(len(e["dispatched"]) for e in traffic) == \
        port["async"]["dispatches"]
    assert all(e["measured"] == e["modeled"] for e in traffic)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert report.main([run, "--strict"]) == 0
    assert "== async engine ==" in buf.getvalue()


@pytest.mark.parametrize("extra,match", [
    (["--dynamic-cut", "1,2"], "cut-static"),
    (["--bank", "host", "--cohort", "2"], "needs --bank device"),
    (["--scheme", "sfl"], "sfl_ga/psl"),
    (["--optimizer", "momentum"], "optimizer sgd")],
    ids=["dynamic-cut", "host-bank", "sfl", "momentum"])
def test_async_refusals_are_the_reference(extra, match):
    argv = BASE + ["--steps", "1", "--async"] + extra
    with pytest.raises(SystemExit, match=match) as want:
        jtrain.main(argv)
    with pytest.raises(SystemExit, match=match) as got:
        train.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_async_refuses_resume(tmp_path):
    """The reference's file of a barrier run; an async resume of it is
    refused in both packages."""
    ck = str(tmp_path / "a.ckpt")
    jtrain.main(BASE + ["--steps", "1", "--checkpoint", ck])
    msgs = []
    for main, extra in ((jtrain.main, []), (train.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="--resume") as e:
            main(BASE + ["--steps", "1", "--async", "--resume", ck] + extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
