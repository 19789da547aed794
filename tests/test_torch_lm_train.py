"""The split LM's training stack (``repro_torch.core.algorithms``) against
the reference's on the CPU, from the reference's weights.

* Layout functions: the conversion to and from the reference's stacked
  layout, cut migration (``resplit_*``), cohort gather/scatter and the
  global merge. Relayouts and broadcasts are held with ``torch.equal``,
  rho-averages within 1e-6 absolute (float32 sums of three terms).
* Accounting: ``comm_bytes_per_round`` / ``comm_breakdown_per_round``
  equal the reference's exactly for every scheme x codec x peft, and a
  step's traffic ledger equals the breakdown.
* ``make_train_step`` on reduced granite-8b and mamba2-130m (3 layers,
  d 64, vocab 256) over a covering subset of sfl_ga/sfl/psl x fp32/int8/
  int4 x tau 1/2 x sgd/momentum/adamw x full/LoRA, with and without
  cohort weights: two steps, the loss within 1e-5 relative and the
  params within 2e-5 absolute of the reference's. Int-codec cases carry
  the reference's state into the port before each step (a code that
  sits on a rounding boundary in float32 noise may round the other way,
  and training compounds it; see ``test_torch_simulator.py``), and so do
  the adamw cases, whose per-element rule is stated at ``LR``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.configs.base import PeftSpec as JPeftSpec  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (PeftSpec, TrainConfig, get_config,  # noqa: E402
                                 reduced_config)
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.protocol import ProtocolEngine  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs import TrafficLedger  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

N, B, S, VOCAB = 3, 2, 16, 256
# adamw moves an element by about lr * g / (|g| + eps) whatever the size of
# g, so an element whose gradient nearly cancels (|g| ~ 1e-8, the float32
# noise of the two frameworks' sums) may step anywhere in [-lr, lr] in
# either package. The adamw cases therefore carry the reference's state
# in before each step (as the int cases do), take an LM fine-tuning rate,
# and hold the params to PARAM_ATOL on all but ADAM_SHARE of the elements
# and to 2 lr (one step's reach) on every element; the optimizer itself is
# held element by element in test_torch_optim.py
LR = {"sgd": 0.05, "momentum": 0.05, "adamw": 1e-3}
ADAM_SHARE = 1e-3
AVG_TOL = 1e-6
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
OVER = {"granite-8b": dict(num_layers=3, d_model=64, d_ff=128,
                           vocab_size=VOCAB),
        "mamba2-130m": dict(num_layers=3, d_model=64, vocab_size=VOCAB)}


def _cfgs(arch):
    return (jreduced(jget_config(arch)).with_overrides(**OVER[arch]),
            reduced_config(get_config(arch)).with_overrides(**OVER[arch]))


def _setup(arch="granite-8b", peft=False, cut=1, distinct=True, n=N):
    """(reference plan, reference split), (port plan, port split) from the
    reference's draw; ``distinct`` gives every client its own copy."""
    jcfg, cfg = _cfgs(arch)
    jpeft = JPeftSpec(rank=4, alpha=8.0) if peft else None
    ppeft = PeftSpec(rank=4, alpha=8.0) if peft else None
    jplan = jlm.build_plan(jcfg, cut, peft=jpeft)
    plan = lm.build_plan(cfg, cut, peft=ppeft)
    base = jlm.init_lm(jax.random.key(0), jplan, jnp.float32)
    rng = np.random.RandomState(1)
    if peft:
        lo = jlm.init_lm_loras(jax.random.key(1), jplan, jnp.float32)
        lo = jax.tree.map(lambda x: x + jnp.asarray(
            rng.randn(*x.shape).astype(np.float32) * 0.02)
            if x.ndim >= 2 else x, lo)
        jsplit = jalg.split_lm_lora_params(base, lo, n)
    else:
        jsplit = jalg.split_lm_params(base, n)
    if distinct:
        jsplit = dict(jsplit, client=jax.tree.map(
            lambda x: x + jnp.asarray(rng.randn(*x.shape).astype(np.float32)
                                      * 0.01) if x.ndim >= 2 else x,
            jsplit["client"]))
    return (jplan, jsplit), (plan, _port(jsplit, plan))


def _port(jtree, plan):
    return convert.split_from_jax(jax.tree.map(np.asarray, jtree), plan)


def _leaves_close(port, ref, atol=0.0):
    pl, rl = tree_leaves(port), tree_leaves(ref)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        assert p.shape == r.shape
        if atol == 0.0:
            assert torch.equal(p, r)
        else:
            torch.testing.assert_close(p, r, rtol=0, atol=atol)


@pytest.mark.parametrize("peft", [False, True])
def test_layout_round_trip_is_exact(peft):
    """split_from_jax then split_to_jax gives back the reference's arrays,
    and so does an optimizer state's moments (adamw)."""
    (jplan, jsplit), (plan, split) = _setup(peft=peft, cut=2)
    back = convert.split_to_jax(split, plan)
    for got, want in zip(jax.tree.leaves(back, is_leaf=lambda x: hasattr(
            x, "parts")), jax.tree.leaves(jsplit)):
        got = got.numpy() if hasattr(got, "parts") else got.numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
    jst = jmake_optimizer("adamw", 1e-3).init(jalg.trainable_params(jsplit))
    st = convert.opt_state_from_jax(jax.tree.map(np.asarray, jst), plan)
    assert st["count"].dtype == torch.int32
    _leaves_close(st["m"], _port(jst["m"], plan))


@pytest.mark.parametrize("peft", [False, True])
@pytest.mark.parametrize("cuts", [(1, 2), (2, 1)])
def test_resplit_matches_reference(peft, cuts):
    """Cut migration from distinct client copies with a non-uniform rho:
    layers moving server->client are the reference's copies exactly,
    client->server rho-averages within AVG_TOL, the frozen base a pure
    relayout; moments migrate the same way."""
    (jplan, jsplit), (plan, split) = _setup(peft=peft, cut=cuts[0])
    rho = np.array([0.5, 0.3, 0.2], np.float32)
    jcfg, cfg = jplan.cfg, plan.cfg
    jpeft, ppeft = jplan.peft, plan.peft
    jst = jmake_optimizer("momentum", 1e-3).init(
        jalg.trainable_params(jsplit))
    jst = dict(jst, mu=jax.tree.map(lambda x: x + 1.0, jst["mu"]))
    st = convert.opt_state_from_jax(jax.tree.map(np.asarray, jst), plan)
    for v in cuts[1:]:
        jnew = jlm.build_plan(jcfg, v, peft=jpeft)
        new = lm.build_plan(cfg, v, peft=ppeft)
        jsplit = jalg.resplit_lm_params(jsplit, jplan, jnew,
                                        jnp.asarray(rho))
        split = alg.resplit_lm_params(split, plan, new, rho)
        jst = jalg.resplit_opt_state(jst, jplan, jnew, jnp.asarray(rho))
        st = alg.resplit_opt_state(st, plan, new, rho)
        jplan, plan = jnew, new
    want = _port(jsplit, plan)
    atol = AVG_TOL if cuts[1] < cuts[0] else 0.0
    _leaves_close(split["client"], want["client"], atol)
    _leaves_close(split["server"], want["server"], atol)
    if peft:
        _leaves_close(split["base"], want["base"])
    _leaves_close(st["mu"], _port(jst["mu"], plan), atol)


def test_resplit_round_trip_lossless_from_equal_copies():
    """v -> v' -> v from equal client copies is exact (the anchored
    average of equal rows is the row)."""
    (_, _), (plan, split) = _setup(cut=1, distinct=False)
    p2 = lm.build_plan(plan.cfg, 2)
    back = alg.resplit_lm_params(alg.resplit_lm_params(split, plan, p2,
                                                       [0.5, 0.3, 0.2]),
                                 p2, plan, [0.5, 0.3, 0.2])
    _leaves_close(back, split)


def test_cohort_gather_scatter_match_reference():
    (jplan, jsplit), (plan, split) = _setup(cut=2)
    idx = np.array([2, 0])
    jc, c = jalg.gather_cohort(jsplit, idx), alg.gather_cohort(split, idx)
    _leaves_close(c, _port(jc, plan))
    # a trained cohort: perturbed rows and a new server
    jc = jax.tree.map(lambda x: x * 1.5, jc)
    c = _port(jc, plan)
    for bcast in (False, True):
        _leaves_close(alg.scatter_cohort(split, c, idx, bcast),
                      _port(jalg.scatter_cohort(jsplit, jc, idx, bcast),
                            plan))
    jst = jmake_optimizer("adamw", 1e-3).init(jsplit)
    st = convert.opt_state_from_jax(jax.tree.map(np.asarray, jst), plan)
    jg = jalg.gather_cohort_opt(jst, idx)
    jg = dict(jg, m=jax.tree.map(lambda x: x - 2.0, jg["m"]))
    g = convert.opt_state_from_jax(jax.tree.map(np.asarray, jg), plan)
    _leaves_close(alg.scatter_cohort_opt(st, g, idx)["m"],
                  _port(jalg.scatter_cohort_opt(jst, jg, idx)["m"], plan))


@pytest.mark.parametrize("peft", [False, True])
def test_global_merge_matches_reference(peft):
    (jplan, jsplit), (plan, split) = _setup(peft=peft, cut=2)
    rho = np.array([0.2, 0.5, 0.3], np.float32)
    fn, jfn = ((alg.merge_lm_lora_params, jalg.merge_lm_lora_params) if peft
               else (alg.merge_lm_params, jalg.merge_lm_params))
    got = fn(split, rho)
    want = convert.params_from_jax(
        jax.tree.map(np.asarray, jfn(jsplit, jnp.asarray(rho))), plan)
    _leaves_close(got, want, AVG_TOL)


CODECS = ("fp32", "bf16", "int8", "int4", "topk10")


@pytest.mark.parametrize("peft", [False, True])
def test_comm_accounting_matches_reference(peft):
    jcfg, cfg = _cfgs("granite-8b")
    jpeft = JPeftSpec(rank=4, alpha=8.0) if peft else None
    ppeft = PeftSpec(rank=4, alpha=8.0) if peft else None
    for cut in (1, 2):
        jplan = jlm.build_plan(jcfg, cut, peft=jpeft)
        plan = lm.build_plan(cfg, cut, peft=ppeft)
        for algo in ("sfl_ga", "sfl", "psl", "fl"):
            for up in CODECS:
                for down in ("fp32", up):
                    for fn in ("comm_bytes_per_round",
                               "comm_breakdown_per_round"):
                        args = (algo, 3, 2, 32)
                        kw = dict(tau=2, bytes_per_elem=4,
                                  uplink_codec=up, downlink_codec=down)
                        assert getattr(alg, fn)(cfg, plan, *args, **kw) == \
                            getattr(jalg, fn)(jcfg, jplan, *args, **kw)


def _tcfgs(arch, algo, codec, tau, peft):
    jcfg, cfg = _cfgs(arch)
    kw = dict(algo=algo, cut_layer=1, compute_dtype="float32",
              param_dtype="float32", lr=0.05, remat=False, tau=tau,
              uplink_codec=codec, downlink_codec=codec,
              peft="lora" if peft else "none", lora_rank=4, lora_alpha=8.0,
              seed=3)
    return JTrainConfig(model=jcfg, **kw), TrainConfig(model=cfg, **kw)


def _batch(rng, tau, n=N):
    shape = (n, B, S) if tau == 1 else (n, tau, B, S)
    toks = rng.randint(0, VOCAB, shape).astype(np.int32)
    labels = rng.randint(0, VOCAB, shape).astype(np.int32)
    return toks, labels


# (arch, algo, codec, tau, optimizer, peft, cohort weights)
STEP_CASES = [
    ("granite-8b", "sfl_ga", "fp32", 1, "sgd", False, False),
    ("granite-8b", "sfl_ga", "int8", 2, "momentum", True, False),
    ("granite-8b", "sfl", "fp32", 2, "adamw", False, True),
    ("granite-8b", "sfl", "int8", 1, "sgd", True, True),
    ("granite-8b", "psl", "int4", 2, "sgd", False, False),
    ("granite-8b", "psl", "fp32", 1, "adamw", True, True),
    ("mamba2-130m", "sfl_ga", "fp32", 2, "adamw", False, False),
    ("mamba2-130m", "psl", "int8", 1, "sgd", False, True),
]


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_train_step_matches_reference(case):
    arch, algo, codec, tau, optname, peft, cohort = case
    (jplan, jsplit), (plan, split) = _setup(arch, peft=peft, distinct=False)
    jt, pt = _tcfgs(arch, algo, codec, tau, peft)
    jopt = jmake_optimizer(optname, LR[optname])
    popt = make_optimizer(optname, LR[optname])
    jstate = jopt.init(jalg.trainable_params(jsplit))
    state = popt.init(alg.trainable_params(split))
    jstep = jax.jit(jalg.make_train_step(jplan, jt, jopt, N))
    step = alg.make_train_step(plan, pt, popt, N)
    rng = np.random.RandomState(2)
    w = np.array([0.9, 1.2, 0.6], np.float32) if cohort else None
    for i in range(2):
        toks, labels = _batch(rng, tau)
        seed = np.uint32(11 + 1000003 * i)
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "seed": seed}
        pb = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels), "seed": seed}
        if cohort:
            jb["rho"], pb["rho"] = jnp.asarray(w), w
        if codec != "fp32" or optname == "adamw":  # the reference's state
            split = _port(jsplit, plan)
            state = convert.opt_state_from_jax(
                jax.tree.map(np.asarray, jstate), plan)
        jsplit, jstate, jm = jstep(jsplit, jstate, jb)
        split, state, m = step(split, state, pb)
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= LOSS_RTOL * abs(want)
        assert int(state["count"]) == int(jstate["count"])
        got = alg.trainable_params(split)
        want = _port(jalg.trainable_params(jsplit), plan)
        if optname != "adamw":
            _leaves_close(got, want, PARAM_ATOL)
            continue
        err = torch.cat([(p - r).abs().reshape(-1) for p, r in zip(
            tree_leaves(got), tree_leaves(want))])
        assert float(err.max()) <= 2 * LR["adamw"]
        assert float((err > PARAM_ATOL).float().mean()) <= ADAM_SHARE
    if algo == "sfl":  # the client copies are one model after sfl
        for leaf in tree_leaves(split["client"]):
            assert torch.equal(leaf, leaf[:1].expand_as(leaf))


@pytest.mark.parametrize("algo,codec,peft", [
    ("sfl_ga", "int8", False), ("sfl", "fp32", True), ("psl", "int4", True),
    ("sfl", "int8", False)])
def test_step_ledger_equals_breakdown(algo, codec, peft):
    """The engine's taps over one tau = 2 step (cohort of 3) equal
    ``comm_breakdown_per_round`` per category, adapters included."""
    (_, _), (plan, split) = _setup(peft=peft, distinct=False)
    _, pt = _tcfgs("granite-8b", algo, codec, 2, peft)
    eng = ProtocolEngine(algo, codec, codec, adapter_sync=peft)
    ledger = TrafficLedger()
    eng.attach_ledger(ledger, raw_bits_per_elem=32.0,
                      label_bits_per_epoch=B * S * 32)
    popt = make_optimizer("sgd", 0.05)
    step = alg.make_train_step(plan, pt, popt, N, engine=eng)
    toks, labels = _batch(np.random.RandomState(0), 2)
    step(split, popt.init(alg.trainable_params(split)),
         {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels), "seed": np.uint32(5)})
    assert ledger.snapshot_and_reset() == alg.comm_breakdown_per_round(
        plan.cfg, plan, algo, N, B, S, tau=2, bytes_per_elem=4,
        uplink_codec=codec, downlink_codec=codec)


def test_train_step_refusals():
    (_, _), (plan, split) = _setup(distinct=False)
    _, pt = _tcfgs("granite-8b", "sfl_ga", "fp32", 2, False)
    popt = make_optimizer("sgd", 0.05)
    step = alg.make_train_step(plan, pt, popt, N)
    toks, labels = _batch(np.random.RandomState(0), 1)
    with pytest.raises(ValueError, match="local-epoch axis"):
        step(split, popt.init(split), {"tokens": torch.from_numpy(toks),
                                       "labels": torch.from_numpy(labels)})
    _, bad = _tcfgs("granite-8b", "fl", "fp32", 1, False)
    with pytest.raises(ValueError, match="algo"):
        alg.make_train_step(plan, bad, popt, N)


def test_prefill_and_dense_decode_match_reference():
    """The serving steps on the composed model: last-position logits of
    the prefill and of three dense decode steps within 1e-4."""
    (jplan, jsplit), (plan, split) = _setup(distinct=False)
    jparams, params = jalg.merge_lm_params(jsplit), alg.merge_lm_params(split)
    toks = np.random.RandomState(4).randint(0, VOCAB, (2, 10)).astype(
        np.int32)
    jl, jc = jalg.make_prefill_step(jplan, jnp.float32)(
        jparams, {"tokens": jnp.asarray(toks)})
    pl, pc = alg.make_prefill_step(plan)(
        params, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    # the reference decodes into a cache sized at prefill; grow both by 3
    jcaches = jlm.init_caches(jplan, 2, 13, jnp.float32)
    caches = lm.init_caches(plan, 2, 13, device="cpu")
    jdec = jalg.make_decode_step(jplan, jnp.float32)
    dec = alg.make_decode_step(plan)
    for t in range(3):
        tok = toks[:, t:t + 1]
        jl, jcaches = jdec(jparams, jnp.asarray(tok), jcaches)
        pl, caches = dec(params, torch.from_numpy(tok).long(), caches)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
