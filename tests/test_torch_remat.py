"""Remat in the LM train step (``TrainConfig.remat``, the reference's
default): each layer of both halves is checkpointed
(``models.transformer.remat_layer``), the client's as one ``vmap`` a
layer (``core.algorithms._client_forward``).

* Two steps with ``remat=False`` and ``remat=True`` from the same params
  and batches give the same params, optimizer state and metrics, bit for
  bit (``torch.equal``): the checkpoint recomputes the same ops, and the
  backward walks the forward's own graph. Covered: reduced granite-8b
  under sfl_ga fp32 and int8 and under sfl, tau 2, LoRA, precomputed
  embeddings (qwen2-vl), a reduced MoE arch (the balance loss), reduced
  mamba2-130m, and ``make_gen_step``.
* One case against the reference, both sides with ``remat=True``, held
  to ``test_torch_lm_train.py``'s tolerances.
* On fake tensors (``analysis.roofline.OpCounter``), remat raises a
  step's FLOPs by the recomputed forward and lowers its peak live
  storage; both figures are stated below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis.roofline import OpCounter  # noqa: E402
from repro_torch.configs import (PeftSpec, TrainConfig, get_config,  # noqa: E402
                                 reduced_config)
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

N, B, S = 3, 2, 16
# the reference-parity tolerances of test_torch_lm_train.py
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
SMALL = dict(num_layers=4, d_model=64, d_ff=128, vocab_size=256)
OVER = {"granite-8b": SMALL, "qwen2-vl-2b": SMALL,
        "qwen3-moe-30b-a3b": dict(num_layers=3),
        "mamba2-130m": dict(num_layers=3, d_model=64, vocab_size=256)}


def _cfg(arch):
    return reduced_config(get_config(arch)).with_overrides(**OVER[arch])


def _setup(arch, cut, peft, algo, codec, tau, remat, opt="sgd"):
    cfg = _cfg(arch)
    spec = PeftSpec(rank=4, alpha=8.0) if peft else None
    plan = lm.build_plan(cfg, cut, peft=spec)
    base = lm.init_lm(0, plan, device="cpu")
    split = (alg.split_lm_lora_params(
        base, lm.init_lm_loras(1, plan, device="cpu"), N) if peft
        else alg.split_lm_params(base, N))
    tcfg = TrainConfig(model=cfg, algo=algo, cut_layer=cut,
                       compute_dtype="float32", param_dtype="float32",
                       lr=0.05, remat=remat, tau=tau, uplink_codec=codec,
                       downlink_codec=codec, peft="lora" if peft else "none",
                       lora_rank=4, lora_alpha=8.0)
    return cfg, plan, split, tcfg, make_optimizer(opt, 0.05)


def _batches(cfg, tau, embeds, steps=2):
    rng = np.random.RandomState(0)
    shape = (N, B, S) if tau == 1 else (N, tau, B, S)
    out = []
    for i in range(steps):
        toks = (rng.randn(*shape, cfg.d_model).astype(np.float32) if embeds
                else rng.randint(0, cfg.vocab_size, shape))
        out.append({"tokens": torch.from_numpy(toks),
                    "labels": torch.from_numpy(
                        rng.randint(0, cfg.vocab_size, shape)),
                    "seed": np.uint32(11 + 1000003 * i)})
    return out


def _train(remat, arch, cut, peft, algo, codec, tau, opt, embeds):
    cfg, plan, split, tcfg, o = _setup(arch, cut, peft, algo, codec, tau,
                                       remat, opt)
    step = alg.make_train_step(plan, tcfg, o, N)
    state = o.init(alg.trainable_params(split))
    metrics = []
    for b in _batches(cfg, tau, embeds):
        split, state, m = step(split, state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return split, state, metrics


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# (arch, cut, peft, algo, codec, tau, optimizer, precomputed embeddings)
CASES = [
    ("granite-8b", 2, False, "sfl_ga", "fp32", 1, "sgd", False),
    ("granite-8b", 2, False, "sfl_ga", "int8", 1, "sgd", False),
    ("granite-8b", 2, False, "sfl", "fp32", 1, "momentum", False),
    ("granite-8b", 2, False, "sfl_ga", "fp32", 2, "sgd", False),
    ("granite-8b", 2, True, "sfl_ga", "int8", 1, "adamw", False),
    ("qwen2-vl-2b", 2, False, "psl", "fp32", 1, "sgd", True),
    ("qwen3-moe-30b-a3b", 1, False, "sfl_ga", "fp32", 1, "sgd", False),
    ("mamba2-130m", 1, False, "sfl_ga", "fp32", 1, "sgd", False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_remat_step_equals_plain_step_bit_for_bit(case):
    plain = _train(False, *case)
    remat = _train(True, *case)
    _equal(plain[0], remat[0])
    _equal(plain[1], remat[1])
    assert plain[2] == remat[2]
    if case[0] == "qwen3-moe-30b-a3b":  # the balance loss is in the sum
        assert all(m["loss"] != m["ce"] for m in remat[2])


def test_gen_step_with_remat_equals_plain_bit_for_bit():
    outs = []
    for remat in (False, True):
        cfg, plan, split, tcfg, o = _setup("granite-8b", 2, False, "sfl_ga",
                                           "int8", 2, remat)
        gen = alg.make_gen_step(plan, tcfg, o, N)
        outs.append(gen(split, o.init(split), _batches(cfg, 2, False, 1)[0]))
    (a, sa), (b, sb) = outs
    assert float(a["loss"]) == float(b["loss"])
    _equal(a["server_delta"], b["server_delta"])
    _equal(a["client"], b["client"])
    _equal(sa, sb)


def test_remat_step_matches_reference_with_remat():
    """Both sides with ``remat=True`` (the reference's
    ``jax.checkpoint`` of its scan body; the port's per-layer
    checkpoint): two sfl_ga int8 steps at cut 2, the reference's state
    carried in before each step, as ``test_torch_lm_train.py`` does for
    int codecs."""
    over = SMALL
    jcfg = jreduced(jget_config("granite-8b")).with_overrides(**over)
    cfg = _cfg("granite-8b")
    jplan, plan = jlm.build_plan(jcfg, 2), lm.build_plan(cfg, 2)
    jsplit = jalg.split_lm_params(
        jlm.init_lm(jax.random.key(0), jplan, jnp.float32), N)
    rng = np.random.RandomState(1)
    jsplit = dict(jsplit, client=jax.tree.map(
        lambda x: x + jnp.asarray(rng.randn(*x.shape).astype(np.float32)
                                  * 0.01) if x.ndim >= 2 else x,
        jsplit["client"]))
    kw = dict(algo="sfl_ga", cut_layer=2, compute_dtype="float32",
              param_dtype="float32", lr=0.05, remat=True,
              uplink_codec="int8", downlink_codec="int8", seed=3)
    jopt, opt = jmake_optimizer("sgd", 0.05), make_optimizer("sgd", 0.05)
    jstep = jax.jit(jalg.make_train_step(
        jplan, JTrainConfig(model=jcfg, **kw), jopt, N))
    step = alg.make_train_step(plan, TrainConfig(model=cfg, **kw), opt, N)
    jstate = jopt.init(jsplit)

    def port(tree):
        return convert.split_from_jax(jax.tree.map(np.asarray, tree), plan)

    for b in _batches(cfg, 1, False):
        split, state = port(jsplit), opt.init(port(jsplit))
        jb = {"tokens": jnp.asarray(b["tokens"].numpy().astype(np.int32)),
              "labels": jnp.asarray(b["labels"].numpy().astype(np.int32)),
              "seed": b["seed"]}
        jsplit, jstate, jm = jstep(jsplit, jstate, jb)
        split, state, m = step(split, state, b)
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= LOSS_RTOL * abs(want)
        for p, r in zip(tree_leaves(split), tree_leaves(port(jsplit))):
            torch.testing.assert_close(p, r, rtol=0, atol=PARAM_ATOL)


def _fake_step(remat):
    """One sfl_ga step of reduced granite-8b at 4 layers (d 64, d_ff 128),
    cut 2, N 2, b 1, S 64, counted on fake tensors: (FLOPs, peak live
    bytes)."""
    cfg = _cfg("granite-8b")
    plan = lm.build_plan(cfg, 2)
    tcfg = TrainConfig(model=cfg, algo="sfl_ga", cut_layer=2,
                       compute_dtype="float32", param_dtype="float32",
                       remat=remat)
    opt = make_optimizer("sgd", 0.01)
    with FakeTensorMode():
        params = alg.split_lm_params(lm.init_lm(0, plan, device="cpu"), 2)
        step = alg.make_train_step(plan, tcfg, opt, 2)
        toks = torch.randint(0, cfg.vocab_size, (2, 2, 1, 64))
        counter = OpCounter()
        with counter:
            step(params, opt.init(params), {"tokens": toks[0],
                                            "labels": toks[1]})
    return counter.stats.flops, counter.stats.peak_bytes


def _layers_forward_flops():
    """The 4 layers' forward over the step's 128 tokens, counted alone."""
    cfg = _cfg("granite-8b")
    plan = lm.build_plan(cfg, 2)
    with FakeTensorMode():
        params = lm.init_lm(0, plan, device="cpu")
        x = torch.empty(2, 64, cfg.d_model)
        counter = OpCounter()
        with counter, torch.no_grad():
            tf.apply_groups_train(lm.all_group_params(params), cfg,
                                  lm.all_groups(plan), x,
                                  lm._positions(cfg, 2, 64))
    return counter.stats.flops


def test_remat_adds_the_recomputed_forward_and_lowers_the_peak():
    """The recompute is each layer's forward up to the last tensor its
    backward saved: everything but the MLP's down projection, whose
    output nothing saves (torch's early stop, as XLA drops the dead
    op). 128 tokens x d_ff 128 x d 64 x 2 = 2,097,152 FLOPs a layer
    stay out of the 109,051,904 of the 4 layers' forward: 100,663,296
    more FLOPs a step. The peak live storage falls from 7,301,928 to
    5,910,288 B."""
    plain_flops, plain_peak = _fake_step(False)
    remat_flops, remat_peak = _fake_step(True)
    fwd = _layers_forward_flops()
    down = 4 * 2 * 128 * 128 * 64
    assert fwd == 109_051_904 and down == 8_388_608
    assert remat_flops - plain_flops == fwd - down == 100_663_296
    assert (plain_peak, remat_peak) == (7_301_928, 5_910_288)
