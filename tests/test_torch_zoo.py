"""Every decoder architecture of the zoo on the port against the reference
on the CPU: the seven the port took on with MoE, Jamba's hybrid, M-RoPE
and the sliding-window ring cache (qwen3-moe-30b-a3b, kimi-k2-1t-a32b,
jamba-v0.1-52b, command-r-35b, granite-20b, starcoder2-3b, qwen2-vl-2b),
at ``reduced_config`` sizes from the reference's ``init_lm`` weights
(``convert.params_from_jax``), as ``tests/test_smoke_archs.py`` runs them
but held to the reference's numbers:

* the split forward's logits and the MoE aux loss, within LOGITS_TOL;
* one sfl_ga train step (sgd): the loss within 1e-5 relative, the params
  within 2e-5 absolute; MoE LoRA (router targeted) under adamw with the
  element rule of ``test_torch_lm_train.py``;
* prefill and two dense decode steps, logits within LOGITS_TOL;
* the serve engine (paged decode) on the MoE, the Jamba and the M-RoPE
  models: the reference's greedy streams token for token, dead slots'
  tokens competing for expert capacity as they do there;
* M-RoPE with distinct (t, h, w) planes; the ring cache across its wrap
  for prompts longer than, equal to and shorter than the window;
* cut migration, cohort rows and a checkpoint of a MoE model and of a
  Jamba period of eight layers, against the reference's, the checkpoint
  byte for byte.

Routing is compared through the model's outputs: an expert choice that
flipped on f32 noise would move a logit by far more than the tolerance,
and none does at these seeds (``test_torch_moe.py`` holds ``route``
itself under the near-tie rule).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as ref_obs  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.configs.base import PeftSpec as JPeftSpec  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.core import serve_engine as jserve  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import (ARCH_IDS, PeftSpec, TrainConfig,  # noqa: E402
                                 get_config, reduced_config)
from repro_torch.configs.base import reference_dict  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.serve_engine import ServeEngine, make_requests  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

NEW_ARCHS = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "jamba-v0.1-52b",
             "command-r-35b", "granite-20b", "starcoder2-3b", "qwen2-vl-2b"]
# logits of order 5 through two layers: the frameworks' f32 sums differ
# by about 5e-6 (test_torch_lm_forward.py)
LOGITS_TOL = 1e-4
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
ADAM_LR, ADAM_SHARE = 1e-3, 1e-3
N, B, S = 2, 2, 24


def _cfgs(arch, **over):
    return (jreduced(jget_config(arch)).with_overrides(**over),
            reduced_config(get_config(arch)).with_overrides(**over))


def _port(jtree, plan):
    return convert.split_from_jax(jax.tree.map(np.asarray, jtree), plan)


@functools.lru_cache(maxsize=None)
def _model(arch, cut=1, seed=0):
    """The reference's ``init_lm`` draw and its port, shared by the tests
    that only read them."""
    jcfg, cfg = _cfgs(arch)
    jplan, plan = jlm.build_plan(jcfg, cut), lm.build_plan(cfg, cut)
    jp = jlm.init_lm(jax.random.key(seed), jplan, jnp.float32)
    return (jplan, jp), (plan, convert.params_from_jax(
        jax.tree.map(np.asarray, jp), plan))


def _inputs(cfg, rng, shape):
    """Token ids, or for the VLM backbone precomputed patch embeddings
    (its vision encoder is a stub in both packages)."""
    if cfg.arch_type == "vlm":
        return rng.randn(*shape, cfg.d_model).astype(np.float32)
    return rng.randint(0, cfg.vocab_size, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(a) if a.dtype == np.float32 else \
        torch.from_numpy(a).long()


def _close(got, want, tol=LOGITS_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def test_registry_serves_every_decoder_arch():
    """Ten archs, the reference's registry in its order, and its configs
    field for field, whisper-tiny (encoder-decoder) among them."""
    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 10
    for a in ARCH_IDS:
        assert reference_dict(get_config(a)) == \
            dataclasses.asdict(jget_config(a))
        assert reference_dict(reduced_config(get_config(a))) == \
            dataclasses.asdict(jreduced(jget_config(a)))
    assert get_config("whisper-tiny").encoder.num_frames == 1500
    with pytest.raises(KeyError):
        get_config("whisper-small")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_reference(arch):
    (jplan, jp), (plan, p) = _model(arch)
    x = _inputs(plan.cfg, np.random.RandomState(1), (B, S))
    kw = ({"inputs_embeds": x} if x.dtype == np.float32 else {"tokens": x})
    jsm, jaux_c = jlm.client_forward(jp, jplan, remat=False,
                                     dtype=jnp.float32,
                                     **{k: jnp.asarray(v)
                                        for k, v in kw.items()})
    jlg, jaux_s = jlm.server_forward(jp, jplan, jsm, remat=False)
    sm, aux_c = lm.client_forward(p, plan, **{k: _t(v)
                                              for k, v in kw.items()})
    lg, aux_s = lm.server_forward(p, plan, sm)
    _close(sm, jsm)
    _close(lg, jlg)
    assert abs(float(aux_c) - float(jaux_c)) <= 1e-6
    assert abs(float(aux_s) - float(jaux_s)) <= 1e-6
    if plan.cfg.moe is not None:  # the reduced MoE models route in layer 1
        assert float(aux_s) > 0.0


def _train_case(arch, optname="sgd", peft=None):
    jcfg, cfg = _cfgs(arch)
    jpeft = None if peft is None else JPeftSpec(rank=4, alpha=8.0,
                                                targets=peft)
    ppeft = None if peft is None else PeftSpec(rank=4, alpha=8.0,
                                               targets=peft)
    jplan = jlm.build_plan(jcfg, 1, peft=jpeft)
    plan = lm.build_plan(cfg, 1, peft=ppeft)
    base = jlm.init_lm(jax.random.key(0), jplan, jnp.float32)
    rng = np.random.RandomState(1)
    if peft is None:
        jsplit = jalg.split_lm_params(base, N)
    else:
        lo = jlm.init_lm_loras(jax.random.key(1), jplan, jnp.float32)
        lo = jax.tree.map(lambda v: v + jnp.asarray(
            rng.randn(*v.shape).astype(np.float32) * 0.02)
            if v.ndim >= 2 else v, lo)
        jsplit = jalg.split_lm_lora_params(base, lo, N)
    lr = ADAM_LR if optname == "adamw" else 0.05
    kw = dict(algo="sfl_ga", cut_layer=1, compute_dtype="float32",
              param_dtype="float32", lr=lr, remat=False,
              peft="none" if peft is None else "lora", lora_rank=4,
              lora_alpha=8.0, seed=3)
    jstep = jax.jit(jalg.make_train_step(
        jplan, JTrainConfig(model=jcfg, **kw),
        jmake_optimizer(optname, lr), N))
    popt = make_optimizer(optname, lr)
    step = alg.make_train_step(plan, TrainConfig(model=cfg, **kw), popt, N)
    jopt = jmake_optimizer(optname, lr)
    jstate = jopt.init(jalg.trainable_params(jsplit))
    split = _port(jsplit, plan)
    state = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                       plan)
    toks = _inputs(cfg, rng, (N, B, S))
    labels = rng.randint(0, cfg.vocab_size, (N, B, S)).astype(np.int32)
    seed = np.uint32(11)
    jsplit, jstate, jm = jstep(jsplit, jstate, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
        "seed": seed})
    split, state, m = step(split, state, {
        "tokens": _t(toks), "labels": _t(labels), "seed": seed})
    want = float(jm["loss"])
    assert abs(float(m["loss"]) - want) <= LOSS_RTOL * abs(want)
    got = tree_leaves(alg.trainable_params(split))
    ref = tree_leaves(_port(jalg.trainable_params(jsplit), plan))
    assert len(got) == len(ref)
    err = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(got, ref)])
    if optname == "adamw":
        assert float(err.max()) <= 2 * ADAM_LR
        assert float((err > PARAM_ATOL).float().mean()) <= ADAM_SHARE
    else:
        assert float(err.max()) <= PARAM_ATOL
    return float(m["loss"]), float(m["ce"])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_sfl_ga_step_matches_reference(arch):
    loss, ce = _train_case(arch)
    if get_config(arch).moe is not None:
        assert loss > ce  # the train loss carries 0.01 x the aux


def test_moe_lora_router_adamw_step_matches_reference():
    """LoRA on attention and the router of a MoE model: the adapters on
    p["moe"]["router"] train, the experts stay frozen."""
    _train_case("qwen3-moe-30b-a3b", "adamw", peft=("attn", "router"))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    (jplan, jp), (plan, p) = _model(arch, cut=0)
    cfg = plan.cfg
    rng = np.random.RandomState(2)
    x = _inputs(cfg, rng, (B, 10))
    emb = x.dtype == np.float32
    kw = "inputs_embeds" if emb else "tokens"
    jl, jc = jlm.prefill(jp, jplan, **{kw: jnp.asarray(x)}, max_len=13,
                         dtype=jnp.float32)
    pl, pc = lm.prefill(p, plan, **{kw: _t(x)}, max_len=13)
    _close(pl, jl)
    for t in range(2):
        if emb:
            tok = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        else:
            tok = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jlm.decode_step(jp, jplan, jnp.asarray(tok), jc,
                                 dtype=jnp.float32)
        pl, pc = lm.decode_step(p, plan, _t(tok), pc)
        _close(pl, jl)


# ---------------------------------------------------------------------------
# The serve engine: paged decode over MoE, hybrid and M-RoPE layers
# ---------------------------------------------------------------------------

PROMPT, GENS, USERS, SLOTS, PAGE = 9, [6, 3, 5], 5, 3, 8
MARGIN = 1e-4  # a greedy step means something only above f32 noise


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-v0.1-52b",
                                  "qwen2-vl-2b"])
def test_serve_streams_match_reference(arch):
    """Greedy fp32 streams of U 5 users over 3 slots: the reference's
    token for token, with every step's top-2 margin above MARGIN. At 3
    slots a MoE decode step has capacity ceil(2 x 3 x 1.25 / 4) = 2 an
    expert, shared with the dead slots' rows, which both engines feed
    alike."""
    (jplan, jp), (plan, p) = _model(arch, cut=1)
    max_len = PROMPT + max(GENS)
    with ref_obs.use_recorder(ref_obs.Recorder()):
        je = jserve.ServeEngine(jp, jplan, slots=SLOTS, max_len=max_len,
                                page_size=PAGE)
        for r in jserve.make_requests(USERS, PROMPT, GENS,
                                      vocab_size=plan.cfg.vocab_size,
                                      seed=0):
            je.submit(r)
        je.run()
    margins = []
    with obs.use_recorder(obs.Recorder()):
        e = ServeEngine(p, plan, slots=SLOTS, max_len=max_len,
                        page_size=PAGE, device="cpu")
        for r in make_requests(USERS, PROMPT, GENS,
                               vocab_size=plan.cfg.vocab_size, seed=0):
            e.submit(r)
        while e.queue or e._live.any():
            live = e._live.copy()
            e.step()
            if live.any():
                top2 = e.last_logits[torch.from_numpy(live)].topk(2).values
                margins.append(float((top2[:, 0] - top2[:, 1]).min()))
    streams = {c.uid: list(c.tokens) for c in e.completions}
    assert len(streams) == USERS
    assert streams == {c.uid: list(c.tokens) for c in je.completions}
    assert min(margins) > MARGIN, min(margins)


def test_sliding_window_refuses_paged_serving():
    (_, _), (plan, p) = _model("starcoder2-3b", cut=1)
    with pytest.raises(ValueError, match="full-causal only"):
        ServeEngine(p, plan, slots=2, max_len=16, device="cpu")


# ---------------------------------------------------------------------------
# M-RoPE and the ring cache
# ---------------------------------------------------------------------------

def _planes(rng, b, s):
    """Distinct (t, h, w) position planes, as an image's patches have."""
    return np.stack([np.sort(rng.randint(0, 50, (b, s)), -1)
                     for _ in range(3)]).astype(np.int32)


def test_mrope_planes_match_reference():
    """rope_sin_cos over (3, B, S) planes with the reduced and the full
    qwen2-vl sections, and client_forward given such positions."""
    rng = np.random.RandomState(5)
    pos = _planes(rng, 2, 12)
    for hd, sections in ((64, (8, 12, 12)), (128, (16, 24, 24))):
        js, jc = jblocks.rope_sin_cos(jnp.asarray(pos), hd, 1e6, sections)
        s, c = blocks.rope_sin_cos(torch.from_numpy(pos), hd, 1e6, sections)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    with pytest.raises(ValueError, match="3, B, S"):
        blocks.rope_sin_cos(torch.from_numpy(pos[0]), 64, 1e6, (8, 12, 12))
    (jplan, jp), (plan, p) = _model("qwen2-vl-2b", cut=1)
    emb = rng.randn(2, 12, plan.cfg.d_model).astype(np.float32)
    jsm, _ = jlm.client_forward(jp, jplan, inputs_embeds=jnp.asarray(emb),
                                positions=jnp.asarray(pos), remat=False,
                                dtype=jnp.float32)
    sm, _ = lm.client_forward(p, plan, inputs_embeds=torch.from_numpy(emb),
                              positions=torch.from_numpy(pos))
    _close(sm, jsm)
    default, _ = lm.client_forward(p, plan,
                                   inputs_embeds=torch.from_numpy(emb))
    assert not torch.allclose(default, sm)  # the planes were used


@pytest.mark.parametrize("prompt", [80, 64, 40])
def test_ring_cache_across_its_wrap(prompt):
    """starcoder2 reduced (window 64): a prompt longer than, equal to and
    shorter than the window, then 6 decode steps. At 80 and 64 tokens the
    ring is full from the prefill on and every step overwrites its oldest
    row; at 40 the cache (46 rows) never fills.
    The cache rows and every step's logits hold against the reference's
    ``prefill``/``decode_step``, and the logits against the windowed
    full-sequence forward over prompt + fed tokens at that position."""
    (jplan, jp), (plan, p) = _model("starcoder2-3b", cut=0)
    cfg = plan.cfg
    assert cfg.sliding_window == 64
    rng = np.random.RandomState(prompt)
    steps = 6
    toks = rng.randint(0, cfg.vocab_size, (1, prompt + steps)).astype(
        np.int32)
    max_len = prompt + steps
    jl, jc = jlm.prefill(jp, jplan, jnp.asarray(toks[:, :prompt]),
                         max_len=max_len, dtype=jnp.float32)
    pl, pc = lm.prefill(p, plan, _t(toks[:, :prompt]), max_len=max_len)
    _close(pl, jl)
    cap = min(max_len, 64)
    kv = pc[0][0][0]
    assert kv.k.shape[1] == cap and kv.length == prompt
    _close(kv.k, jc[0][0].k[0])
    for t in range(steps):
        tok = toks[:, prompt + t:prompt + t + 1]
        jl, jc = jlm.decode_step(jp, jplan, jnp.asarray(tok), jc,
                                 dtype=jnp.float32)
        pl, pc = lm.decode_step(p, plan, _t(tok), pc)
        _close(pl, jl)
        n = prompt + t + 1
        h, _ = tf.apply_groups_train(
            lm.all_group_params(p), cfg, lm.all_groups(plan),
            blocks.embed(p["embed"], _t(toks[:, :n]), torch.float32),
            lm._positions(cfg, 1, n))
        full = lm.logits_from_hidden(p, cfg, h[:, -1:])
        torch.testing.assert_close(pl, full, atol=LOGITS_TOL,
                                   rtol=LOGITS_TOL)
    _close(pc[0][0][0].k, jc[0][0].k[0])


# ---------------------------------------------------------------------------
# Migration, cohorts and checkpoints of MoE and hybrid layers
# ---------------------------------------------------------------------------

# Jamba's period at reduced widths: 8 layers, attention at offset 4, MoE
# on the odd layers (the published pattern, one period)
JAMBA_PERIOD = dict(num_layers=8, hybrid_period=8, hybrid_attn_offsets=(4,))
MIGRATIONS = {"qwen3-moe-30b-a3b": (dict(num_layers=3), (1, 2, 1)),
              "jamba-v0.1-52b": (JAMBA_PERIOD, (3, 5, 3))}


def _split_case(arch, cut):
    over, _ = MIGRATIONS[arch]
    jcfg, cfg = _cfgs(arch, **over)
    jplan, plan = jlm.build_plan(jcfg, cut), lm.build_plan(cfg, cut)
    jsplit = jalg.split_lm_params(jlm.init_lm(jax.random.key(0), jplan,
                                              jnp.float32), 3)
    rng = np.random.RandomState(1)
    jsplit = dict(jsplit, client=jax.tree.map(
        lambda x: x + jnp.asarray(rng.randn(*x.shape).astype(np.float32)
                                  * 0.01) if x.ndim >= 2 else x,
        jsplit["client"]))
    return (jplan, jsplit), (plan, _port(jsplit, plan))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_phi_counts_every_leaf(arch):
    """φ(v) (``client_param_numel``) is the client side's numel, leaf for
    leaf, at every cut of a 3-layer model: QK-norm scales, biases, a
    parallel block's single norm, MoE experts and routers, Mamba-2's
    extra leaves. The reference's count misses some of these (ROADMAP,
    differences kept on purpose); the port's migration and model-sync
    events measure the trees, so they reconcile only with the exact
    count."""
    from repro_torch.core import split

    cfg = reduced_config(get_config(arch)).with_overrides(num_layers=3)
    for cut in (1, 2):
        plan = lm.build_plan(cfg, cut)
        p = lm.init_lm(0, plan, device="cpu")
        assert split.client_param_numel(plan) == p["embed"]["table"].numel() \
            + sum(x.numel() for x in tree_leaves(p["client"]))


@pytest.mark.parametrize("arch", sorted(MIGRATIONS))
def test_migration_matches_reference(arch):
    """Cut moves across layers of different specs (attention and SSM
    mixers, MoE and dense FFNs): server->client copies exactly,
    client->server rho-averages within 1e-6, moments alike."""
    _, cuts = MIGRATIONS[arch]
    (jplan, jsplit), (plan, split) = _split_case(arch, cuts[0])
    if arch.startswith("jamba"):  # three specs side by side in a period
        assert len(set(jtf.layer_specs(jplan.cfg))) == 3
    rho = np.array([0.5, 0.3, 0.2], np.float32)
    jst = jmake_optimizer("momentum", 1e-3).init(jsplit)
    jst = dict(jst, mu=jax.tree.map(lambda x: x + 1.0, jst["mu"]))
    st = convert.opt_state_from_jax(jax.tree.map(np.asarray, jst), plan)
    for v in cuts[1:]:
        jnew = jlm.build_plan(jplan.cfg, v)
        new = lm.build_plan(plan.cfg, v)
        jsplit = jalg.resplit_lm_params(jsplit, jplan, jnew,
                                        jnp.asarray(rho))
        split = alg.resplit_lm_params(split, plan, new, rho)
        jst = jalg.resplit_opt_state(jst, jplan, jnew, jnp.asarray(rho))
        st = alg.resplit_opt_state(st, plan, new, rho)
        jplan, plan = jnew, new
        assert [(g.repeat, g.period) for g in lm.all_groups(plan)] == \
            [(g.repeat, g.period) for g in jlm.all_groups(jplan)]
    for got, want in ((split, _port(jsplit, plan)),
                      (st["mu"], _port(jst["mu"], plan))):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", sorted(MIGRATIONS))
def test_cohort_rows_and_checkpoint_are_the_reference_file(arch, tmp_path):
    """A cohort's rows are the reference's; the run state (params and
    adamw moments) written by the port is the reference's checkpoint byte
    for byte."""
    cut = MIGRATIONS[arch][1][1]
    (jplan, jsplit), (plan, split) = _split_case(arch, cut)
    idx = np.array([2, 0])
    for a, b in zip(tree_leaves(alg.gather_cohort(split, idx)),
                    tree_leaves(_port(jalg.gather_cohort(jsplit, idx),
                                      plan))):
        assert torch.equal(a, b)
    jst = jmake_optimizer("adamw", 1e-3).init(jsplit)
    jst = dict(jst, m=jax.tree.map(lambda x: x + 0.5, jst["m"]))
    meta = {"step": 2, "cut": cut, "arch": arch}
    jsave(str(tmp_path / "ref.ckpt"), {"params": jsplit, "opt": jst}, meta)
    state = convert.lm_state_from_jax(
        jax.tree.map(np.asarray, {"params": jsplit, "opt": jst}), plan)
    save_checkpoint(str(tmp_path / "port.ckpt"),
                    convert.lm_state_to_jax(state, plan), meta)
    with open(tmp_path / "ref.ckpt", "rb") as a, \
            open(tmp_path / "port.ckpt", "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

def test_lm_launcher_trains_moe_like_reference(monkeypatch, tmp_path):
    """``launch.train`` in LM mode on qwen3-moe (smoke, 3 layers, int8,
    a cut migrating 1 -> 2 -> 1) from the reference's draw: the first
    loss within 1e-5 relative (int8 runs are held before any update,
    C3), the traffic exactly, the migration bits the reference's plus
    the leaves its count leaves out, and every step's traffic event and
    every migration event reconciles."""
    import json
    import os

    from repro.launch import train as jtrain
    from repro_torch.launch import train

    flags = ["--arch", "qwen3-moe-30b-a3b", "--preset", "smoke", "--layers",
             "3", "--seq", "16", "--clients", "2", "--steps", "3",
             "--dynamic-cut", "1,2,1", "--uplink-codec", "int8",
             "--downlink-codec", "int8", "--log-every", "100", "--quiet"]

    def init_lm(seed, plan, dtype=torch.float32, device="cuda"):
        jplan = jlm.build_plan(jreduced(jget_config(
            "qwen3-moe-30b-a3b")).with_overrides(num_layers=3), plan.cut)
        p = jlm.init_lm(jax.random.key(seed), jplan, jnp.float32)
        return convert.params_from_jax(jax.tree.map(np.asarray, p), plan,
                                       device)

    got = {}
    orig = jtrain.train_lm
    monkeypatch.setattr(jtrain, "train_lm",
                        lambda a: got.setdefault("ref", orig(a)))
    jtrain.main(flags)
    monkeypatch.setattr(lm, "init_lm", init_lm)
    run = str(tmp_path / "run")
    port = train.main(flags + ["--device", "cpu", "--metrics-dir", run])
    ref = got["ref"]
    assert abs(port["first_loss"] - ref["first_loss"]) <= \
        LOSS_RTOL * abs(ref["first_loss"])
    assert port["comm"] == ref["comm"]
    assert port["n_migrations"] == ref["n_migrations"] == 2
    # the port prices every leaf that moves; the reference's count leaves
    # out the two QK-norm scales (head_dim 64 each) of the moving layer:
    # 128 f32 to each of K 2 clients, at both migrations
    assert port["migration_bits"] - ref["migration_bits"] == 2 * 128 * 32 * 2
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    traffic = [e for e in events if e.get("name") == "step_traffic"]
    migrations = [e for e in events if e.get("kind") == "migration"]
    assert len(traffic) == 3 and len(migrations) == 2
    assert all(e["measured"] == e["modeled"] for e in traffic + migrations)


def test_serve_launcher_takes_the_new_archs():
    """``launch.serve`` with ``--layers`` on the Jamba period and the
    kimi-k2 MoE (smoke), and the reference's refusal of a sliding
    window."""
    from repro_torch.launch import serve

    for arch, layers in (("jamba-v0.1-52b", 8), ("kimi-k2-1t-a32b", 3)):
        eng = serve.main(["--arch", arch, "--device", "cpu", "--layers",
                          str(layers), "--users", "3", "--slots", "2",
                          "--prompt-len", "6", "--gen", "3", "--quiet"])
        assert eng.cfg.num_layers == layers
        assert len(eng.completions) == 3
    with pytest.raises(ValueError, match="full-causal only"):
        serve.main(["--arch", "starcoder2-3b", "--device", "cpu", "--quiet"])


@pytest.mark.parametrize("arch,layers,cuts", [
    ("qwen3-moe-30b-a3b", "3", "1,2"), ("jamba-v0.1-52b", "8", "3,5")])
def test_device_and_host_banks_move_moe_and_hybrid_layers(tmp_path, arch,
                                                          layers, cuts):
    """LoRA (attention and router adapters) with cohorts of 2 of 4 and a
    migrating cut: the device and the host bank give the same checkpoint
    payload, byte for byte (the meta names the bank)."""
    import msgpack

    from repro_torch.launch import train

    flags = ["--arch", arch, "--preset", "smoke", "--layers", layers,
             "--seq", "16", "--peft", "lora", "--lora-targets",
             "attn,router", "--cohort", "2", "--clients", "4",
             "--optimizer", "adamw", "--lr", "1e-3", "--dynamic-cut", cuts,
             "--steps", "3", "--device", "cpu", "--quiet"]
    out = {}
    for bank in ("device", "host"):
        path = str(tmp_path / f"{bank}.ckpt")
        train.main(flags + ["--bank", bank, "--checkpoint", path])
        with open(path, "rb") as f:
            data = f.read()
        unp = msgpack.Unpacker(raw=False)
        unp.feed(data)
        unp.unpack()
        out[bank] = data[unp.tell():]
    assert out["device"] == out["host"]
