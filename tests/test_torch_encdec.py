"""The encoder-decoder (``repro_torch.models.encdec``) and its split train
step against the reference's on the CPU, from the reference's weights
(``convert.whisper_from_jax``), at the reduced whisper-tiny config (2 + 2
layers, d 256, 4/2 heads of 64, 32 frames, vocab 512):

* the config field for field, full and reduced;
* bidirectional and cross attention (``attend_train(causal=False)``,
  ``cross_kv_x``, ``attend_decode(cross=True)``) within LOGITS_TOL;
* ``encode``, ``whisper_forward``, ``whisper_prefill`` and
  ``whisper_decode_step``: logits within LOGITS_TOL, the greedy tokens
  exactly;
* the split layout (``split_whisper_params``, the stacked client side)
  and the ``convert.py`` round trip, exactly;
* ``make_whisper_train_step`` under sfl_ga, sfl and psl: two steps, the
  loss within 1e-5 relative and the params within 2e-5 absolute, and the
  traffic ledger of both boundaries equal to the reference's bit for
  bit. Int-codec cases carry the reference's state into the port before
  each step (ROADMAP C3: a code on a rounding boundary in float32 noise
  may round the other way, and training compounds it);
* the launchers on ``--arch whisper-tiny``: as in the reference, a
  decoder-only LM of whisper's widths, its encoder left out.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.core import protocol as jprotocol  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.obs import TrafficLedger as JTrafficLedger  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (TrainConfig, get_config,  # noqa: E402
                                 reduced_config)
from repro_torch.configs.base import reference_dict  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.protocol import ProtocolEngine  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import encdec, lm  # noqa: E402
from repro_torch.obs import TrafficLedger  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

# logits of order 5 through two layers (test_torch_zoo.py)
LOGITS_TOL = 1e-4
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
N, B, S, LR = 2, 2, 8, 0.05


@functools.lru_cache(maxsize=None)
def _cfgs():
    return (jreduced(jget_config("whisper-tiny")),
            reduced_config(get_config("whisper-tiny")))


@functools.lru_cache(maxsize=None)
def _model(seed=0):
    jcfg, cfg = _cfgs()
    jp = jenc.init_whisper(jax.random.key(seed), jcfg, jnp.float32)
    return jp, convert.whisper_from_jax(jax.tree.map(np.asarray, jp))


def _frames(rng, *lead):
    jcfg, _ = _cfgs()
    return rng.randn(*lead, jcfg.encoder.num_frames,
                     jcfg.d_model).astype(np.float32)


# the reference's functions, compiled (an eager jax call compiles every
# primitive on its own, which takes longer than one compile)
_jforward = jax.jit(jenc.whisper_forward, static_argnums=(1,),
                    static_argnames=("dtype",))
_jprefill = jax.jit(jenc.whisper_prefill, static_argnums=(1,),
                    static_argnames=("max_len", "dtype"))
_jdecode = jax.jit(jenc.whisper_decode_step, static_argnums=(1,),
                   static_argnames=("dtype",))


def _close(got, want, tol=LOGITS_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def test_config_is_the_reference_field_for_field():
    """whisper-tiny full and reduced: 4 + 4 layers, d 384, 6 heads, d_ff
    1536, vocab 51,865, 1,500 frames, gelu, attention biases, tied
    embeddings."""
    cfg = get_config("whisper-tiny")
    assert reference_dict(cfg) == dataclasses.asdict(
        jget_config("whisper-tiny"))
    assert (cfg.num_layers, cfg.encoder.num_layers, cfg.d_model,
            cfg.num_heads, cfg.d_ff, cfg.vocab_size,
            cfg.encoder.num_frames) == (4, 4, 384, 6, 1536, 51865, 1500)
    assert reference_dict(_cfgs()[1]) == dataclasses.asdict(_cfgs()[0])


def test_bidirectional_and_cross_attention_match_reference():
    """The encoder's unmasked self-attention (no RoPE), the decoder's
    cross-attention (K/V from the encoder's states) and a cross decode
    step on the projected encoder KV, which comes back unchanged;
    ``impl="flash"`` takes the unmasked softmax here too, as in the
    reference (kernel B4 is causal only)."""
    jcfg, cfg = _cfgs()
    jp, p = _model()
    jap, ap = jp["dec_layers"][0]["cross_attn"], \
        p["dec_layers"][0]["cross_attn"]
    rng = np.random.RandomState(3)
    x = rng.randn(B, S, jcfg.d_model).astype(np.float32)
    enc = rng.randn(B, 32, jcfg.d_model).astype(np.float32)
    jtrain = jax.jit(jattn.attend_train, static_argnums=(1,),
                     static_argnames=("causal",))
    want = jtrain(jap, jcfg, jnp.asarray(x), None, causal=False)
    for impl in ("jnp", "flash"):
        _close(attn.attend_train(ap, cfg, torch.from_numpy(x), None,
                                 impl=impl, causal=False), want)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    want = jtrain(jap, jcfg, jnp.asarray(x), jnp.asarray(pos),
                  causal=False, cross_kv_x=jnp.asarray(enc))
    got = attn.attend_train(ap, cfg, torch.from_numpy(x),
                            torch.from_numpy(pos.copy()), causal=False,
                            cross_kv_x=torch.from_numpy(enc))
    _close(got, want)
    hd = cfg.resolved_head_dim
    k = rng.randn(B, 32, cfg.num_kv_heads, hd).astype(np.float32)
    v = rng.randn(B, 32, cfg.num_kv_heads, hd).astype(np.float32)
    jy, _ = jax.jit(jattn.attend_decode, static_argnums=(1,),
                    static_argnames=("cross",))(
        jap, jcfg, jnp.asarray(x[:, :1]),
        jattn.KVCache(jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(32, jnp.int32)), cross=True)
    cache = attn.KVCache(torch.from_numpy(k), torch.from_numpy(v), 32)
    y, back = attn.attend_decode(ap, cfg, torch.from_numpy(x[:, :1]), cache,
                                 cross=True)
    _close(y, jy)
    assert back is cache


def test_encode_and_forward_match_reference():
    jcfg, cfg = _cfgs()
    jp, p = _model()
    rng = np.random.RandomState(1)
    fe = _frames(rng, B)
    toks = rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    _close(encdec.encode(p, cfg, torch.from_numpy(fe)),
           jax.jit(jenc.encode, static_argnums=(1,))(jp, jcfg,
                                                     jnp.asarray(fe)))
    logits = encdec.whisper_forward(p, cfg, torch.from_numpy(fe),
                                    torch.from_numpy(toks))
    jlogits = _jforward(jp, jcfg, jnp.asarray(fe), jnp.asarray(toks),
                        dtype=jnp.float32)
    _close(logits, jlogits)
    labels = rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    want = float(jlm.cross_entropy(jlogits, jnp.asarray(labels)))
    got = float(encdec.whisper_loss(p, cfg, torch.from_numpy(fe),
                                    torch.from_numpy(toks),
                                    torch.from_numpy(labels)))
    assert abs(got - want) <= LOSS_RTOL * abs(want)


def test_prefill_and_greedy_decode_match_reference():
    """Prefill of a 6-token prompt, then 6 greedy decode steps: every
    token the reference's, every step's logits within LOGITS_TOL; the
    cross caches never change."""
    jcfg, cfg = _cfgs()
    jp, p = _model()
    rng = np.random.RandomState(2)
    fe = _frames(rng, B)
    toks = rng.randint(0, jcfg.vocab_size, (B, 6)).astype(np.int32)
    jl, jc = _jprefill(jp, jcfg, jnp.asarray(fe), jnp.asarray(toks),
                       max_len=12, dtype=jnp.float32)
    pl, pc = encdec.whisper_prefill(p, cfg, torch.from_numpy(fe),
                                    torch.from_numpy(toks), max_len=12)
    _close(pl, jl)
    cross = [c.cross_kv for c in pc]
    for _ in range(6):
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        pt = pl[:, -1].argmax(dim=-1)[:, None]
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
        jl, jc = _jdecode(jp, jcfg, jt, jc, dtype=jnp.float32)
        pl, pc = encdec.whisper_decode_step(p, cfg, pt, pc)
        _close(pl, jl)
    assert all(c.cross_kv is x for c, x in zip(pc, cross))
    assert [c.self_kv.length for c in pc] == [12] * cfg.num_layers


def _split(cut=1, seed=4):
    """The reference's ``split_whisper_params`` draw, its client side
    stacked to N as the reference's ``launch.specs`` lays it out, with a
    distinct perturbation a client so that aggregation shows."""
    jcfg, _ = _cfgs()
    js = jenc.split_whisper_params(jax.random.key(seed), jcfg, cut,
                                   jnp.float32)
    rng = np.random.RandomState(seed)
    client = jax.tree.map(
        lambda x: jnp.asarray(np.stack([
            np.asarray(x) + (rng.randn(*x.shape).astype(np.float32) * 0.01
                             if x.ndim >= 2 else 0) for _ in range(N)])),
        js["client"])
    return {"client": client, "server": js["server"]}


def test_split_layout_and_convert_round_trip():
    """The port's split has the reference's structure and shapes (the
    client side holds the encoder, the embedding and ``dec_layers[:cut]``;
    the server the rest and an untied head); ``launch.specs``'
    ``_whisper_split_stacked`` draws the same split and broadcasts the
    client side to N; the conversion round-trips exactly."""
    jcfg, cfg = _cfgs()
    for cut in (1,):
        js = jenc.split_whisper_params(jax.random.key(0), jcfg, cut,
                                       jnp.float32)
        ps = encdec.split_whisper_params(0, cfg, cut, device="cpu")
        assert jax.tree.structure(jax.tree.map(np.asarray, js)) == \
            jax.tree.structure(convert.whisper_split_to_jax(ps))
        for a, b in zip(jax.tree.leaves(js), tree_leaves(ps)):
            assert tuple(a.shape) == tuple(b.shape) and b.dtype == \
                torch.float32
        assert len(ps["client"]["dec_layers"]) == cut
        assert ps["server"]["head"]["w"].shape == (cfg.d_model,
                                                  cfg.vocab_size)
        st = specs._whisper_split_stacked(cfg, cut, N, seed=0,
                                          device="cpu")
        for a, b in zip(tree_leaves(st["client"]),
                        tree_leaves(ps["client"])):
            assert a.shape == (N,) + b.shape
            assert torch.equal(a, b.unsqueeze(0).expand_as(a))
        sl, pl = tree_leaves(st["server"]), tree_leaves(ps["server"])
        assert len(sl) == len(pl) and all(torch.equal(a, b)
                                          for a, b in zip(sl, pl))
    js = jax.tree.map(np.asarray, _split())
    back = convert.whisper_split_to_jax(convert.whisper_split_from_jax(js))
    assert jax.tree.structure(back) == jax.tree.structure(js)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(a, b)
    jp, p = _model()
    for a, b in zip(jax.tree.leaves(convert.whisper_to_jax(p)),
                    jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


@functools.lru_cache(maxsize=None)
def _reference_step(algo, codec):
    """The reference's jitted whisper step with a traffic ledger on its
    engine (``make_whisper_train_step`` builds its own), compiled once
    per (algo, codec) for the module."""
    jcfg, _ = _cfgs()
    ledger = JTrafficLedger()

    def engine_for(tcfg):
        eng = jprotocol.ProtocolEngine(tcfg.algo, tcfg.uplink_codec,
                                       tcfg.downlink_codec,
                                       base_seed=tcfg.seed)
        eng.attach_ledger(ledger, raw_bits_per_elem=32.0,
                          label_bits_per_epoch=B * S * 32)
        return eng

    orig, jalg._engine_for = jalg._engine_for, engine_for
    try:
        tc = JTrainConfig(model=jcfg, algo=algo, compute_dtype="float32",
                          param_dtype="float32", uplink_codec=codec,
                          downlink_codec=codec)
        opt = jmake_optimizer("sgd", LR)
        step = jax.jit(jalg.make_whisper_train_step(jcfg, tc, opt, N))
    finally:
        jalg._engine_for = orig
    return step, opt, ledger


@pytest.mark.parametrize("algo,codec", [
    ("sfl_ga", "fp32"), ("sfl", "fp32"), ("psl", "int8"), ("sfl_ga", "int8")])
def test_whisper_train_step_matches_reference(algo, codec):
    jcfg, cfg = _cfgs()
    jstep, jopt, jledger = _reference_step(algo, codec)
    js = _split()
    ps = convert.whisper_split_from_jax(jax.tree.map(np.asarray, js))
    eng = ProtocolEngine(algo, codec, codec)
    ledger = TrafficLedger()
    eng.attach_ledger(ledger, raw_bits_per_elem=32.0,
                      label_bits_per_epoch=B * S * 32)
    tc = TrainConfig(model=cfg, algo=algo, compute_dtype="float32",
                     param_dtype="float32", uplink_codec=codec,
                     downlink_codec=codec)
    opt = make_optimizer("sgd", LR)
    step = alg.make_whisper_train_step(cfg, tc, opt, N, engine=eng)
    jst, st = jopt.init(js), opt.init(ps)
    rng = np.random.RandomState(5)
    jledger.snapshot_and_reset()
    for i in range(2):
        fe = _frames(rng, N, B)
        toks = rng.randint(0, jcfg.vocab_size, (N, B, S)).astype(np.int32)
        labels = rng.randint(0, jcfg.vocab_size, (N, B, S)).astype(np.int32)
        seed = np.uint32(7 + 1000003 * i)
        if codec != "fp32":  # the reference's state, carried in (C3)
            ps = convert.whisper_split_from_jax(jax.tree.map(np.asarray, js))
        js, jst, jm = jstep(js, jst, {"frame_embeds": jnp.asarray(fe),
                                      "tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(labels),
                                      "seed": seed})
        ps, st, m = step(ps, st, {"frame_embeds": torch.from_numpy(fe),
                                  "tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels),
                                  "seed": seed})
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= LOSS_RTOL * abs(want)
        jax.effects_barrier()
        assert ledger.snapshot_and_reset() == jledger.snapshot_and_reset()
        for a, b in zip(tree_leaves(ps), jax.tree.leaves(js)):
            torch.testing.assert_close(a, torch.from_numpy(np.asarray(b)),
                                       rtol=0, atol=PARAM_ATOL)
    if algo == "sfl":  # the client copies are one model after sfl
        for leaf in tree_leaves(ps["client"]):
            assert torch.equal(leaf, leaf[:1].expand_as(leaf))


def test_whisper_train_step_refusals():
    _, cfg = _cfgs()
    opt = make_optimizer("sgd", LR)
    with pytest.raises(ValueError, match="tau>1"):
        alg.make_whisper_train_step(cfg, TrainConfig(model=cfg, tau=2), opt,
                                    N)
    with pytest.raises(ValueError, match="algo"):
        alg.make_whisper_train_step(cfg, TrainConfig(model=cfg, algo="fl"),
                                    opt, N)


def _reference_lm_init(monkeypatch, num_layers=2):
    """The port's launchers start from the reference's ``init_lm`` draw
    of whisper-tiny's decoder-only LM."""
    def init_lm(seed, plan, dtype=torch.float32, device="cuda"):
        jcfg = jreduced(jget_config("whisper-tiny")).with_overrides(
            num_layers=plan.cfg.num_layers)
        p = jlm.init_lm(jax.random.key(seed), jlm.build_plan(jcfg, plan.cut),
                        jnp.float32)
        return convert.params_from_jax(jax.tree.map(np.asarray, p), plan,
                                       device)

    monkeypatch.setattr(lm, "init_lm", init_lm)


def test_train_launcher_on_whisper_tiny_is_the_reference(monkeypatch):
    """``launch.train --arch whisper-tiny`` trains what the reference's
    does: the LM mode's decoder-only model of whisper's widths (gelu,
    attention biases, a head untied at the cut), the encoder left out.
    From the reference's draw the losses agree within 1e-5 relative and
    the traffic exactly; the model is ``lm``'s plan, not ``encdec``'s."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    flags = ["--arch", "whisper-tiny", "--steps", "2", "--clients", "2",
             "--batch", "1", "--seq", "8", "--log-every", "100", "--quiet"]
    got = {}
    orig = jtrain.train_lm
    monkeypatch.setattr(jtrain, "train_lm",
                        lambda a: got.setdefault("ref", orig(a)))
    jtrain.main(flags)
    _reference_lm_init(monkeypatch)
    plans = []
    orig_plan = lm.build_plan
    monkeypatch.setattr(lm, "build_plan", lambda *a, **kw: plans.append(
        orig_plan(*a, **kw)) or plans[-1])
    port = train.main(flags + ["--device", "cpu"])
    ref = got["ref"]
    for k in ("first_loss", "final_loss"):
        assert abs(port[k] - ref[k]) <= LOSS_RTOL * abs(ref[k]), k
    assert port["comm"] == ref["comm"]
    assert plans and all(p.cfg.name == "whisper-tiny-smoke"
                         and p.cfg.encoder is not None for p in plans)


def test_serve_launcher_on_whisper_tiny_is_the_reference(monkeypatch):
    """``launch.serve --arch whisper-tiny`` serves what the reference's
    does, the decoder-only LM of whisper's widths over the paged cache:
    from the reference's draw, the same greedy streams."""
    from repro.core import serve_engine as jserve_engine
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    flags = ["--arch", "whisper-tiny", "--users", "3", "--slots", "2",
             "--prompt-len", "6", "--gen", "4", "--quiet"]
    got = {}
    orig = jserve_engine.ServeEngine.run

    def run(self):
        got["ref"] = orig(self)
        return got["ref"]

    monkeypatch.setattr(jserve_engine.ServeEngine, "run", run)
    jserve.main(flags)
    _reference_lm_init(monkeypatch)
    eng = serve.main(flags + ["--device", "cpu"])
    want = {c.uid: [int(t) for t in c.tokens] for c in got["ref"]}
    assert {c.uid: [int(t) for t in c.tokens] for c in eng.completions} == \
        want and len(want) == 3
