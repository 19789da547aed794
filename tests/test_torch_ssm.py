"""The Mamba-2 block and SSM serving: the port against the reference on the
CPU, at ``reduced_config(mamba2-130m)`` (2 layers, d_model 256, 8 heads
of 64, state 32, chunk 32).

Both packages run the reference's ``init_lm`` weights (carried over with
``params_from_jax``). The block's train forward, prefill (output, conv
and state caches) and a few decode steps agree within 1e-5 (f32 on both
sides, other summation orders); the port's ``ServeEngine(device="cpu")``
gives the reference engine's greedy token streams exactly on prompts of
40 tokens (one chunk of 32 through the chunked head, 8 through the
sequential tail), and with the int8 codec every step's traffic event
reconciles exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as ref_obs  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.core import serve_engine as ref_serve  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.serve_engine import (ServeEngine,  # noqa: E402
                                           make_requests)
from repro_torch.models import lm, paging, ssm  # noqa: E402
from repro_torch.obs.ledger import reconcile_events  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

TOL = 1e-5
PROMPT, GENS, USERS, SLOTS, PAGE = 40, [5, 3, 6], 5, 2, 8
MAX_LEN = PROMPT + max(GENS)
# greedy parity means something only where the top-2 gap is well above
# the two frameworks' f32 differences (about 1e-6 here)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def mamba():
    rcfg = ref_reduced(ref_get_config("mamba2-130m"))
    cfg = reduced_config(get_config("mamba2-130m"))
    assert cfg == dataclass_copy(rcfg)
    rplan, plan = rlm.build_plan(rcfg, 1), lm.build_plan(cfg, 1)
    rparams = rlm.init_lm(jax.random.key(0), rplan, jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), plan)
    return (rcfg, rplan, rparams), (cfg, plan, params)


def dataclass_copy(rcfg):
    """The reference's config rebuilt from the port's classes."""
    import dataclasses

    from repro_torch.configs.base import ModelConfig, SSMConfig

    kw = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
    kw["ssm"] = SSMConfig(**dataclasses.asdict(rcfg.ssm))
    return ModelConfig(**kw)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _block(mamba, layer=0):
    (rcfg, _, rparams), (cfg, _, params) = mamba
    rp = jax.tree.map(lambda a: a[layer], rparams["server"][0][0]["ssm"])
    return rcfg, rp, cfg, params["server"][0][layer][0]["ssm"]


def test_config_is_the_published_mamba2_130m():
    cfg = get_config("mamba2-130m")
    d_inner, H, conv_ch = ssm._dims(cfg)
    assert (cfg.num_layers, cfg.d_model, d_inner, H, cfg.ssm.head_dim,
            cfg.ssm.state_dim, cfg.ssm.n_groups, cfg.ssm.conv_dim,
            cfg.ssm.chunk_size, cfg.vocab_size) == (
        24, 768, 1536, 24, 64, 128, 1, 4, 128, 50280)
    assert cfg == dataclass_copy(ref_get_config("mamba2-130m"))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_train_matches_reference(mamba, use_kernel):
    rcfg, rp, cfg, p = _block(mamba)
    x = np.random.RandomState(1).randn(2, 40, cfg.d_model).astype(np.float32)
    want = rssm.mamba2_train(rp, rcfg, jnp.asarray(x), use_kernel)
    got = ssm.mamba2_train(p, cfg, torch.from_numpy(x), use_kernel)
    _close(got, want)


def test_prefill_and_decode_match_reference(mamba):
    rcfg, rp, cfg, p = _block(mamba, layer=0)
    rng = np.random.RandomState(2)
    x = rng.randn(1, 40, cfg.d_model).astype(np.float32)
    ry, rc = rssm.mamba2_prefill(rp, rcfg, jnp.asarray(x), True)
    y, c = ssm.mamba2_prefill(p, cfg, torch.from_numpy(x))
    _close(y, ry)
    _close(c.conv, rc.conv)
    _close(c.state, rc.state)
    assert c.length == int(rc.length) == 40
    for _ in range(3):
        xt = rng.randn(1, 1, cfg.d_model).astype(np.float32)
        ry, rc = rssm.mamba2_decode(rp, rcfg, jnp.asarray(xt), rc)
        y, c = ssm.mamba2_decode(p, cfg, torch.from_numpy(xt), c)
        _close(y, ry)
        _close(c.state, rc.state)
        _close(c.conv, rc.conv)


def test_short_prompt_cache_is_zero_padded(mamba):
    """A prompt shorter than the conv window leaves zeros before it in
    the conv cache, as the causal conv's own padding does."""
    _, _, cfg, p = _block(mamba)
    x = torch.randn(1, 2, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    _, c = ssm.mamba2_prefill(p, cfg, x)
    assert c.conv.shape == (1, cfg.ssm.conv_dim - 1, ssm._dims(cfg)[2])
    assert torch.equal(c.conv[:, 0], torch.zeros_like(c.conv[:, 0]))


def test_paged_group_caches_hold_ssm_state(mamba):
    _, (cfg, plan, _) = mamba
    caches = paging.init_paged_group_caches(cfg, lm.all_groups(plan), 3, 16,
                                            8)
    leaves = [c for gc in caches for lc in gc for c in lc]
    assert len(leaves) == cfg.num_layers
    assert all(isinstance(c, ssm.SSMCache) for c in leaves)
    assert leaves[0].state.shape == (3, 8, 64, 32)
    # nothing paged: admission pushes and stats leave them alone
    assert paging.replace_tables(caches, np.zeros((3, 2), np.int32),
                                 np.zeros(3, np.int32),
                                 np.zeros(3, bool)) is caches
    assert paging.paged_cache_stats(caches)["pages_total"] == 0


def _run_ref(ref, codec):
    cfg, plan, params = ref
    rec = ref_obs.Recorder()
    with ref_obs.use_recorder(rec):
        e = ref_serve.ServeEngine(params, plan, slots=SLOTS, max_len=MAX_LEN,
                                  page_size=PAGE, codec=codec)
        for r in ref_serve.make_requests(USERS, PROMPT, GENS,
                                         vocab_size=cfg.vocab_size, seed=0):
            e.submit(r)
        e.run()
    return e, rec


def _run_port(port, codec, margins=None):
    cfg, plan, params = port
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        e = ServeEngine(params, plan, slots=SLOTS, max_len=MAX_LEN,
                        page_size=PAGE, codec=codec, device="cpu")
        for r in make_requests(USERS, PROMPT, GENS,
                               vocab_size=cfg.vocab_size, seed=0):
            e.submit(r)
        while e.queue or e._live.any():
            live = e._live.copy()
            e.step()
            if margins is not None and live.any():
                top2 = e.last_logits[torch.from_numpy(live)].topk(2).values
                margins.append(float((top2[:, 0] - top2[:, 1]).min()))
    return e, rec


def _streams(e):
    return {c.uid: list(c.tokens) for c in e.completions}


def test_greedy_streams_match_the_reference_engine(mamba):
    ref, port = mamba
    margins = []
    re_, _ = _run_ref(ref, "fp32")
    pe, _ = _run_port(port, "fp32", margins)
    assert len(pe.completions) == USERS
    assert _streams(pe) == _streams(re_)
    assert {c.uid: (c.admitted_step, c.finished_step)
            for c in pe.completions} == {
        c.uid: (c.admitted_step, c.finished_step) for c in re_.completions}
    assert margins and min(margins) > MARGIN, min(margins)


def test_int8_traffic_reconciles_exactly(mamba):
    ref, port = mamba
    _, rrec = _run_ref(ref, "int8")
    pe, rec = _run_port(port, "int8")
    assert sorted(c.num_tokens for c in pe.completions) == sorted(
        GENS[i % len(GENS)] for i in range(USERS))
    rows, bad = reconcile_events(rec.events)
    assert rows and bad == 0
    assert [ev["measured"] for ev in rec.events if ev["kind"] == "traffic"] \
        == [ev["measured"] for ev in rrec.events if ev["kind"] == "traffic"]


def test_convert_carries_the_ssm_leaves_and_the_untied_head(mamba):
    (_, _, rparams), (cfg, plan, params) = mamba
    leaves = {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm",
              "out_proj"}
    for side in ("client", "server"):
        for gi, g in enumerate(params[side]):
            for li, layer in enumerate(g):
                got = layer[0]["ssm"]
                assert set(got) == leaves
                want = rparams[side][gi][0]["ssm"]
                for k in leaves:
                    for a, b in zip(jax.tree.leaves(want[k]),
                                    _tensors(got[k])):
                        np.testing.assert_array_equal(b.numpy(),
                                                      np.asarray(a)[li])
    # tied in the config, untied by the split: the head is server-side
    assert cfg.tie_embeddings and plan.cut == 1
    np.testing.assert_array_equal(params["head"]["w"].numpy(),
                                  np.asarray(rparams["head"]["w"]))


def _tensors(node):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _tensors(node[k])
    else:
        yield node


def test_serve_launcher_serves_mamba2_on_the_cpu(tmp_path):
    from repro.obs.recorder import read_events
    from repro_torch.launch import serve

    d = str(tmp_path / "m")
    engine = serve.main(["--arch", "mamba2-130m", "--device", "cpu",
                         "--preset", "smoke", "--users", "3", "--slots", "2",
                         "--prompt-len", "40", "--gen", "3", "--codec",
                         "int8", "--metrics-dir", d, "--quiet"])
    assert len(engine.completions) == 3
    rows, bad = reconcile_events(read_events(d))
    assert rows and bad == 0


def test_prompt_shorter_than_the_conv_window_serves(mamba):
    """A 2-token prompt (the conv window holds 3 past inputs): the
    reference engine cannot adopt such a prefill (its conv cache comes
    out 2 rows long); the port zero-pads it, and the served greedy tokens
    equal greedy decoding by full-sequence forwards."""
    _, (cfg, plan, params) = mamba
    prompt, gen = [7, 300], 4
    e = ServeEngine(params, plan, slots=1, max_len=8, page_size=8,
                    device="cpu")
    e.submit(make_requests(1, 2, gen, vocab_size=cfg.vocab_size)[0])
    e.queue[0].prompt[:] = prompt
    e.run()
    seq = list(prompt)
    for _ in range(gen):
        x, _ = lm.client_forward(params, plan, torch.tensor([seq]))
        logits, _ = lm.server_forward(params, plan, x)
        seq.append(int(logits[0, -1].argmax()))
    assert e.completions[0].tokens == seq[len(prompt):]
