"""The port's model stack against the reference on the reduced granite.

The reference's ``init_lm`` weights are carried over with
``repro_torch.convert.params_from_jax``; prefill hidden states, logits
and K/V caches, and a paged decode step's logits and cache writes, are
compared with the reference's ``apply_groups_prefill`` and
``apply_groups_decode`` over ``PagedKVCache``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models import blocks as rblocks  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import paging as rpaging  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro_torch.configs import (MoEConfig, SSMConfig,  # noqa: E402
                                 get_config, reduced_config)
from repro_torch.configs.base import reference_dict  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import blocks, lm, paging  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

# f32 in both frameworks; matmuls reduce in different orders, so values
# of order one agree to about 1e-6; rtol 1e-5 (atol 1e-5 for the entries
# near zero) holds that with margin and catches any wrong op
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def granite():
    rcfg = ref_reduced(ref_get_config("granite-8b"))
    cfg = reduced_config(get_config("granite-8b"))
    assert reference_dict(cfg) == dataclasses.asdict(rcfg)
    rplan, plan = rlm.build_plan(rcfg, 1), lm.build_plan(cfg, 1)
    rparams = rlm.init_lm(jax.random.key(0), rplan, jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), plan)
    return rcfg, rplan, rparams, cfg, plan, params


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_plans_group_layers_alike(granite):
    rcfg, rplan, _, cfg, plan, _ = granite
    assert [(g.repeat, g.period) for g in lm.all_groups(plan)] == \
        [(g.repeat, g.period) for g in rlm.all_groups(rplan)]
    full = get_config("granite-8b")
    assert reference_dict(full) == dataclasses.asdict(
        ref_get_config("granite-8b"))
    assert tf.group_specs(tf.layer_specs(full)) == [
        tf.LayerGroup(36, (("attn", "dense"),))]


def test_params_from_jax_unstacks_groups(granite):
    _, _, rparams, _, plan, params = granite
    rw = np.asarray(rparams["server"][0][0]["attn"]["wq"]["w"])
    assert rw.shape[0] == plan.server_groups[0].repeat
    for i, layer in enumerate(params["server"][0]):
        np.testing.assert_array_equal(layer[0]["attn"]["wq"]["w"].numpy(),
                                      rw[i])
    np.testing.assert_array_equal(params["head"]["w"].numpy(),
                                  np.asarray(rparams["head"]["w"]))
    with pytest.raises(ValueError, match="repeat"):
        bad = lm.build_plan(dataclasses.replace(plan.cfg, num_layers=3), 1)
        params_from_jax(jax.tree.map(np.asarray, rparams), bad)


def test_init_lm_has_the_converted_structure(granite):
    _, _, _, _, plan, params = granite
    own = lm.init_lm(0, plan, torch.float32, "cpu")

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in shapes(sub, f"{path}/{key}").items()}
        if isinstance(tree, (list, tuple)):
            return {k: v for i, sub in enumerate(tree)
                    for k, v in shapes(sub, f"{path}/{i}").items()}
        return {path: (tuple(tree.shape), tree.dtype)}

    assert shapes(own) == shapes(params)
    again = lm.init_lm(0, plan, torch.float32, "cpu")
    assert torch.equal(own["server"][0][0][0]["mlp"]["up"]["w"],
                       again["server"][0][0][0]["mlp"]["up"]["w"])


@pytest.mark.parametrize("theta,hd", [(1e7, 128), (1e7, 64), (1e4, 64)])
def test_rope_matches_reference(theta, hd):
    np.testing.assert_allclose(blocks.rope_freqs(hd, theta).numpy(),
                               np.asarray(rblocks.rope_freqs(hd, theta)),
                               rtol=1e-6)
    pos = np.arange(40, dtype=np.int32).reshape(2, 20)
    x = np.random.RandomState(0).randn(2, 20, 3, hd).astype(np.float32)
    rs, rc = rblocks.rope_sin_cos(jnp.asarray(pos), hd, theta)
    s, c = blocks.rope_sin_cos(torch.from_numpy(pos), hd, theta)
    _close(blocks.apply_rope(torch.from_numpy(x), s, c),
           rblocks.apply_rope(jnp.asarray(x), rs, rc))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_norm_and_mlp_match_reference(act):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 32).astype(np.float32)
    rp = rblocks.init_mlp(jax.random.key(1), 32, 48, act)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    _close(blocks.mlp(p, torch.from_numpy(x), act),
           rblocks.mlp(rp, jnp.asarray(x), act))
    scale = rng.randn(32).astype(np.float32)
    _close(blocks.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x), 1e-5),
           rblocks.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-5))


def test_prefill_matches_reference(granite):
    rcfg, rplan, rparams, cfg, plan, params = granite
    S = 11
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, S))
    rx = rblocks.embed(rparams["embed"], jnp.asarray(toks), jnp.float32)
    rh, rc = rtf.apply_groups_prefill(
        rlm.all_group_params(rparams), rcfg, rlm.all_groups(rplan), rx,
        rlm._positions(rcfg, 2, S), S)
    x = blocks.embed(params["embed"], torch.from_numpy(toks), torch.float32)
    h, c = tf.apply_groups_prefill(lm.all_group_params(params), cfg,
                                   lm.all_groups(plan), x,
                                   lm._positions(cfg, 2, S), S)
    _close(h, rh)
    _close(lm.logits_from_hidden(params, cfg, h),
           rlm.logits_from_hidden(rparams, rcfg, rh))
    for gi, g in enumerate(lm.all_groups(plan)):
        for li in range(g.repeat):
            _close(c[gi][li][0].k, rc[gi][0].k[li])
            _close(c[gi][li][0].v, rc[gi][0].v[li])


def _paged_caches(groups, slots, maxp, page, hkv, hd, lengths, live, seed):
    """The same random pools and admission state as reference (stacked
    per group) and port (per layer) group caches."""
    rng = np.random.RandomState(seed)
    P = slots * maxp
    table = rng.permutation(P).reshape(slots, maxp).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    live = np.asarray(live, bool)
    ref, port = [], []
    for g in groups:
        pk = rng.randn(g.repeat, hkv, P, page, hd).astype(np.float32)
        pv = rng.randn(g.repeat, hkv, P, page, hd).astype(np.float32)
        L = g.repeat
        ref.append((rpaging.PagedKVCache(
            jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(np.broadcast_to(table, (L,) + table.shape)),
            jnp.asarray(np.broadcast_to(lens, (L, slots))),
            jnp.asarray(np.broadcast_to(live, (L, slots)))),))
        port.append([(paging.PagedKVCache(
            torch.from_numpy(pk[i].copy()), torch.from_numpy(pv[i].copy()),
            **paging.admission_tensors(table, lens, live, "cpu")),)
            for i in range(L)])
    return ref, port


def test_paged_decode_step_matches_reference(granite):
    rcfg, rplan, rparams, cfg, plan, params = granite
    lengths, live = [5, 0, 16, 9], [True, False, True, True]
    rcaches, caches = _paged_caches(lm.all_groups(plan), 4, 3, 8,
                                    cfg.num_kv_heads, cfg.resolved_head_dim,
                                    lengths, live, 3)
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (4, 1))
    rx = rblocks.embed(rparams["embed"], jnp.asarray(toks), jnp.float32)
    rh, rnew = rtf.apply_groups_decode(
        rlm.all_group_params(rparams), rcfg, rlm.all_groups(rplan), rx,
        rcaches, "jnp")
    x = blocks.embed(params["embed"], torch.from_numpy(toks), torch.float32)
    h, new = tf.apply_groups_decode(lm.all_group_params(params), cfg,
                                    lm.all_groups(plan), x, caches)
    _close(lm.logits_from_hidden(params, cfg, h),
           rlm.logits_from_hidden(rparams, rcfg, rh))
    for gi, g in enumerate(lm.all_groups(plan)):
        for li in range(g.repeat):
            c, rc = new[gi][li][0], rnew[gi][0]
            _close(c.pages_k, rc.pages_k[li])
            _close(c.pages_v, rc.pages_v[li])
            np.testing.assert_array_equal(c.lengths.numpy(),
                                          np.asarray(rc.lengths[li]))


def test_ssm_and_moe_layers_name_their_slice(granite):
    """SSM layers and MoE FFNs both build: a Mamba-2/attention hybrid
    with dense FFNs, and MoE layers with the reference's expert shapes
    (E, d, f) / (E, f, d) and router (d, E)."""
    cfg = granite[3]
    ref_ssm = ref_get_config("mamba2-130m").ssm
    hybrid = dataclasses.replace(
        cfg, arch_type="hybrid", hybrid_period=2, hybrid_attn_offsets=(1,),
        ssm=SSMConfig(**dataclasses.asdict(ref_ssm)))
    params = lm.init_lm(0, lm.build_plan(hybrid, 1), device="cpu")
    assert "ssm" in params["client"][0][0][0]
    assert "attn" in params["server"][0][0][0]
    ref_moe = ref_get_config("qwen3-moe-30b-a3b").moe
    small = dataclasses.replace(ref_moe, num_experts=4, d_ff_expert=32)
    moe = dataclasses.replace(cfg, arch_type="moe",
                              moe=MoEConfig(**dataclasses.asdict(small)))
    params = lm.init_lm(0, lm.build_plan(moe, 1), device="cpu")
    layer = params["server"][0][0][0]
    d = cfg.d_model
    assert "mlp" not in layer and "norm2" in layer
    assert layer["moe"]["router"]["w"].shape == (d, 4)
    assert layer["moe"]["w_gate"].shape == (4, d, 32)
    assert layer["moe"]["w_up"].shape == (4, d, 32)
    assert layer["moe"]["w_down"].shape == (4, 32, d)


def test_init_lm_on_cuda_without_a_card_raises(granite):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_lm(0, granite[4])
