"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the CPU, from the reference's weights.

* ``route``: the expert indices exactly, except where the reference's
  k-th and (k+1)-th probabilities nearly tie (the margin rule below);
  the gates within 1e-6 and the Switch aux loss within 1e-6; ties break
  to the lower expert index, as ``jax.lax.top_k`` breaks them.
* ``_moe_chunk`` and ``moe_apply``: global and grouped capacity
  (``routing_groups``), dropped tokens, a shared expert, the sequence
  chunking above ``MOE_GLOBAL_CHUNK``; outputs within 1e-5, gradients of
  the output and of the aux within 1e-5.
* Under ``torch.func.vmap`` (the train step's client forward) routing and
  capacity are per client, bit for bit the per-client calls; the
  dispatch and its backward give the same bits twice.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import MoEConfig, get_config  # noqa: E402
from repro_torch.configs.base import reference_dict  # noqa: E402
from repro_torch.core import split  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

D = 64
# f32 in both frameworks: sums of up to 64 products in other orders agree
# to about 1e-6 on values of order one
GATE_TOL = AUX_TOL = 1e-6
Y_TOL = GRAD_TOL = 1e-5
# near-tie rule: an expert index may differ from the reference's only
# where the reference's k-th and (k+1)-th probabilities lie within this of
# each other -- the f32 noise of the two router products (sums of 64
# terms, ~1e-7 on logits of order one, so on probabilities below it)
TIE_MARGIN = 1e-6


def _cfgs(E=8, k=2, f=32, cf=1.25, groups=1, shared=0):
    kw = dict(num_experts=E, top_k=k, d_ff_expert=f, capacity_factor=cf,
              num_shared_experts=shared)
    over = dict(d_model=D, routing_groups=groups)
    return (jget_config("qwen3-moe-30b-a3b").with_overrides(
                moe=JMoEConfig(**kw), **over),
            get_config("qwen3-moe-30b-a3b").with_overrides(
                moe=MoEConfig(**kw), **over))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _params(jcfg, seed=0, router_scale=1.0):
    jp = jmoe.init_moe(jax.random.key(seed), jcfg, jnp.float32)
    jp = dict(jp, router={"w": jp["router"]["w"] * router_scale})
    return jp, _torch_tree(jax.tree.map(np.asarray, jp))


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _assert_routes_agree(idx, jidx, jprobs, k):
    """Indices equal, or the reference's k-th / (k+1)-th probabilities
    within TIE_MARGIN at every row where they differ."""
    idx, jidx = idx.numpy(), np.asarray(jidx)
    rows = np.flatnonzero((idx != jidx).any(-1))
    if rows.size:
        srt = -np.sort(-np.asarray(jprobs)[rows], axis=-1)
        assert (srt[:, k - 1] - srt[:, k] <= TIE_MARGIN).all(), rows
    return rows.size


@pytest.mark.parametrize("E,k", [(8, 2), (16, 4), (4, 1)])
def test_route_matches_reference(E, k):
    jcfg, cfg = _cfgs(E=E, k=k)
    jp, p = _params(jcfg)
    x = _x((96, D))
    jidx, jgates, jaux = jmoe.route(jp, jcfg.moe, jnp.asarray(x))
    idx, gates, aux = moe.route(p, cfg.moe, torch.from_numpy(x))
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["router"]["w"], axis=-1)
    assert idx.dtype == torch.int64 and idx.shape == (96, k)
    assert _assert_routes_agree(idx, jidx, jprobs, k) == 0
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates),
                               atol=GATE_TOL, rtol=0)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


def test_route_breaks_ties_to_the_lower_index():
    """A zero router (all probabilities equal) and a router with equal
    column pairs: the reference's top_k order, index for index."""
    jcfg, cfg = _cfgs(E=8, k=3)
    x = _x((16, D))
    for scale, dup in ((0.0, False), (1.0, True)):
        jp, p = _params(jcfg, router_scale=scale)
        if dup:  # experts 2i and 2i+1 share a column: every pick a tie
            w = np.repeat(np.asarray(jp["router"]["w"])[:, ::2], 2, axis=1)
            jp = dict(jp, router={"w": jnp.asarray(w)})
            p = dict(p, router={"w": torch.from_numpy(w)})
        jidx, jgates, jaux = jmoe.route(jp, jcfg.moe, jnp.asarray(x))
        idx, gates, aux = moe.route(p, cfg.moe, torch.from_numpy(x))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(gates.numpy(), np.asarray(jgates),
                                   atol=GATE_TOL, rtol=0)
        assert abs(float(aux) - float(jaux)) <= AUX_TOL
    assert (idx[:, 0] % 2 == 0).all()  # of each tied pair, the lower


def test_aux_gradient_matches_reference():
    """``me`` carries the aux loss's gradient to the router; ``ce`` (a
    count) carries none."""
    jcfg, cfg = _cfgs(E=8, k=2)
    jp, p = _params(jcfg)
    x = _x((64, D))

    def jaux(w):
        return jmoe.route({"router": {"w": w}}, jcfg.moe, jnp.asarray(x))[2]

    jg = jax.grad(jaux)(jp["router"]["w"])
    w = p["router"]["w"].clone().requires_grad_(True)
    aux = moe.route({"router": {"w": w}}, cfg.moe, torch.from_numpy(x))[2]
    (g,) = torch.autograd.grad(aux, w)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=GRAD_TOL,
                               rtol=0)


# (E, k, capacity factor, routing groups, shared experts, tokens)
CHUNK_CASES = [
    (8, 2, 1.25, 1, 0, 64),
    (8, 2, 0.5, 1, 0, 64),   # capacity 8 of 16 hits an expert: drops
    (8, 2, 1.25, 4, 0, 64),  # per-group capacity, G 4
    (8, 2, 0.5, 4, 1, 64),   # G 4 with drops and a shared expert
    (4, 2, 1.25, 3, 0, 64),  # 3 does not divide 64: one global group
]


@pytest.mark.parametrize("case", CHUNK_CASES,
                         ids=lambda c: "-".join(str(v) for v in c))
def test_moe_chunk_matches_reference(case):
    E, k, cf, G, shared, T = case
    jcfg, cfg = _cfgs(E=E, k=k, cf=cf, groups=G, shared=shared)
    jp, p = _params(jcfg)
    x = _x((T, D))
    jy, jaux = jmoe._moe_chunk(jp, jcfg, jnp.asarray(x))
    y, aux = moe._moe_chunk(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=Y_TOL, rtol=0)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    Gr = G if T % G == 0 else 1
    C = moe._capacity(cfg.moe, T // Gr)
    assert C == jmoe._capacity(jcfg.moe, T // Gr)
    xg = torch.from_numpy(x).reshape(Gr, T // Gr, D)
    kept = sum(int(moe._dispatch(p, cfg.moe, g, C)[3].sum()) for g in xg)
    if cf < 1:
        assert kept < T * k  # the case drops tokens


def test_moe_gradients_match_reference():
    """d(<y, r> + aux)/d(every MoE leaf) with drops and groups, against
    ``jax.grad``: the scatter's backward is the gather and back."""
    jcfg, cfg = _cfgs(E=8, k=2, cf=0.75, groups=2, shared=1)
    jp, p = _params(jcfg)
    x = _x((2, 16, D))
    r = _x((2, 16, D), seed=2)

    def jf(params, xx):
        y, aux = jmoe.moe_apply(params, jcfg, xx)
        return jnp.sum(y * r) + aux

    jg, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    # the two trees have the same keys, so jax flattens them alike
    live = [l.clone().requires_grad_(True) for l in jax.tree.leaves(p)]
    tree = jax.tree.unflatten(jax.tree.structure(p), live)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(tree, cfg, xt)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)) + aux,
                                live + [xt])
    for g, want in zip(grads, jax.tree.leaves(jg) + [jgx]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=0)


def test_sequence_chunking_matches_reference(monkeypatch):
    """Above MOE_GLOBAL_CHUNK tokens both packages cut the sequence into
    zero-padded chunks with capacity a chunk (here 2 x 40 tokens in
    chunks of 2 x 24: two chunks, 8 padded positions)."""
    jcfg, cfg = _cfgs(E=8, k=2, cf=1.0)
    jp, p = _params(jcfg)
    x = _x((2, 40, D))
    monkeypatch.setattr(jmoe, "MOE_GLOBAL_CHUNK", 48)
    monkeypatch.setattr(moe, "MOE_GLOBAL_CHUNK", 48)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    y, aux = moe.moe_apply(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=Y_TOL, rtol=0)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    monkeypatch.setattr(moe, "MOE_GLOBAL_CHUNK", 65536)
    y1, _ = moe.moe_apply(p, cfg, torch.from_numpy(x))
    assert not torch.equal(y1, y)  # per-chunk capacity is a different rule


def test_vmap_routes_per_client_and_dispatch_is_deterministic():
    """The train step's pattern: the MoE under ``torch.func.vmap`` over
    client copies, ``autograd.grad`` outside. Each client's output and
    aux equal its own call bit for bit; a second forward and backward
    give the same bits."""
    from torch.func import vmap

    jcfg, cfg = _cfgs(E=8, k=2, cf=0.75)
    _, p = _params(jcfg)
    n = 3
    stacked = jax.tree.map(lambda t: torch.stack(
        [t * (1 + 0.1 * i) for i in range(n)]), p)
    x = torch.from_numpy(_x((n, 2, 16, D)))

    def run():
        live = [l.clone().requires_grad_(True)
                for l in jax.tree.leaves(stacked)]
        tree = jax.tree.unflatten(jax.tree.structure(stacked), live)
        y, aux = vmap(lambda pp, xx: moe.moe_apply(pp, cfg, xx))(tree, x)
        grads = torch.autograd.grad(y.square().sum() + aux.sum(), live)
        return y.detach(), aux.detach(), grads

    y, aux, grads = run()
    for i in range(n):
        yi, ai = moe.moe_apply(jax.tree.map(lambda t: t[i], stacked), cfg,
                               x[i])
        assert torch.equal(y[i], yi) and torch.equal(aux[i], ai)
    y2, aux2, grads2 = run()
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b",
                                  "jamba-v0.1-52b"])
def test_flops_per_token_has_one_copy(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert split.moe_flops_per_token is moe.moe_flops_per_token
    assert moe.moe_flops_per_token(cfg) == jmoe.moe_flops_per_token(jcfg)
    assert reference_dict(cfg) == dataclasses.asdict(jcfg)
