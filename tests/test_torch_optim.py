"""The port's optimizers and schedules (``repro_torch.optim``) against the
reference's (``repro.optim``) on the CPU.

The same numpy trees (a seed's draws, nested dicts, lists and tuples as
the LM's split trees have them) go through both; updates, states and
applied params agree within 1e-6 relative + 1e-7 absolute over several
steps (float32 in both; the two frameworks' float32 pow, sqrt and
division may round a last bit apart). The count is an int32 scalar in
both and equal exactly. AdamW's bias corrections are the reference's
float32 ``1 - b ** count`` and its weight decay defaults to 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.optim import schedules as sched  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-6, 1e-7


def _np_tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)

    def a(*shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {"client": {"embed": {"table": a(3, 5, 4)},
                       "groups": [[({"w": a(3, 4, 6), "b": a(3, 6)},)]]},
            "server": {"groups": [[({"w": a(6, 4)},), ({"w": a(6, 4)},)]],
                       "final_norm": {"scale": a(4)}}}


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(port, ref, exact=False):
    pl, rl = tree_leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        r = np.asarray(r)
        assert tuple(p.shape) == r.shape
        if exact:
            np.testing.assert_array_equal(p.numpy(), r)
        else:
            np.testing.assert_allclose(p.numpy(), r, rtol=RTOL, atol=ATOL)


OPTS = {
    "sgd": (lambda m: m.sgd(0.05)),
    "momentum": (lambda m: m.momentum(0.05, beta=0.9)),
    "nesterov": (lambda m: m.momentum(0.05, beta=0.9, nesterov=True)),
    "adamw": (lambda m: m.adamw(1e-2)),
    "adamw_wd": (lambda m: m.adamw(1e-2, weight_decay=0.01)),
    "adamw_cosine": (lambda m: m.adamw(
        (jsched if m is jopt else sched).cosine_decay(1e-2, 4))),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_steps_match_reference(name):
    """Four steps from the same params and gradients: updates, state and
    params agree; the counts are equal."""
    jo, po = OPTS[name](jopt), OPTS[name](opt)
    jp, pp = _j(_np_tree(0)), _t(_np_tree(0))
    js, ps = jo.init(jp), po.init(pp)
    for step in range(4):
        g = _np_tree(10 + step, scale=0.1 * (step + 1))
        ju, js = jo.update(_j(g), js, jp)
        pu, ps = po.update(_t(g), ps, pp)
        _close(pu, ju)
        jp, pp = jopt.apply_updates(jp, ju), opt.apply_updates(pp, pu)
        _close(pp, jp)
        assert int(ps["count"]) == int(js["count"]) == step + 1
        assert ps["count"].dtype == torch.int32
        for k in ("mu", "m", "v"):
            if k in js:
                _close(ps[k], js[k])


def test_adamw_defaults_and_float32_bias_correction():
    """weight_decay 0 by default (torch's AdamW decays 0.01), and the first
    step's update is -lr * g / (|g| + eps) up to the f32 corrections."""
    po = opt.make_optimizer("adamw", 0.1)
    p = {"w": torch.ones(4)}
    st = po.init(p)
    assert set(st) == {"count", "m", "v"}
    g = {"w": torch.tensor([1.0, -2.0, 0.5, 0.0])}
    u, st = po.update(g, st, p)
    want = -0.1 * g["w"] / (g["w"].abs() + 1e-8)
    torch.testing.assert_close(u["w"], want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.make_optimizer("lion", 0.1)


def test_masked_leaves_frozen_exactly():
    """Frozen leaves take exact-zero updates and own no moments; the
    trainable ones step as the reference's masked optimizer does."""
    tree = _np_tree(1)
    mask = jax.tree.map(lambda x: x.ndim == 2, tree)
    jo, po = jopt.masked(jopt.adamw(1e-2), mask), opt.masked(
        opt.adamw(1e-2), mask)
    jp, pp = _j(tree), _t(tree)
    js, ps = jo.init(jp), po.init(pp)
    assert len(tree_leaves(ps["m"])) == sum(jax.tree.leaves(mask))
    g = _np_tree(2)
    ju, _ = jo.update(_j(g), js, jp)
    pu, _ = po.update(_t(g), ps, pp)
    _close(pu, ju)
    for u, m in zip(tree_leaves(pu), jax.tree.leaves(mask)):
        if not m:
            assert not torch.any(u)


def test_global_norm_and_clip_match_reference():
    g = _np_tree(3, scale=2.0)
    n_ref = float(jopt.global_norm(_j(g)))
    assert abs(float(opt.global_norm(_t(g))) - n_ref) <= 1e-6 * n_ref
    for max_norm in (0.5 * n_ref, 2.0 * n_ref):
        _close(opt.clip_by_global_norm(_t(g), max_norm),
               jopt.clip_by_global_norm(_j(g), max_norm))


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_reference(name):
    make = {"constant": lambda m: m.constant(0.3),
            "cosine": lambda m: m.cosine_decay(0.3, 10, 0.2),
            "warmup_cosine": lambda m: m.linear_warmup_cosine(0.3, 3, 12)}
    jf, pf = make[name](jsched), make[name](sched)
    for step in (0, 1, 2, 3, 5, 9, 12, 20):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = pf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-6)
