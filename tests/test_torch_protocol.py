"""The protocol layer in the port against the reference: the scheme
table, the seed schedules, the lossy channels, the gradagg boundary
operators and the per-round aggregation rules.

Hash- and integer-determined results agree bit for bit (seeds, codec
round trips, ledger bits); f32 reductions within 1e-6.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compress import channel as jchannel  # noqa: E402
from repro.compress.codecs import get_codec as jcodec  # noqa: E402
from repro.core import protocol as jproto  # noqa: E402
from repro.obs.ledger import TrafficLedger as JLedger  # noqa: E402
from repro_torch.compress import channel, get_codec  # noqa: E402
from repro_torch.core import gradagg, protocol  # noqa: E402
from repro_torch.kernels import grad_agg as ga  # noqa: E402
from repro_torch.obs.ledger import TrafficLedger  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

# repro.core re-exports the function `gradagg` under the module's name
jgradagg = importlib.import_module("repro.core.gradagg")

TOL = 1e-6  # f32 sums over the client axis, in other orders
SEEDS = [0, 7, 0x7FFFFFFF, 0xFFFFFFFF]  # the last wraps on every stride


def _x(seed, shape, scale=2.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _rho(n, seed=0):
    return np.random.RandomState(seed).dirichlet(np.ones(n)).astype(
        np.float32)


def _blocks(seed, k):
    rng = np.random.RandomState(seed)
    return [{"w": rng.randn(k, 5, 5, 1, 4).astype(np.float32),
             "b": rng.randn(k, 4).astype(np.float32)},
            {"w": rng.randn(k, 12, 3).astype(np.float32),
             "b": rng.randn(k, 3).astype(np.float32)}]


def _t(tree):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in tree]


def _assert_trees_close(got, want, tol=TOL):
    for gb, wb in zip(got, want):
        assert gb.keys() == wb.keys()
        for k in gb:
            np.testing.assert_allclose(gb[k].numpy(), np.asarray(wb[k]),
                                       rtol=tol, atol=tol)


def test_scheme_table_matches():
    assert protocol.SCHEMES == jproto.SCHEMES
    for name in jproto.SCHEMES:
        assert protocol.scheme_spec(name).__dict__ == \
            jproto.scheme_spec(name).__dict__
    with pytest.raises(ValueError, match="unknown scheme"):
        protocol.scheme_spec("nope")


@pytest.mark.parametrize("base", SEEDS)
def test_seed_schedules_bitwise(base):
    for t in (0, 1, 4096, 10 ** 6):
        assert protocol.round_seed(base, t) == jproto.round_seed(base, t)
    for tau in (1, 3, 70000):
        np.testing.assert_array_equal(
            protocol.ProtocolEngine.epoch_seeds(base, tau),
            np.asarray(jproto.ProtocolEngine.epoch_seeds(jnp.uint32(base),
                                                         tau)))
    np.testing.assert_array_equal(
        channel.client_seeds(base, 9).numpy(),
        np.asarray(jchannel.client_seeds(jnp.uint32(base), 9)))
    assert channel.downlink_seed(base) == int(
        jchannel.downlink_seed(jnp.uint32(base)))


@pytest.mark.parametrize("name", ["fp32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("seed", [3, 0xFFFFFFFE])
def test_channels_bitwise(name, seed):
    x = _x(1, (3, 4, 70))
    tc, jc = get_codec(name), jcodec(name)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for port_fn, ref_fn in ((channel.uplink_channel, jchannel.uplink_channel),
                            (channel.unicast_channel,
                             jchannel.unicast_channel)):
        np.testing.assert_array_equal(
            port_fn(tc, xt, seed).numpy(),
            np.asarray(ref_fn(jc, xj, jnp.uint32(seed))))
    np.testing.assert_array_equal(
        channel.broadcast_channel(tc, xt[0], seed).numpy(),
        np.asarray(jchannel.broadcast_channel(jc, xj[0], jnp.uint32(seed))))
    if name == "fp32":
        assert channel.uplink_channel(tc, xt, seed) is xt


def _ref_boundary_grads(op, x, rho, g, seed):
    def f(xx):
        return jnp.sum(op(xx, jnp.asarray(rho), jnp.uint32(seed))
                       * jnp.asarray(g))

    return np.asarray(jax.grad(f)(jnp.asarray(x)))


def _port_boundary_grads(op, x, rho, g, seed):
    xt = torch.from_numpy(x).requires_grad_(True)
    rt = torch.from_numpy(rho).requires_grad_(True)
    y = op(xt, rt, seed)
    (y * torch.from_numpy(g)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), rt.grad


def test_gradagg_backward_matches_custom_vjp():
    x, g, rho = _x(2, (4, 3, 16)), _x(3, (4, 3, 16)), _rho(4)
    before = ga.grad_agg_reduce.launches
    y, gx, grho = _port_boundary_grads(
        lambda a, r, s: gradagg.gradagg(a, r), x, rho, g, 0)
    assert ga.grad_agg_reduce.launches == before  # CPU: plain version
    np.testing.assert_array_equal(y, x)
    want = _ref_boundary_grads(lambda a, r, s: jgradagg.gradagg(a, r), x,
                               rho, g, 0)
    np.testing.assert_allclose(gx, want, rtol=TOL, atol=TOL)
    assert (gx == gx[:1]).all()  # every client gets the same aggregate
    assert torch.equal(grho, torch.zeros(4))


@pytest.mark.parametrize("up,down", [("fp32", "fp32"), ("int8", "int8"),
                                     ("int4", "int8"), ("fp32", "int4")])
def test_gradagg_compressed_matches_custom_vjp(up, down):
    x, g, rho = _x(4, (3, 2, 128)), _x(5, (3, 2, 128)), _rho(3, 1)
    seed = 0xABCDEF01
    op = gradagg.make_gradagg_compressed(up, down)
    jop = jgradagg.make_gradagg_compressed(up, down)
    y, gx, _ = _port_boundary_grads(op, x, rho, g, seed)
    np.testing.assert_array_equal(
        y, np.asarray(jop(jnp.asarray(x), jnp.asarray(rho),
                          jnp.uint32(seed))))
    # the aggregate is an f32 sum (1e-6 apart); it then crosses the
    # downlink codec, where a last-bit difference can move one element by
    # one quantum (absmax/qmax of its tile) in the rare case it sits on a
    # rounding boundary
    want = _ref_boundary_grads(jop, x, rho, g, seed)
    q = np.abs(want).max() / 7.0 if down != "fp32" else 0.0
    np.testing.assert_allclose(gx, want, rtol=TOL, atol=TOL + q)
    assert np.mean(np.abs(gx - want) <= TOL * (1 + np.abs(want))) > 0.99


@pytest.mark.parametrize("scheme", ["sfl_ga", "sfl", "psl"])
@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_engine_boundary_and_ledger(scheme, codec):
    x, g, rho = _x(6, (3, 4, 64)), _x(7, (3, 4, 64)), _rho(3, 2)
    pe = protocol.ProtocolEngine(scheme, codec, codec)
    je = jproto.ProtocolEngine(scheme, codec, codec)
    pl, jl = TrafficLedger(), JLedger()
    pe.attach_ledger(pl, label_bits_per_epoch=256)
    je.attach_ledger(jl, label_bits_per_epoch=256)
    y, gx, _ = _port_boundary_grads(pe.boundary, x, rho, g, 11)
    np.testing.assert_array_equal(
        y, np.asarray(je.boundary(jnp.asarray(x), jnp.asarray(rho),
                                  jnp.uint32(11))))
    jax.effects_barrier()
    assert pl.peek() == jl.peek()
    want = _ref_boundary_grads(je.boundary, x, rho, g, 11)
    np.testing.assert_allclose(gx, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("scheme", ["sfl_ga", "psl"])
@pytest.mark.parametrize("codec", ["fp32", "int8", "int4"])
def test_engine_transport_and_ledger(scheme, codec):
    s_n, rho = _x(8, (4, 2, 96)), _rho(4, 3)
    pe = protocol.ProtocolEngine(scheme, codec, codec)
    je = jproto.ProtocolEngine(scheme, codec, codec)
    pl, jl = TrafficLedger(), JLedger()
    pe.attach_ledger(pl, label_bits_per_epoch=64)
    je.attach_ledger(jl, label_bits_per_epoch=64)
    up = pe.encode_uplink(torch.from_numpy(s_n), 5)
    np.testing.assert_array_equal(
        up.numpy(), np.asarray(je.encode_uplink(jnp.asarray(s_n),
                                                jnp.uint32(5))))
    down = pe.downlink_cotangent(torch.from_numpy(s_n),
                                 torch.from_numpy(rho), 5)
    jdown = je.downlink_cotangent(jnp.asarray(s_n), jnp.asarray(rho),
                                  jnp.uint32(5))
    assert tuple(down.shape) == s_n.shape
    q = np.abs(np.asarray(jdown)).max() / 7.0 \
        if scheme == "sfl_ga" and codec != "fp32" else 0.0
    np.testing.assert_allclose(down.numpy(), np.asarray(jdown), rtol=TOL,
                               atol=TOL + q)
    jax.effects_barrier()
    assert pl.peek() == jl.peek()


@pytest.mark.parametrize("anchored", [False, True])
def test_aggregate_cohort_matches(anchored):
    tree, w = _blocks(0, 5), _rho(5, 4)
    anchor = [{k: v[0] + 0.5 for k, v in b.items()} for b in tree] \
        if anchored else None
    got = protocol.aggregate_cohort(_t(tree), torch.from_numpy(w),
                                    None if anchor is None else _t(anchor))
    want = jproto.aggregate_cohort(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(w),
                                   None if anchor is None else
                                   jax.tree.map(jnp.asarray, anchor))
    assert got[0]["w"].shape == tree[0]["w"].shape[1:]
    _assert_trees_close(got, want)


def test_finalize_cohort_per_scheme():
    tree, w = _blocks(1, 3), _rho(3, 5)
    for scheme in protocol.SCHEMES:
        pe = protocol.ProtocolEngine(scheme)
        je = jproto.ProtocolEngine(scheme)
        pl, jl = TrafficLedger(), JLedger()
        pe.attach_ledger(pl)
        je.attach_ledger(jl)
        pc, ps = pe.finalize_cohort(_t(tree), _t(tree), torch.from_numpy(w))
        jt = jax.tree.map(jnp.asarray, tree)
        jc, js = je.finalize_cohort(jt, jt, jnp.asarray(w))
        _assert_trees_close(pc, jc)
        _assert_trees_close(ps, js)
        jax.effects_barrier()
        assert pl.peek() == jl.peek()


def test_client_drift_and_average():
    tree = _blocks(2, 4)
    got = float(protocol.ProtocolEngine.client_drift(_t(tree)))
    want = float(jproto.ProtocolEngine.client_drift(
        jax.tree.map(jnp.asarray, tree)))
    assert abs(got - want) <= TOL * abs(want)
    same = [{k: np.repeat(v[:1], 4, 0) for k, v in b.items()} for b in tree]
    assert float(protocol.ProtocolEngine.client_drift(_t(same))) == 0.0
    rho = _rho(4, 6)
    _assert_trees_close(
        gradagg.client_param_average(_t(tree), torch.from_numpy(rho)),
        jgradagg.client_param_average(jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(rho)))
    _assert_trees_close(protocol.ProtocolEngine.aggregate(_t(tree)),
                        jproto.ProtocolEngine.aggregate(
                            jax.tree.map(jnp.asarray, tree)))


def test_async_merge_rules_match():
    cur = [{k: v[0] for k, v in b.items()} for b in _blocks(3, 1)]
    deltas, w = _blocks(4, 3), _rho(3, 7)
    tau = np.array([0.0, 1.0, 3.0], np.float32)
    np.testing.assert_allclose(
        protocol.staleness_discount(tau, 0.5).numpy(),
        np.asarray(jproto.staleness_discount(jnp.asarray(tau), 0.5)),
        rtol=TOL)
    got = protocol.merge_async(_t(cur), _t(deltas), w, tau, 0.5)
    want = jproto.merge_async(jax.tree.map(jnp.asarray, cur),
                              jax.tree.map(jnp.asarray, deltas),
                              jnp.asarray(w), jnp.asarray(tau), 0.5)
    _assert_trees_close(got, want)
    np.testing.assert_array_equal(
        protocol.rho_cohort(w, [2, 0], 0.5),
        np.asarray(jproto.rho_cohort(w, [2, 0], 0.5)))
