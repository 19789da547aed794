"""The port's closed loop (``core.closed_loop.run_closed_loop``) against
the reference's.

Both loops train from the same params (the reference's ``init_cnn``
draw, carried over with ``convert.cnn_params_from_jax``) on the same
synthetic data (``make_image_dataset`` is numpy on both sides) under the
same env seed. The env, the P2.1 solve, the migration pricing and the
cohort draws are float64 numpy on both sides, so cuts, migrations and
migration bits must be equal exactly and latencies within rtol 1e-6 (the
P2.1 bisection's stopping rule is the only place two f64 codes could
part). Losses are f32 training through two libraries' convolutions:
within FP32_TOL, as in ``test_torch_simulator.py``. Within the port, a
constant schedule is the fixed-cut loop bit for bit.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ccc.env import CuttingPointEnv as JEnv  # noqa: E402
from repro.ccc.env import cnn_env_config as jenv_config  # noqa: E402
from repro.configs.paper_cnn import LIGHT_CONFIG as JCFG  # noqa: E402
from repro.core import closed_loop as jcl  # noqa: E402
from repro.core.simulator import FedSimulator as JSim  # noqa: E402
from repro.core.simulator import SimConfig as JSimConfig  # noqa: E402
from repro.data import make_image_dataset as jdataset  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.sysmodel.comm import CommParams as JComm  # noqa: E402
from repro.sysmodel.comp import CompParams as JComp  # noqa: E402
from repro_torch.ccc.env import CuttingPointEnv, cnn_env_config  # noqa: E402
from repro_torch.configs.paper_cnn import LIGHT_CONFIG  # noqa: E402
from repro_torch.convert import cnn_params_from_jax  # noqa: E402
from repro_torch.core import closed_loop as tcl  # noqa: E402
from repro_torch.core.protocol import round_seed  # noqa: E402
from repro_torch.core.simulator import FedSimulator, SimConfig  # noqa: E402
from repro_torch.data import (iid_partition, make_image_dataset,  # noqa: E402
                              rho_weights, round_batches)
from repro_torch.models import cnn  # noqa: E402
from repro_torch.sysmodel.comm import CommParams  # noqa: E402
from repro_torch.sysmodel.comp import CompParams  # noqa: E402
from repro_torch.sysmodel.traffic import migration_bits  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

BATCH = 8
FP32_TOL = 1e-5
LAT_RTOL = 1e-6
# fig. 10's comm-bound corner: 1 MHz uplink band, 1 GHz clients
BANDWIDTH, CLIENT_CPU = 1e6, 1e9


@pytest.fixture(scope="module")
def params0():
    return jax.tree.map(np.asarray, jcnn.init_cnn(jax.random.key(0), JCFG))


@pytest.fixture(scope="module")
def data():
    ds = make_image_dataset("mnist", n=400, seed=0)
    train, test = ds.split(0.9)
    jtrain, jtest = jdataset("mnist", n=400, seed=0).split(0.9)
    np.testing.assert_array_equal(jtrain.x, train.x)
    return train, test, jtrain, jtest


def _pair(params0, n, **kw):
    cfg = dict(scheme="sfl_ga", cut=2, n_clients=n, batch=BATCH, **kw)
    parts = iid_partition(360, n, seed=0)
    rho = rho_weights(parts)
    ref = JSim(JCFG, JSimConfig(**cfg), rho=rho, seed=0)
    port = FedSimulator(LIGHT_CONFIG, SimConfig(**cfg), rho=rho, device="cpu",
                        params=cnn_params_from_jax(params0))
    return ref, port, parts


def _envs(n, cohort=None, comm_bound=False, async_obs=False):
    kw = dict(n_clients=n, batch=BATCH, seed=0, cohort=cohort,
              async_obs=async_obs)
    jkw, tkw = {}, {}
    if comm_bound:
        jkw = dict(comm=JComm(total_bandwidth=BANDWIDTH),
                   comp=JComp(client_cpu_max=CLIENT_CPU))
        tkw = dict(comm=CommParams(total_bandwidth=BANDWIDTH),
                   comp=CompParams(client_cpu_max=CLIENT_CPU))
    return (JEnv(jenv_config(**kw), **jkw),
            CuttingPointEnv(cnn_env_config(**kw), **tkw))


def _data_fn(train, parts):
    def data_fn(d, idx):
        rng = np.random.RandomState(int(round_seed(0, d)) % (2**31 - 1))
        return round_batches(train, parts, BATCH, 1, rng, idx=np.asarray(idx))

    return data_fn


def _assert_results_match(a, b):
    assert b.cuts == a.cuts and b.n_migrations == a.n_migrations
    assert b.migration_bits_total == a.migration_bits_total
    assert b.total_bits == a.total_bits
    assert b.infeasible_rounds == a.infeasible_rounds
    for ra, rb in zip(a.records, b.records):
        assert (rb["round"], rb["cut"], rb["migration_bits"], rb["bits"]) \
            == (ra["round"], ra["cut"], ra["migration_bits"], ra["bits"])
        for key in ("latency_s", "migration_s", "wall_clock_s"):
            np.testing.assert_allclose(rb[key], ra[key], rtol=LAT_RTOL)
        assert abs(rb["loss"] - ra["loss"]) <= FP32_TOL * max(1.0,
                                                               abs(ra["loss"]))
    np.testing.assert_allclose(b.total_latency_s, a.total_latency_s,
                               rtol=LAT_RTOL)
    assert [t for t, _ in b.curve] == pytest.approx(
        [t for t, _ in a.curve], rel=LAT_RTOL)


def test_constant_schedule_bit_identical_to_fixed_cut(params0, data):
    """No migration, the same codec-seed position and the fixed-cut
    loop's params bit for bit (the loop draws the same batches and runs
    the same rounds)."""
    train, test, _, _ = data
    _, fixed, parts = _pair(params0, 4, uplink_codec="int8",
                            downlink_codec="int8")
    rng = np.random.RandomState(7)
    for t in range(4):
        fixed.run_round(*round_batches(train, parts, BATCH, 1, rng,
                                       idx=fixed.cohort_for_round(t)[0]))
    _, port, _ = _pair(params0, 4, uplink_codec="int8",
                       downlink_codec="int8")
    res = tcl.run_closed_loop(port, _envs(4)[1], tcl.CutSchedule.constant(2),
                              train, test, parts, rounds=4, eval_every=2,
                              batch_seed=7)
    assert res.n_migrations == 0 and res.migration_bits_total == 0
    assert port._t == fixed._t == 4 and len(res.curve) == 2
    for side in ("client", "server"):
        for a, b in zip(fixed.state[side], port.state[side]):
            for k in a:
                assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("alloc,comm_bound", [("opt", False),
                                              ("fixed", False),
                                              ("opt", True)])
def test_dynamic_schedule_matches_reference(params0, data, alloc,
                                            comm_bound):
    """A cycled schedule that moves the cut both ways: the reference's
    cuts, migrations, migration bits and latencies, and its losses
    within FP32_TOL."""
    train, test, jtrain, jtest = data
    ref, port, parts = _pair(params0, 4)
    jenv, tenv = _envs(4, comm_bound=comm_bound)
    seq = [2, 3, 1, 2, 4]
    a = jcl.run_closed_loop(ref, jenv, jcl.CutSchedule.from_sequence(seq),
                            jtrain, jtest, parts, rounds=5, alloc=alloc,
                            eval_every=2, batch_seed=1)
    b = tcl.run_closed_loop(port, tenv, tcl.CutSchedule.from_sequence(seq),
                            train, test, parts, rounds=5, alloc=alloc,
                            eval_every=2, batch_seed=1)
    _assert_results_match(a, b)
    assert b.n_migrations == 4
    be8 = 32
    for t in range(1, 5):
        want = migration_bits(cnn.phi(LIGHT_CONFIG, seq[t - 1]),
                              cnn.phi(LIGHT_CONFIG, seq[t]), n_clients=4,
                              raw_bits_per_elem=be8)["total_bits"]
        assert b.records[t]["migration_bits"] == want > 0
        assert b.records[t]["migration_s"] > 0


def test_cohort_threaded_through_env_matches_reference(params0, data):
    """K 3 of N 6: each round's cohort sets the env's channel state; the
    reference's schedule and pricing exactly."""
    train, test, jtrain, jtest = data
    ref, port, parts = _pair(params0, 6, cohort=3, sampler="uniform",
                             cohort_seed=4)
    jenv, tenv = _envs(6, cohort=3)
    seq = [2, 1, 3]
    a = jcl.run_closed_loop(ref, jenv, jcl.CutSchedule.from_sequence(seq),
                            jtrain, jtest, parts, rounds=4, eval_every=4,
                            batch_seed=2)
    b = tcl.run_closed_loop(port, tenv, tcl.CutSchedule.from_sequence(seq),
                            train, test, parts, rounds=4, eval_every=4,
                            batch_seed=2)
    _assert_results_match(a, b)
    np.testing.assert_array_equal(tenv.gains, jenv.gains)


def test_async_closed_loop_matches_reference(params0, data):
    """With the async engine: the engine's virtual clock is each round's
    latency, the queue is drained before every migration, and the
    reference's schedule holds exactly."""
    train, test, jtrain, jtest = data
    ref, port, parts = _pair(params0, 8, cohort=4, sampler="uniform")
    jenv, tenv = _envs(8, cohort=4, async_obs=True)
    er = ref.async_engine(_data_fn(jtrain, parts), buffer=2,
                          straggler_factor=8.0)
    ep = port.async_engine(_data_fn(train, parts), buffer=2,
                           straggler_factor=8.0)
    depths = []
    set_cut = port.set_cut

    def spy(v):
        if v != port.cut:
            depths.append(ep.queue_depth)
        return set_cut(v)

    port.set_cut = spy
    seq = [2, 2, 3, 1]
    a = jcl.run_closed_loop(ref, jenv, jcl.CutSchedule.from_sequence(seq),
                            jtrain, jtest, parts, rounds=5, eval_every=5,
                            batch_seed=0, async_engine=er)
    b = tcl.run_closed_loop(port, tenv, tcl.CutSchedule.from_sequence(seq),
                            train, test, parts, rounds=5, eval_every=5,
                            batch_seed=0, async_engine=ep)
    _assert_results_match(a, b)
    assert depths == [0, 0, 0] and ep.queue_depth == 0
    assert ep.stats() == er.stats()
    assert len(b.curve) == 2  # the post-drain point
    assert tenv.state_dim == 4 + 1 + 2


def test_ddqn_schedule_and_result_helpers(params0, data):
    """A trained policy queried live (the batched agent's action comes
    back as a tensor), and ``acc_at_time``'s step interpolation."""
    from repro_torch.ccc.strategy import run_algorithm1

    train, test, _, _ = data
    _, port, parts = _pair(params0, 4)
    env = _envs(4)[1]
    res = run_algorithm1(_envs(4)[1], episodes=2, device="cpu")
    out = tcl.run_closed_loop(port, env, res.cut_schedule(env), train, test,
                              parts, rounds=3, eval_every=1)
    assert all(1 <= v < LIGHT_CONFIG.num_layers for v in out.cuts)
    assert len(out.curve) == 3 and out.final_acc == out.curve[-1][1]
    r = tcl.ClosedLoopResult("x", [], [], [(1.0, 0.2), (2.5, 0.4)], 0.4,
                             2.5, 0.0, 0.0, 0)
    assert [r.acc_at_time(t) for t in (0.5, 1.0, 2.0, 9.0)] == [0.0, 0.2,
                                                                0.2, 0.4]


def test_fixed_alloc_latency_matches_reference():
    """The equal-split latency the loop charges for alloc="fixed" and for
    infeasible rounds, at every cut."""
    jenv, tenv = _envs(5, comm_bound=True)
    for v in range(1, LIGHT_CONFIG.num_layers):
        assert tcl._fixed_alloc_latency(tenv, v) == \
            jcl._fixed_alloc_latency(jenv, v)
