"""The port's buffered-async engine against the reference's.

Both simulators start from the same params (the reference's
``init_cnn`` draw, carried over with ``convert.cnn_params_from_jax``) and
read the same numpy batches from a data stream pure in the generation.
The event schedule is numpy on both sides (``completion_time_fn``, the
admission sampler), so the merge order, the virtual clock, the
staleness of every merge, the pending queue and ``stats()`` must be
equal exactly; the traffic bits too. Params, losses and drift are f32
trajectories through two libraries' convolutions: within FP32_TOL after
each merge, as in ``test_torch_simulator.py``.

Within the port, bit for bit: the degenerate B = K schedule against
``run_round``; the ``device`` and ``host`` banks; a resumed engine
against an uninterrupted one. An async checkpoint of the reference's
state and meta re-saved by the port is the reference's file byte for
byte, and files cross-restore both ways.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.checkpoint import load_checkpoint_meta as jmeta  # noqa: E402
from repro.configs.paper_cnn import LIGHT_CONFIG as JCFG  # noqa: E402
from repro.core.simulator import FedSimulator as JSim  # noqa: E402
from repro.core.simulator import SimConfig as JSimConfig  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.sysmodel import comm as jcomm  # noqa: E402
from repro.sysmodel import latency as jlat  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs.paper_cnn import LIGHT_CONFIG  # noqa: E402
from repro_torch.convert import cnn_params_from_jax  # noqa: E402
from repro_torch.core.simulator import FedSimulator, SimConfig  # noqa: E402
from repro_torch.obs.ledger import reconcile_events  # noqa: E402
from repro_torch.sysmodel import comm as tcomm  # noqa: E402
from repro_torch.sysmodel import latency as tlat  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

N, K, BATCH = 12, 4, 8
FP32_TOL = 1e-5
SCHEMES = ["sfl_ga", "sfl", "psl", "fl"]


@pytest.fixture(scope="module")
def params0():
    return jax.tree.map(np.asarray, jcnn.init_cnn(jax.random.key(0), JCFG))


def data_fn(d, idx, tau=1):
    rng = np.random.RandomState(1000 + d)
    k = len(idx)
    return (rng.rand(k, tau, BATCH, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, (k, tau, BATCH)).astype(np.int32))


def _kw(scheme="sfl_ga", **kw):
    return dict(dict(scheme=scheme, cut=2, n_clients=N, batch=BATCH,
                     cohort=K, sampler="uniform", cohort_seed=2,
                     drift_metric=True), **kw)


def _port(params0, rec=obs.null_recorder, **kw):
    with obs.use_recorder(rec):
        return FedSimulator(LIGHT_CONFIG, SimConfig(**_kw(**kw)),
                            device="cpu", params=cnn_params_from_jax(params0))


def _ref(**kw):
    return JSim(JCFG, JSimConfig(**_kw(**kw)), seed=0)


def _leaves(state):
    return [p for side in ("client", "server") for blk in state[side]
            for _, p in sorted(blk.items())]


def _assert_state_close(port, ref, tol=FP32_TOL):
    want = jax.tree.map(np.asarray, ref.state)
    got = port.state
    for side in ("client", "server"):
        for pb, wb in zip(got[side], want[side]):
            for k in ("w", "b"):
                np.testing.assert_allclose(pb[k].numpy(), wb[k], rtol=tol,
                                           atol=tol)


def _same_state(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(_leaves(a.state), _leaves(b.state)))


def _queue(eng):
    return [(j.done, j.client, j.gen, j.pos, j.born, j.w)
            for j in eng.pending]


def _spy_merges(eng):
    """Each merge's entries as (client, generation, row, staleness)."""
    order = []
    apply = eng.executor.apply_merge

    def spy(items, taus, *rest):
        order.append([(it["client"], it["gen"], it["pos"], float(tau))
                      for it, tau in zip(items, taus)])
        return apply(items, taus, *rest)

    eng.executor.apply_merge = spy
    return order


# ------------------------------------------------------------- sysmodel
def test_latency_functions_equal_reference():
    """``completion_time_fn``, ``constant_completion_fn`` and
    ``migration_latency`` are float64 numpy on both sides: bit for bit."""
    for n, seed, factor, batch in ((24, 0, 8.0, 8), (64, 5, 4.0, 32),
                                   (7, 11, 1.0, 16), (32, 3, 0.5, 8)):
        a = jlat.completion_time_fn(n, seed=seed, straggler_factor=factor,
                                    batch=batch)
        b = tlat.completion_time_fn(n, seed=seed, straggler_factor=factor,
                                    batch=batch)
        for t in (0, 1, 7, 123):
            np.testing.assert_array_equal(b(t), a(t))
        assert b(0).dtype == np.float64
    c = tlat.constant_completion_fn(5, 2.5)
    np.testing.assert_array_equal(c(3), jlat.constant_completion_fn(5, 2.5)(3))
    c(0)[0] = 9.0  # a fresh array each call
    assert c(0)[0] == 2.5
    rng = np.random.RandomState(0)
    for _ in range(4):
        gains = 10 ** rng.uniform(-11, -8, rng.randint(1, 20))
        for up, down in ((0, 0), (1e6, 0), (0, 3e5), (2.5e6, 7e6)):
            for bw in (1e6, 20e6):
                assert tlat.migration_latency(
                    up, down, gains, tcomm.CommParams(total_bandwidth=bw)) \
                    == jlat.migration_latency(
                        up, down, gains, jcomm.CommParams(total_bandwidth=bw))


# --------------------------------------------------------- against the ref
@pytest.mark.parametrize("scheme", SCHEMES)
def test_engine_matches_reference(params0, scheme):
    """B 2 of K 4 under an 8x straggler spread: the same schedule as the
    reference exactly (clock, merge sizes, staleness, queue, stats,
    bits), params and metrics within FP32_TOL after every merge, and the
    same drained tail."""
    ref, port = _ref(scheme=scheme), _port(params0, scheme=scheme)
    er = ref.async_engine(data_fn, buffer=2, straggler_factor=8.0)
    ep = port.async_engine(data_fn, buffer=2, straggler_factor=8.0)
    orders = _spy_merges(er), _spy_merges(ep)
    exact = ("clock", "merged", "staleness_mean", "staleness_max",
             "queue_depth", "merge_idx", "bits_up", "bits_down")
    stale = []
    for m in range(5):
        a, b = er.step(), ep.step()
        assert {k: b[k] for k in exact} == {k: a[k] for k in exact}, m
        stale.append(b["staleness_mean"])
        assert _queue(ep) == _queue(er)
        for key in ("loss", "client_drift"):
            assert abs(b[key] - a[key]) <= FP32_TOL * max(1.0, abs(a[key]))
        _assert_state_close(port, ref)
    assert ep.stats() == er.stats()
    assert ep.sync_steps == 0 and max(stale) > 0
    assert ep.mean_staleness() == er.mean_staleness()
    np.testing.assert_array_equal(ep.inflight_clients(),
                                  er.inflight_clients())
    tails = er.drain(), ep.drain()
    assert [o["clock"] for o in tails[1]] == [o["clock"] for o in tails[0]]
    assert orders[1] == orders[0] and len(orders[1]) == 5 + len(tails[1])
    assert ep.stats() == er.stats() and ep.queue_depth == 0
    _assert_state_close(port, ref)
    ref.close(), port.close()


def test_refill_and_lambda_match_reference(params0):
    """A refill size other than B and another staleness exponent: the
    same schedule and params as the reference."""
    ref, port = _ref(), _port(params0)
    er = ref.async_engine(data_fn, buffer=3, refill=2, lam=1.5,
                          straggler_factor=4.0)
    ep = port.async_engine(data_fn, buffer=3, refill=2, lam=1.5,
                           straggler_factor=4.0)
    for _ in range(4):
        a, b = er.step(), ep.step()
        assert (b["clock"], b["staleness_mean"]) == (a["clock"],
                                                     a["staleness_mean"])
    assert ep.stats() == er.stats()
    _assert_state_close(port, ref)
    ref.close(), port.close()


# ------------------------------------------------------------ degenerate
@pytest.mark.parametrize("scheme", SCHEMES)
def test_degenerate_schedule_is_run_round(params0, scheme):
    """B = K with zero spread: each step is the port's ``run_round``, bit
    for bit, at the constant schedule's clock."""
    a, b = _port(params0, scheme=scheme), _port(params0, scheme=scheme)
    eng = b.async_engine(data_fn,
                         completion_fn=tlat.constant_completion_fn(N, 1.5))
    for t in range(3):
        want = a.run_round(*data_fn(t, a.cohort_for_round(t)[0]))
        got = eng.step()
        assert {k: got[k] for k in want} == want
        assert (got["clock"], got["queue_depth"]) == (1.5 * (t + 1), 0)
    assert eng.sync_steps == 3 and _same_state(a, b)
    a.close(), b.close()


def test_degenerate_needs_lockstep_and_closes_after_async_dispatch(params0):
    """Once a step dispatched asynchronously the degenerate path stays
    closed, even when later draws look degenerate; the sync path refuses
    a simulator whose round counter left the generation index."""
    sim = _port(params0)

    def completion(d):
        return np.linspace(1.0, 5.0, N) if d == 0 else np.full(N, 1.0)

    eng = sim.async_engine(data_fn, buffer=K, completion_fn=completion)
    for _ in range(3):
        eng.step()
    assert eng.sync_steps == 0 and not eng._sync_ok
    other = _port(params0)
    other.run_round(*data_fn(0, other.cohort_for_round(0)[0]))
    eng = other.async_engine(data_fn,
                             completion_fn=tlat.constant_completion_fn(N))
    with pytest.raises(RuntimeError, match="lockstep"):
        eng.step()
    with pytest.raises(ValueError, match="buffer"):
        sim.async_engine(data_fn, buffer=K + 1)
    with pytest.raises(ValueError, match="outside"):
        sim.async_engine(data_fn, buffer=0)
    sim.close(), other.close()


# ----------------------------------------------------------------- banks
@pytest.mark.parametrize("scheme,sampler", [("sfl_ga", "uniform"),
                                            ("psl", "uniform"),
                                            ("sfl_ga", "rho")])
def test_device_and_host_banks_bit_identical(params0, scheme, sampler):
    """Residency is a performance choice under the event engine too: the
    host bank's merges, prefetched admissions and duplicate draws (rho)
    give the device bank's run bit for bit after every merge."""
    sims = [_port(params0, scheme=scheme, sampler=sampler, bank=bank)
            for bank in ("device", "host")]
    engs = [s.async_engine(data_fn, buffer=2, straggler_factor=8.0)
            for s in sims]
    for _ in range(6):
        outs = [e.step() for e in engs]
        assert outs[0] == outs[1]
        assert _same_state(*sims)
    st = sims[1].bank.stats()
    assert st["prefetch_hits"] + st["prefetch_misses"] > 0
    assert st["device_bytes_peak"] <= 2 * st["bank_bytes"] // N * K
    for s in sims:
        s.close()


def test_prefetch_never_reads_a_row_a_pending_merge_writes(params0):
    """Every staged admission is disjoint from the clients in flight when
    it is staged; the run still matches the device bank."""
    host = _port(params0, bank="host")
    eng = host.async_engine(data_fn, buffer=1, straggler_factor=8.0)
    ex = eng.executor
    staged = []
    prefetch = host.bank.prefetch

    def spy(t, idx):
        staged.append((t, set(np.asarray(idx).tolist()), set(ex._inflight)))
        return prefetch(t, idx)

    host.bank.prefetch = spy
    dev = _port(params0)
    deng = dev.async_engine(data_fn, buffer=1, straggler_factor=8.0)
    for _ in range(8):
        assert eng.step() == deng.step()
    assert staged and all(not (idx & busy) for _, idx, busy in staged)
    assert _same_state(host, dev)
    host.close(), dev.close()


# --------------------------------------------------------------- traffic
@pytest.mark.parametrize("scheme", SCHEMES)
def test_traffic_measured_equals_modeled(params0, scheme):
    """Per merge, the ledger's measured bits equal the model at the
    step's dispatch and merge sizes, for every category; the async event
    and the gauges carry the reference's names."""
    rec = obs.Recorder()
    sim = _port(params0, rec, scheme=scheme, tau=2)
    with obs.use_recorder(rec):
        eng = sim.async_engine(lambda d, idx: data_fn(d, idx, tau=2),
                               buffer=2, straggler_factor=8.0)
        for _ in range(4):
            eng.step()
        eng.drain()
    traffic = [e for e in rec.events if e.get("kind") == "traffic"]
    merges = [e for e in rec.events if e.get("kind") == "async"]
    assert len(traffic) == len(merges) >= 5
    assert all(e["name"] == "async_traffic" for e in traffic)
    assert all(m["name"] == "merge" for m in merges)
    rows, bad = reconcile_events(traffic)
    assert bad == 0 and len(rows) == len(traffic)
    assert all(e["measured"] == e["modeled"] for e in traffic)
    assert sum(len(m["dispatched"]) for m in merges) == eng.dispatch_idx
    gauges = {e.get("name") for e in rec.events if e.get("kind") == "gauge"}
    assert {"async_queue_depth", "async_staleness", "epoch_loss"} <= gauges
    sim.close()


def test_bits_match_reference_events(params0):
    """The port's async traffic events carry the reference's modeled
    bits, merge by merge."""
    jrec, trec = jobs.Recorder(), obs.Recorder()
    with jobs.use_recorder(jrec):
        ref = _ref(scheme="sfl", uplink_codec="int8")
        er = ref.async_engine(data_fn, buffer=2, straggler_factor=8.0)
        for _ in range(3):
            er.step()
    port = _port(params0, trec, scheme="sfl", uplink_codec="int8")
    with obs.use_recorder(trec):
        ep = port.async_engine(data_fn, buffer=2, straggler_factor=8.0)
        for _ in range(3):
            ep.step()

    def view(events):
        return [(e["modeled"], e["measured"], e["dispatched"])
                for e in events if e.get("kind") == "traffic"]

    assert view(trec.events) == view(jrec.events)
    ref.close(), port.close()


# ----------------------------------------------------------- checkpoints
def test_checkpoint_bytes_equal_reference_and_cross_restore(params0,
                                                            tmp_path):
    """The reference's async file restored into the port and saved again
    is the reference's file byte for byte (same state, same meta); the
    port's file resumes in the reference, and both continue on the same
    schedule."""
    ref = _ref()
    er = ref.async_engine(data_fn, buffer=2, straggler_factor=8.0)
    for _ in range(3):
        er.step()
    pj, pt = tmp_path / "ref.ckpt", tmp_path / "port.ckpt"
    er.save(str(pj), {"note": "x"})
    port = _port(params0, cut=3)
    ep = port.async_engine(data_fn, buffer=2, straggler_factor=8.0)
    meta = ep.restore(str(pj))
    assert meta == jmeta(str(pj)) and port.cut == 2
    assert _queue(ep) == _queue(er) and ep.stats() == er.stats()
    ep.save(str(pt), {"note": "x"})
    assert pt.read_bytes() == pj.read_bytes()
    a, b = er.step(), ep.step()
    assert (a["clock"], a["staleness_mean"]) == (b["clock"],
                                                 b["staleness_mean"])
    _assert_state_close(port, ref)
    ep.save(str(pt))
    back = _ref(cut=1)
    eb = back.async_engine(data_fn, buffer=2, straggler_factor=8.0)
    eb.restore(str(pt))
    assert eb.stats() == ep.stats() and _queue(eb) == _queue(ep)
    want = _leaves(port.state)
    got = jax.tree.leaves(jax.tree.map(np.asarray, back.state))
    for x, y in zip(want, got):
        np.testing.assert_array_equal(y, x.numpy())
    with pytest.raises(ValueError, match="async_buffer"):
        port.async_engine(data_fn, buffer=3).restore(str(pt))
    ref.close(), port.close(), back.close()


@pytest.mark.parametrize("bank", ["device", "host"])
def test_resume_bit_identical(params0, tmp_path, bank):
    """Saved at the first merge with payloads of both generation sizes in
    flight (the first admission's K rows and a refill's B), restored into
    a fresh simulator: the rest of the run is the uninterrupted run's,
    bit for bit."""
    path = str(tmp_path / "a.ckpt")
    whole = _port(params0, bank=bank)
    ew = whole.async_engine(data_fn, buffer=1, straggler_factor=8.0)
    outs, saved = [], None
    for m in range(8):
        outs.append(ew.step())
        sizes = {g["size"] for g in ew._gens.values()}
        if saved is None and sizes == {K, 1}:
            ew.save(path)
            saved = m + 1
    assert saved is not None and saved < 8
    fresh = _port(params0, bank=bank)
    ef = fresh.async_engine(data_fn, buffer=1, straggler_factor=8.0)
    assert ef.restore(path)["async_merge_idx"] == saved
    assert [ef.step() for _ in range(8 - saved)] == outs[saved:]
    assert ef.stats() == ew.stats() and _same_state(whole, fresh)
    whole.close(), fresh.close()
