"""The port's ``FedSimulator`` against the reference's, end to end.

Both start from the same params (the reference's ``init_cnn`` draw,
carried over with ``convert.cnn_params_from_jax``) and train on the same
numpy batches for a few rounds of ``LIGHT_CONFIG``; per-round loss,
drift and bits, and the final client bank and server model, are
compared. Every round's traffic ledger must equal
``round_traffic_breakdown`` exactly.

Tolerances. fp32: 1e-5 -- convolutions and matmuls in two f32 libraries
round differently in the last bits, and three SGD rounds keep that
near 1e-7. int8/int4: the codec is pinned bit for bit elsewhere
(``test_torch_quantize.py``), but here it quantizes activations that
differ in the last bits, and a value sitting on a rounding boundary can
take the neighbouring code: one quantum (absmax/qmax of its tile) on
one element (``test_int8_flips_sit_on_rounding_boundaries`` audits each
such flip). So 1e-3, plus the check that 99 % of the parameters still
agree at 1e-5.

Rounds. The fp32 cases run three compounding rounds. The int-codec
cases are held one round at a time: before each round the reference's
state is carried into the port (``convert.cnn_params_from_jax``), so
each round starts from the same params. Over compounding rounds a flip
in one round moves the next round's inputs by a quantum, and SGD
amplifies that into a trajectory that depends on the CPU's f32 rounding
(sfl and psl at int8 drift to 2e-3 after three rounds on some CPUs and
stay inside on others); one round from equal params keeps what is
compared to one round's flips.

Cohorts. K < N runs (the ``uniform`` and ``rho`` samplers, the anchored
merge, the ``host`` bank) are held to the reference at the fp32
tolerance.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_cnn import LIGHT_CONFIG as JCFG  # noqa: E402
from repro.core import protocol as jproto  # noqa: E402
from repro.core.simulator import FedSimulator as JSim  # noqa: E402
from repro.core.simulator import SimConfig as JSimConfig  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.sysmodel import traffic as jtraffic  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs.paper_cnn import LIGHT_CONFIG  # noqa: E402
from repro_torch.convert import cnn_params_from_jax  # noqa: E402
from repro_torch.core import protocol as tproto  # noqa: E402
from repro_torch.core.async_engine import AsyncRoundEngine  # noqa: E402
from repro_torch.core.simulator import FedSimulator, SimConfig  # noqa: E402
from repro_torch.obs.ledger import reconcile_events  # noqa: E402
from _torch_dist import _no_process_group_left  # noqa: E402,F401
from _torch_threads import _one_torch_thread  # noqa: E402,F401

K, B, ROUNDS = 3, 8, 3

FP32_TOL = 1e-5
INT_TOL = 1e-3

# (scheme, codec, cut, tau): every scheme at fp32 and int8, sfl_ga at int4
# with two local epochs, and cuts 1 and 3
CASES = [(s, c, 2, 1) for s in ("sfl_ga", "sfl", "psl", "fl")
         for c in ("fp32", "int8")] + [
    ("sfl_ga", "int4", 2, 2), ("sfl_ga", "int8", 1, 1),
    ("psl", "fp32", 3, 1), ("sfl", "int4", 3, 2)]


@pytest.fixture(scope="module")
def params0():
    return jax.tree.map(np.asarray, jcnn.init_cnn(jax.random.key(0), JCFG))


def _batches(tau, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(ROUNDS):
        yield (rng.rand(K, tau, B, 28, 28, 1).astype(np.float32),
               rng.randint(0, 10, (K, tau, B)).astype(np.int32))


def _sims(params0, rec=obs.null_recorder, **kw):
    """The reference and the port from the same params; the port records
    into ``rec``."""
    rho = np.array([0.5, 0.3, 0.2], np.float32)
    ref = JSim(JCFG, JSimConfig(n_clients=K, batch=B, **kw), rho=rho, seed=0)
    with obs.use_recorder(rec):
        port = FedSimulator(LIGHT_CONFIG,
                            SimConfig(n_clients=K, batch=B, **kw), rho=rho,
                            device="cpu", params=cnn_params_from_jax(params0))
    return ref, port


def _carry(ref, port):
    """The reference's state, carried into the port before a round."""
    want = jax.tree.map(np.asarray, ref.state)
    port.bank.replace(cnn_params_from_jax(want["client"]))
    port.server = cnn_params_from_jax(want["server"])


def _assert_state_close(port, ref, tol):
    fracs = []
    want = jax.tree.map(np.asarray, ref.state)
    for side in ("client", "server"):
        assert len(port.state[side]) == len(want[side])
        for pb, wb in zip(port.state[side], want[side]):
            for k in ("w", "b"):
                got = pb[k].numpy()
                assert got.shape == wb[k].shape
                np.testing.assert_allclose(got, wb[k], rtol=tol, atol=tol)
                fracs.append(np.abs(got - wb[k]) <= FP32_TOL * (
                    1 + np.abs(wb[k])))
    assert np.concatenate([f.reshape(-1) for f in fracs]).mean() > 0.99


@pytest.mark.parametrize("scheme,codec,cut,tau", CASES)
def test_rounds_match_reference(params0, scheme, codec, cut, tau):
    kw = dict(scheme=scheme, cut=cut, tau=tau, uplink_codec=codec,
              downlink_codec=codec)
    rec = obs.Recorder()
    ref, port = _sims(params0, rec, **kw)
    tol = FP32_TOL if codec == "fp32" else INT_TOL
    for x, y in _batches(tau):
        if codec != "fp32":
            _carry(ref, port)
        a, b = ref.run_round(x, y), port.run_round(x, y)
        assert (b["bits_up"], b["bits_down"]) == (a["bits_up"],
                                                  a["bits_down"])
        assert abs(b["loss"] - a["loss"]) <= tol * max(1.0, abs(a["loss"]))
        assert abs(b["client_drift"] - a["client_drift"]) <= tol * max(
            1.0, abs(a["client_drift"]))
        if codec != "fp32":
            _assert_state_close(port, ref, tol)
    _assert_state_close(port, ref, tol)

    traffic = [e for e in rec.events if e["kind"] == "traffic"]
    assert len(traffic) == ROUNDS
    modeled = jtraffic.round_traffic_breakdown(scheme, **ref._traffic_kwargs())
    for ev in traffic:
        assert ev["measured"] == ev["modeled"] == modeled
    rows, bad = reconcile_events(rec.events)
    assert len(rows) == ROUNDS and bad == 0
    kinds = [e["kind"] for e in rec.events]
    assert kinds.count("round") == kinds.count("cohort") == ROUNDS


def test_accounting_matches_reference(params0):
    for scheme in ("sfl_ga", "sfl", "psl", "fl"):
        for codec in ("fp32", "int4"):
            ref, port = _sims(params0, scheme=scheme, cut=2,
                              uplink_codec=codec, downlink_codec="int8")
            assert port.comm_bits_per_round() == ref.comm_bits_per_round()
            assert port.comm_bytes_per_round() == ref.comm_bytes_per_round()
            assert port.comm_breakdown_per_round() == \
                ref.comm_breakdown_per_round()


@pytest.mark.parametrize("scheme", ["sfl_ga", "sfl"])
def test_set_cut_round_trip_and_evaluate(params0, scheme):
    rec = obs.Recorder()
    ref, port = _sims(params0, rec, scheme=scheme, cut=2)
    batches = list(_batches(1, seed=1))
    for x, y in batches[:2]:
        ref.run_round(x, y), port.run_round(x, y)
    for v in (3, 1, 2):
        assert port.set_cut(v) == ref.set_cut(v)
        _assert_state_close(port, ref, FP32_TOL)
    assert port.set_cut(2) == {"up_bits": 0, "down_bits": 0, "total_bits": 0}
    x, y = batches[2]
    a, b = ref.run_round(x, y), port.run_round(x, y)
    assert abs(a["loss"] - b["loss"]) <= FP32_TOL * max(1.0, abs(a["loss"]))
    _assert_state_close(port, ref, FP32_TOL)
    mig = [e for e in rec.events if e["kind"] == "migration"]
    assert len(mig) == 3
    rows, bad = reconcile_events(rec.events)
    assert bad == 0 and len(rows) == 3 + 3

    rng = np.random.RandomState(2)
    xt = rng.rand(70, 28, 28, 1).astype(np.float32)
    yt = rng.randint(0, 10, 70).astype(np.int32)
    assert port.evaluate(xt, yt, batch=32) == ref.evaluate(xt, yt, batch=32)
    gp = port.global_params()
    for pb, wb in zip(gp, ref.global_params()):
        for k in pb:
            np.testing.assert_allclose(pb[k].numpy(), np.asarray(wb[k]),
                                       rtol=FP32_TOL, atol=FP32_TOL)


def test_fl_has_no_cut(params0):
    _, port = _sims(params0, scheme="fl")
    with pytest.raises(ValueError, match="no cut"):
        port.set_cut(2)


@pytest.mark.parametrize("kw,what", [
    (dict(bank="host"), "bank"), (dict(sampler="uniform", cohort=2),
                                  "sampler"),
    (dict(cohort=2), "cohort")])
def test_later_slices_raise(params0, kw, what):
    """What the first slices refused now runs: the host bank (bit for bit
    the device bank's rounds), the uniform sampler at K 2 of 3, and a
    cohort of 2 -- refused, as in the reference, under the ``full``
    sampler (K must equal N there) and run under ``latency``."""
    x, y = next(_batches(1, seed=5))
    if what == "cohort":
        with pytest.raises(ValueError, match="needs K == N"):
            FedSimulator(LIGHT_CONFIG, SimConfig(n_clients=K, **kw),
                         device="cpu")
        kw = dict(kw, sampler="latency")
    cfg = SimConfig(n_clients=K, batch=B, cut=2, **kw)
    sim = FedSimulator(LIGHT_CONFIG, cfg, device="cpu",
                       params=cnn_params_from_jax(params0))
    k = sim.n_participants
    assert k == (K if what == "bank" else 2)
    out = sim.run_round(x[:k], y[:k])
    assert np.isfinite(out["loss"]) and np.isfinite(out["client_drift"])
    if what == "bank":
        dev = FedSimulator(LIGHT_CONFIG, dataclasses.replace(
            cfg, bank="device", drift_metric=True), device="cpu",
            params=cnn_params_from_jax(params0))
        assert dev.run_round(x, y)["loss"] == out["loss"]
        for pb, db in zip(sim.state["client"], dev.state["client"]):
            for name in pb:
                assert torch.equal(pb[name], db[name])
    sim.close()


def test_checkpoint_and_async_raise_naming_slice_3(params0, tmp_path,
                                                   _no_process_group_left):
    """``save``/``restore`` round-trip (the round counter and the state
    come back bit for bit); the sharded bank runs at one rank (a round
    equal to the device bank's) and refuses the device run's checkpoint;
    the async engine is built over the simulator and steps
    (``test_torch_async.py`` holds it to the reference)."""
    ref, port = _sims(params0, scheme="sfl_ga", cut=2, uplink_codec="int8",
                      downlink_codec="int8")
    batches = list(_batches(1, seed=6))
    first = port.run_round(*batches[0])
    path = str(tmp_path / "sim.ckpt")
    port.save(path)
    _, again = _sims(params0, scheme="sfl_ga", cut=3, uplink_codec="int8",
                     downlink_codec="int8")
    assert again.restore(path)["t"] == 1 and again._t == 1
    assert again.cut == 2
    for x, y in batches[1:]:
        assert port.run_round(x, y) == again.run_round(x, y)
    for side in ("client", "server"):
        for pb, qb in zip(port.state[side], again.state[side]):
            for name in pb:
                assert torch.equal(pb[name], qb[name])
    sharded = FedSimulator(LIGHT_CONFIG, dataclasses.replace(
        port.sim, bank="sharded"), rho=port.rho_np, device="cpu",
        params=cnn_params_from_jax(params0))
    assert sharded.run_round(*batches[0]) == first
    with pytest.raises(ValueError, match="bank backend 'device'"):
        sharded.restore(path)
    eng = port.async_engine(lambda d, idx: next(_batches(1, seed=d)))
    assert isinstance(eng, AsyncRoundEngine) and eng.buffer == K
    assert eng.step()["merge_idx"] == 0


@pytest.mark.parametrize("scheme", ["sfl", "psl"])
def test_int8_flips_sit_on_rounding_boundaries(params0, monkeypatch,
                                               scheme):
    """Round 0 of the int8 unicast schemes from equal params: every
    uplink and downlink code on which the port and the reference differ
    is one step from the reference's, and its pre-rounding value x/scale
    + u sits within float32 noise of an integer -- the two libraries'
    inputs agree to f32 rounding and land on either side of the
    boundary. The codec itself is bit for bit (``test_torch_protocol``);
    this audits what the int cases of ``test_rounds_match_reference``
    tolerate."""
    from repro_torch.compress.channel import client_seeds, downlink_seed
    from repro_torch.kernels.quantize import _u32, hash_uniform, quantize_ref

    seen = {"ref": [], "port": []}

    def spy(module, side, name):
        orig = getattr(module, name)

        def ref_fn(codec, x, seed):
            jax.debug.callback(lambda a, s: seen[side].append(
                (name, np.array(a), int(s))), x, seed)
            return orig(codec, x, seed)

        def port_fn(codec, x, seed):
            seen[side].append((name, x.detach().numpy().copy(), int(seed)))
            return orig(codec, x, seed)

        monkeypatch.setattr(module, name, ref_fn if side == "ref"
                            else port_fn)

    for name in ("uplink_channel", "unicast_channel"):
        spy(jproto, "ref", name)
        spy(tproto, "port", name)
    ref, port = _sims(params0, scheme=scheme, cut=2, uplink_codec="int8",
                      downlink_codec="int8")
    x, y = next(_batches(1))
    ref.run_round(x, y), port.run_round(x, y)
    jax.effects_barrier()
    assert [c[0] for c in seen["ref"]] == [c[0] for c in seen["port"]] == [
        "uplink_channel", "unicast_channel"]
    flipped_clients = set()
    for (name, xr, seed), (_, xp, seed_p) in zip(seen["ref"], seen["port"]):
        assert seed == seed_p and xr.shape == xp.shape
        np.testing.assert_allclose(xp, xr, rtol=FP32_TOL, atol=FP32_TOL)
        k = xr.shape[0]
        seeds = client_seeds(seed if name == "uplink_channel"
                             else downlink_seed(seed), k)
        rows = [torch.from_numpy(a.reshape(k, -1)) for a in (xr, xp)]
        pad = (-rows[0].shape[1]) % 256
        rows = [torch.nn.functional.pad(r, (0, pad)) for r in rows]
        (qr, sr), (qp, sp) = [quantize_ref(r[:, None], 0, 8, 1, 256, True,
                                           seeds) for r in rows]
        step = (qp.to(torch.int32) - qr.to(torch.int32)).reshape(k, -1)
        u = hash_uniform(0, 0, torch.arange(rows[0].shape[1]),
                         _u32(seeds)[:, None])
        vr, vp = [(r / s.reshape(k, -1).repeat_interleave(256, 1) + u)
                  .numpy() for r, s in ((rows[0], sr), (rows[1], sp))]
        step = step.numpy()
        diff = step != 0
        if name == "unicast_channel":  # a flipped uplink moves s^n more
            diff[sorted(flipped_clients)] = False
        assert np.abs(step[diff]).max(initial=0) <= 1
        assert np.all(np.floor(vr[diff]) != np.floor(vp[diff]))
        assert np.abs(vr[diff] - vp[diff]).max(initial=0) <= 1e-4
        assert diff.sum() <= 1e-3 * diff.size
        if name == "uplink_channel":
            flipped_clients = set(np.flatnonzero(diff.any(1)).tolist())


@pytest.mark.parametrize("sampler,scheme,bank", [
    ("uniform", "sfl_ga", "device"), ("uniform", "sfl", "device"),
    ("uniform", "psl", "host"), ("rho", "sfl_ga", "host"),
    ("rho", "sfl", "device"), ("rho", "psl", "device")])
def test_partial_cohorts_match_reference(params0, sampler, scheme, bank):
    """K 2 of N 5 under the uniform and rho samplers (the anchored merge;
    rho draws with replacement): the same cohorts, and rounds, drift and
    state within the fp32 tolerance of the reference."""
    n, k = 5, 2
    rho = np.array([0.1, 0.3, 0.2, 0.25, 0.15], np.float32)
    kw = dict(scheme=scheme, cut=2, n_clients=n, batch=B, cohort=k,
              sampler=sampler, cohort_seed=4)
    ref = JSim(JCFG, JSimConfig(bank="device", drift_metric=True, **kw),
               rho=rho, seed=0)
    port = FedSimulator(LIGHT_CONFIG, SimConfig(bank=bank, drift_metric=True,
                                                **kw), rho=rho, device="cpu",
                        params=cnn_params_from_jax(params0))
    rng = np.random.RandomState(7)
    for t in range(3):
        for got, want in zip(port.cohort_for_round(t),
                             ref.cohort_for_round(t)):
            np.testing.assert_array_equal(got, want)
        x = rng.rand(k, 1, B, 28, 28, 1).astype(np.float32)
        y = rng.randint(0, 10, (k, 1, B)).astype(np.int32)
        a, b = ref.run_round(x, y), port.run_round(x, y)
        assert (b["bits_up"], b["bits_down"]) == (a["bits_up"],
                                                  a["bits_down"])
        for key in ("loss", "client_drift"):
            assert abs(b[key] - a[key]) <= FP32_TOL * max(1.0, abs(a[key]))
    _assert_state_close(port, ref, FP32_TOL)
    port.close()


def test_device_rule():
    """The card is the default and is never swapped for the CPU: without
    CUDA, asking for it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FedSimulator(LIGHT_CONFIG, SimConfig(n_clients=K), **kw)


def test_own_init_is_seeded_and_trains():
    cfg = SimConfig(scheme="sfl_ga", cut=2, n_clients=K, batch=B,
                    uplink_codec="int8", downlink_codec="int8")
    a = FedSimulator(LIGHT_CONFIG, cfg, seed=3, device="cpu")
    b = FedSimulator(LIGHT_CONFIG, cfg, seed=3, device="cpu")
    x, y = next(_batches(1, seed=4))
    assert a.run_round(x, y) == b.run_round(x, y)
    assert a.state["client"][0]["w"].shape == (K, 5, 5, 1, 8)
    assert np.isfinite(a.run_round(x, y)["loss"])
