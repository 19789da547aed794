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
one element, which a few SGD steps spread at lr 0.05 to about 1e-4. So
1e-3, plus the check that 99 % of the parameters still agree at 1e-5.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_cnn import LIGHT_CONFIG as JCFG  # noqa: E402
from repro.core.simulator import FedSimulator as JSim  # noqa: E402
from repro.core.simulator import SimConfig as JSimConfig  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.sysmodel import traffic as jtraffic  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs.paper_cnn import LIGHT_CONFIG  # noqa: E402
from repro_torch.convert import cnn_params_from_jax  # noqa: E402
from repro_torch.core.simulator import FedSimulator, SimConfig  # noqa: E402
from repro_torch.obs.ledger import reconcile_events  # noqa: E402

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
        a, b = ref.run_round(x, y), port.run_round(x, y)
        assert (b["bits_up"], b["bits_down"]) == (a["bits_up"],
                                                  a["bits_down"])
        assert abs(b["loss"] - a["loss"]) <= tol * max(1.0, abs(a["loss"]))
        assert abs(b["client_drift"] - a["client_drift"]) <= tol * max(
            1.0, abs(a["client_drift"]))
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
    with pytest.raises(NotImplementedError, match=f"{what}.*slice 4"):
        FedSimulator(LIGHT_CONFIG, SimConfig(n_clients=K, **kw), device="cpu")


def test_checkpoint_and_async_raise_naming_slice_3(params0):
    _, port = _sims(params0)
    for call in (lambda: port.save("x.ckpt"), lambda: port.restore("x.ckpt"),
                 lambda: port.async_engine(None)):
        with pytest.raises(NotImplementedError, match="slice 4"):
            call()


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
