"""The port's cohort samplers and per-round latency model against the
reference's, bit for bit: every sampler's ``cohort(t)`` and ``peek(t)``,
``AdmissionSampler.admit``, ``channel_latency_fn`` and ``LatencyModel``
(pure numpy in both packages, so schedules must be equal, not close)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import cohort as jcohort  # noqa: E402
from repro.sysmodel import latency as jlatency  # noqa: E402
from repro.sysmodel.comm import CommParams as JCommParams  # noqa: E402
from repro.sysmodel.comp import CompParams as JCompParams  # noqa: E402
from repro_torch.core import cohort  # noqa: E402
from repro_torch.sysmodel import latency  # noqa: E402
from repro_torch.sysmodel.comm import CommParams, path_loss_gain  # noqa: E402
from repro_torch.sysmodel.comp import CompParams  # noqa: E402

N, K = 12, 4
SEEDS = (0, 3, 11)
ROUNDS = range(0, 40, 3)


def _rho(n, seed=0):
    r = np.random.RandomState(seed).rand(n) + 0.5
    return (r / r.sum()).astype(np.float32)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_constants_and_rng():
    assert cohort.SAMPLERS == jcohort.SAMPLERS
    assert cohort.COHORT_SEED_STRIDE == jcohort.COHORT_SEED_STRIDE
    for seed in SEEDS:
        for t in ROUNDS:
            np.testing.assert_array_equal(
                cohort.cohort_rng(seed, t).rand(5),
                jcohort.cohort_rng(seed, t).rand(5))


@pytest.mark.parametrize("kind", ["full", "uniform", "rho", "latency"])
def test_schedules_equal_reference(kind):
    for seed in SEEDS:
        k = N if kind == "full" else K
        rho = _rho(N, seed)
        got = cohort.make_sampler(kind, N, k, rho=rho, seed=seed)
        want = jcohort.make_sampler(kind, N, k, rho=rho, seed=seed)
        assert (got.identity, got.anchored) == (want.identity, want.anchored)
        for t in ROUNDS:
            _equal(got.cohort(t), want.cohort(t))
            _equal(got.peek(t + 1), want.cohort(t + 1))
        for a, b in zip(got.schedule(5, start=7), want.schedule(5, start=7)):
            _equal(a, b)


@pytest.mark.parametrize("kind,refill", [("uniform", 2), ("rho", 3),
                                         ("full", 5), ("latency", K)])
def test_admission_equals_reference(kind, refill):
    k = N if kind == "full" else K
    for seed in SEEDS:
        base = cohort.make_sampler(kind, N, k, rho=_rho(N), seed=seed)
        jbase = jcohort.make_sampler(kind, N, k, rho=_rho(N), seed=seed)
        got = cohort.AdmissionSampler(base, refill)
        want = jcohort.AdmissionSampler(jbase, refill)
        assert got.initial_size == want.initial_size
        for d in range(8):
            _equal(got.admit(d), want.admit(d))


def test_channel_latency_fn_and_model_equal_reference():
    for seed in SEEDS:
        got = cohort.channel_latency_fn(N, seed=seed, smashed_bits=3e5,
                                        batch=16)
        want = jcohort.channel_latency_fn(N, seed=seed, smashed_bits=3e5,
                                          batch=16)
        for t in ROUNDS:
            np.testing.assert_array_equal(got(t), want(t))
    comm, comp = CommParams(), CompParams()
    model = latency.LatencyModel(comm, comp, 2e5, 32.0)
    jmodel = jlatency.LatencyModel(JCommParams(), JCompParams(), 2e5, 32.0)
    rng = np.random.RandomState(4)
    gains = path_loss_gain(rng.uniform(0.05, 0.5, N), rng)
    bw = rng.dirichlet(np.ones(N)) * comm.total_bandwidth
    f_c = np.full(N, comp.client_cpu_max)
    args = (bw, comm.client_power, gains, f_c, comp.server_cpu_max)
    np.testing.assert_array_equal(model.chi_terms(*args),
                                  jmodel.chi_terms(*args))
    np.testing.assert_array_equal(model.psi_terms(gains, f_c),
                                  jmodel.psi_terms(gains, f_c))
    assert latency.round_latency(model, *args) == \
        jlatency.round_latency(jmodel, *args)


def test_sampler_guards():
    with pytest.raises(ValueError, match="full"):
        cohort.make_sampler("full", N, K)
    with pytest.raises(ValueError, match="unknown sampler"):
        cohort.make_sampler("nope", N, K)
    with pytest.raises(ValueError, match="cohort size"):
        cohort.make_sampler("uniform", N, N + 1)
    with pytest.raises(ValueError, match="refill"):
        cohort.AdmissionSampler(cohort.make_sampler("uniform", N, K), 0)
    bad = cohort.make_sampler("latency", N, K, latency_fn=lambda t: np.ones(3))
    with pytest.raises(ValueError, match="latency_fn"):
        bad.cohort(0)
