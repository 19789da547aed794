"""B1, the eq. 5 aggregation, in the port against the reference.

The port's plain version (``repro_torch.kernels.grad_agg.grad_agg_ref``,
reached through ``repro_torch.kernels.ops.grad_agg`` for CPU tensors) is
held against the reference's jnp oracle and its Pallas kernel in
interpret mode, for (N, T, D) and the model layout (N, B, S, D); the
kernel's shape-only launch plan (``grad_agg_plan``) is checked here too.
The Hopper kernel is held against the plain version on the card in
``test_torch_cuda.py``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import grad_agg as ga  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

# f32 on both sides; the oracle's einsum and the Pallas body may sum the
# N products in another order than the port's 0..N-1 loop, which moves
# the last bit of values of order one
TOL = 1e-6


def _inputs(seed, shape):
    rng = np.random.RandomState(seed)
    g = rng.randn(*shape).astype(np.float32)
    rho = rng.dirichlet(np.ones(shape[0])).astype(np.float32)
    return g, rho


@pytest.mark.parametrize("shape", [(1, 8, 128), (3, 16, 256), (10, 8, 512)])
def test_plain_matches_oracle_and_pallas(shape):
    g, rho = _inputs(sum(shape), shape)
    got = ops.grad_agg(torch.from_numpy(g), torch.from_numpy(rho)).numpy()
    oracle = np.asarray(ref.grad_agg_ref(jnp.asarray(g), jnp.asarray(rho)))
    pallas = np.asarray(jops.grad_agg(jnp.asarray(g), jnp.asarray(rho)))
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(2, 4, 8, 64), (5, 2, 16, 128)])
def test_model_layout_through_ops(shape):
    g, rho = _inputs(7, shape)
    got = ops.grad_agg(torch.from_numpy(g), torch.from_numpy(rho))
    assert tuple(got.shape) == shape[1:]
    for backend in ("jnp", "pallas"):
        want = np.asarray(jops.grad_agg(jnp.asarray(g), jnp.asarray(rho),
                                        backend=backend))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_any_shape_and_dtype():
    """The reference's tile divisibility was the TPU's tiling, not the
    function: the port takes any (N, ...) and keeps g's dtype."""
    g, rho = _inputs(3, (4, 7, 13))
    got = ga.grad_agg_reduce(torch.from_numpy(g), torch.from_numpy(rho))
    np.testing.assert_allclose(got.numpy(), np.einsum("ntd,n->td", g, rho),
                               rtol=TOL, atol=TOL)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    assert ga.grad_agg_ref(gb, torch.from_numpy(rho)).dtype == torch.bfloat16


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    g, rho = _inputs(4, (3, 8, 16))
    before = ga.grad_agg_reduce.launches
    out = ga.grad_agg_reduce(torch.from_numpy(g), torch.from_numpy(rho))
    assert ga.grad_agg_reduce.launches == before
    assert torch.equal(out, ga.grad_agg_ref(torch.from_numpy(g),
                                            torch.from_numpy(rho)))


# B1's launch plan (``grad_agg_plan``): shapes only, no card needed. The
# paper CNN's cut-layer payloads at batch 32 (10 clients) and an LM
# boundary (8 x 2048 x 4096), on a 132-SM H100.
SMS = 132
CUT1, CUT2, LM = (10, 200_704), (10, 100_352), (8, 2048 * 4096)


def _wave_units(n):
    """16-byte units a wave of the wave path holds at N = n."""
    return SMS * ga.wave_blocks_per_sm(n) * ga.WAVE_THREADS


@pytest.mark.parametrize("n,m", [CUT2, CUT1, (16, 100_352), (1, 4096),
                                 (8, 4 * 8 * SMS * 128)])
def test_plan_wave_takes_the_payloads_that_fit_one_wave(n, m):
    plan = ga.grad_agg_plan(n, m, SMS)
    assert plan == ga.wave_plan(m) == ("wave", -(-m // 4 // 128))
    assert plan.grid <= SMS * ga.wave_blocks_per_sm(n)
    if (n, m) in (CUT1, CUT2):  # the cut-layer payloads reach every SM
        assert plan.grid >= SMS


@pytest.mark.parametrize("n", [1, 2, 8, 10, 16])
def test_plan_streams_past_one_wave(n):
    """One wave's payload takes the wave path; one unit more streams."""
    units = _wave_units(n)
    assert ga.grad_agg_plan(n, 4 * units, SMS) == ga.wave_plan(4 * units)
    plan = ga.grad_agg_plan(n, 4 * (units + 1), SMS)
    assert plan == ga.stream_plan(n, 4 * (units + 1), SMS)
    assert plan.path == "stream" and plan.grid <= 2 * SMS


@pytest.mark.parametrize("n,path", [(1, "wave"), (2, "wave"), (16, "wave"),
                                    (17, "general")])
def test_plan_clients_past_sixteen_take_the_general_walk(n, path):
    assert ga.grad_agg_plan(n, CUT2[1], SMS).path == path


def test_plan_unaligned_or_ragged_rows_take_the_general_walk():
    assert ga.grad_agg_plan(*CUT2, SMS, aligned=False) == \
        ga.general_plan(CUT2[1], SMS, vec=False)
    assert ga.grad_agg_plan(10, CUT2[1] + 2, SMS) == \
        ga.general_plan(CUT2[1] + 2, SMS, vec=False)
    assert ga.grad_agg_plan(10, 7, SMS) == ga.general_plan(7, SMS, False)


def test_plan_lm_boundary_streams():
    # 8 clients: 2 units a thread a tile of 512 units, two blocks an SM
    assert ga.stream_units(LM[0]) == 2
    assert ga.grad_agg_plan(*LM, SMS) == ga.GradAggPlan("stream", 2 * SMS)


def test_plan_offsets_past_int32_take_the_general_walk():
    m = 2 ** 27  # 16 x 2^27 = 2^31 elements
    assert ga.grad_agg_plan(16, m - 4, SMS).path == "stream"
    assert ga.grad_agg_plan(16, m, SMS).path == "general"


@pytest.mark.parametrize("layouts", [[(10, 32, 3136), (10, 32, 56, 56),
                                      (10, 100_352)],
                                     [(3, 4096), (3, 64, 64)]])
def test_plan_depends_on_shapes_only(monkeypatch, layouts):
    """The wrapper's plan of a tensor (N, ...) is that of N, its element
    count and its alignment: the same for any layout of the trailing axes
    and any values."""
    monkeypatch.setattr(ga._build, "sm_count", lambda index: SMS)
    plans = set()
    for shape in layouts:
        for seed in (0, 1):
            g = torch.from_numpy(_inputs(seed, shape)[0])
            plans.add(ga.plan_for(g))
    n, m = layouts[0][0], int(np.prod(layouts[0][1:]))
    assert plans == {ga.grad_agg_plan(n, m, SMS)}


def test_plan_covers_every_unit_once():
    """Wave: the grid's threads own every 16-byte unit exactly once; the
    stream path never has more blocks than tiles; the general walk's grid
    is at least one block and at most 16 an SM."""
    rng = np.random.RandomState(0)
    for _ in range(400):
        n = int(rng.randint(1, 20))
        m = int(rng.choice([4, 1]) * rng.randint(1, 3_000_000))
        for sms in (1, 8, 132):
            plan = ga.grad_agg_plan(n, m, sms, aligned=bool(rng.rand() < .9))
            if plan.path == "wave":
                units = m // 4
                assert (plan.grid - 1) * ga.WAVE_THREADS < units \
                    <= plan.grid * ga.WAVE_THREADS
            elif plan.path == "stream":
                tile = ga.STREAM_THREADS * ga.stream_units(n)
                assert n * ga.stream_units(n) <= ga.STREAM_LOADS
                assert 1 <= plan.grid <= -(-(m // 4) // tile)
            else:
                assert 1 <= plan.grid <= 16 * sms


def test_plan_constants_match_the_cuda_source():
    src = (Path(ga.__file__).parent / "csrc" / "grad_agg.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert {k: int(v) for k, v in consts.items()} == {
        "kMaxClients": ga.MAX_CLIENTS, "kWaveThreads": ga.WAVE_THREADS,
        "kStreamThreads": ga.STREAM_THREADS,
        "kStreamLoads": ga.STREAM_LOADS, "kThreads": ga.THREADS}
