"""B1, the eq. 5 aggregation, in the port against the reference.

The port's plain version (``repro_torch.kernels.grad_agg.grad_agg_ref``,
reached through ``repro_torch.kernels.ops.grad_agg`` for CPU tensors) is
held against the reference's jnp oracle and its Pallas kernel in
interpret mode, for (N, T, D) and the model layout (N, B, S, D). The
Hopper kernel is held against the plain version on the card in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import grad_agg as ga  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

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
