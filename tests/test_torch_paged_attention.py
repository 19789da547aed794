"""B6, the paged-decode attention, in the port against the reference.

The port's plain version (``repro_torch.kernels.paged_attention.
paged_attention_ref``, reached through ``repro_torch.kernels.ops``) is
held against the JAX oracle and against the Pallas kernel in interpret
mode, both through ``repro.kernels.ops.paged_attention`` (which pads the
GQA group to 8 rows; the port does not pad). The Hopper kernel itself
is held against the plain version on the card in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

# f32 on both sides, same op order page by page; the reference's G
# padding changes the matmul shapes, which may move the last bit of a
# reduction, so the two agree to a few f32 ulps of values of order one
ATOL = RTOL = 1e-6


def paged_inputs(seed, slots, hkv, g, d, page, lengths, maxp):
    """numpy inputs: random pools, a shuffled page table (a slot's pages
    are not contiguous in the pool) and q in the model layout."""
    rng = np.random.RandomState(seed)
    P = slots * maxp
    q = rng.randn(slots, hkv * g, d).astype(np.float32)
    pk = rng.randn(hkv, P, page, d).astype(np.float32)
    pv = rng.randn(hkv, P, page, d).astype(np.float32)
    table = rng.permutation(P).reshape(slots, maxp).astype(np.int32)
    return q, pk, pv, table, np.asarray(lengths, np.int32)


# ragged lengths with a dead slot (0), one token, a page boundary (8, 9)
# and several pages; page 8, up to 3 pages a slot
LENGTHS = [0, 1, 8, 9, 21]


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_plain_matches_reference(g, backend):
    arrs = paged_inputs(3, len(LENGTHS), 2, g, 64, 8, LENGTHS, 3)
    want = np.asarray(jops.paged_attention(*map(jnp.asarray, arrs),
                                           backend=backend))
    got = ops.paged_attention(*map(torch.from_numpy, arrs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_plain_matches_reference_granite_20b_group(backend):
    """granite-20b's head layout, 48 query heads over one kv head at
    head_dim 128: the reference's kernel takes a group of any size, and
    so must the port (the card's kernel cuts it into chunks of 16)."""
    arrs = paged_inputs(7, len(LENGTHS), 1, 48, 128, 8, LENGTHS, 3)
    want = np.asarray(jops.paged_attention(*map(jnp.asarray, arrs),
                                           backend=backend))
    got = ops.paged_attention(*map(torch.from_numpy, arrs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_plain_matches_reference_head_dim_128():
    lengths = [5, 0, 16, 17]
    arrs = paged_inputs(4, 4, 2, 4, 128, 16, lengths, 2)
    want = np.asarray(jops.paged_attention(*map(jnp.asarray, arrs),
                                           backend="jnp"))
    got = ops.paged_attention(*map(torch.from_numpy, arrs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_dead_slot_is_exact_zeros():
    arrs = paged_inputs(5, len(LENGTHS), 2, 4, 64, 8, LENGTHS, 3)
    out = ops.paged_attention(*map(torch.from_numpy, arrs))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out).all() and out[1:].abs().sum() > 0


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    q, pk, pv, table, lens = map(torch.from_numpy, paged_inputs(
        6, len(LENGTHS), 2, 4, 64, 8, LENGTHS, 3))
    qg = q.reshape(len(LENGTHS), 2, 4, 64)
    before = pa.paged_attention_decode.launches
    out = pa.paged_attention_decode(qg, pk, pv, table, lens)
    assert pa.paged_attention_decode.launches == before
    assert torch.equal(out, pa.paged_attention_ref(qg, pk, pv, table, lens))


def test_pages_past_the_length_are_never_read():
    """Poisoning every pool row past a slot's length (and every page the
    slot does not own) changes nothing: page skip and position mask."""
    arrs = paged_inputs(7, len(LENGTHS), 2, 4, 64, 8, LENGTHS, 3)
    q, pk, pv, table, lens = map(torch.from_numpy, arrs)
    clean = ops.paged_attention(q, pk, pv, table, lens)
    pk2, pv2 = torch.full_like(pk, float("nan")), torch.full_like(pv, 1e30)
    for b, n in enumerate(LENGTHS):
        for t in range(n):
            pid = int(table[b, t // 8])
            pk2[:, pid, t % 8] = pk[:, pid, t % 8]
            pv2[:, pid, t % 8] = pv[:, pid, t % 8]
    assert torch.equal(ops.paged_attention(q, pk2, pv2, table, lens), clean)
