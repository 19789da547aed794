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
from _torch_threads import _one_torch_thread  # noqa: E402,F401

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
    so must the port (the card's kernel holds the whole group in one
    block)."""
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


# (slots, Hkv, G, maxp, page, SMs): the smoke's cases on an H100's 132
# SMs (serve run, granite-8b decode, granite-20b's group, granite-8b's
# long context), pairs that fill the card, tables narrower than a cluster
# or than a part's work, and other SM counts, groups and page sizes
PLAN_CASES = [
    (4, 8, 4, 2, 16, 132), (8, 8, 4, 9, 16, 132), (8, 1, 48, 9, 16, 132),
    (16, 8, 4, 257, 16, 132), (3, 2, 4, 70, 16, 132), (3, 2, 48, 70, 16, 132),
    (66, 2, 4, 6, 16, 132), (1, 1, 1, 1, 16, 132), (1, 1, 4, 0, 16, 132),
    (1, 1, 8, 5, 8, 132), (2, 1, 4, 1000, 16, 132), (1, 1, 16, 7, 64, 114),
    (5, 3, 20, 40, 32, 78), (1, 1, 100, 3, 1, 132), (200, 8, 4, 300, 16, 132),
]


@pytest.mark.parametrize("slots,hkv,g,maxp,page,sms", PLAN_CASES)
def test_split_plan_stays_in_its_contract(slots, hkv, g, maxp, page, sms):
    """The cluster size is 1 to 8; the pairs alone keep one block each
    once they fill the SMs; a full table row gives every rank a page (the
    kernel splits a slot's live pages contiguously in rank order, so a
    part is empty only where the pages are fewer than the cluster); and a
    split leaves every part at least ``PART_WORK`` positions x rows."""
    cluster = pa.split_plan(slots, hkv, g, maxp, page, sms)
    assert 1 <= cluster <= pa.MAX_CLUSTER
    if slots * hkv >= sms:
        assert cluster == 1
    assert cluster <= max(1, maxp)
    assert cluster == 1 or \
        (maxp // cluster) * page * max(g, 4) >= pa.PART_WORK


def test_split_plan_splits_where_pairs_leave_sms_idle():
    """The serve run's 32 pairs over 2-page tables and granite-8b's 64
    pairs over 9-page tables stay one block a pair (a part would hold too
    little work); granite-20b's 8 pairs of 48 rows and granite-8b's long
    context at 16 slots split."""
    assert pa.split_plan(4, 8, 4, 2, 16, 132) == 1
    assert pa.split_plan(8, 8, 4, 9, 16, 132) == 1
    assert pa.split_plan(8, 1, 48, 9, 16, 132) == 8
    assert pa.split_plan(16, 8, 4, 257, 16, 132) == 2
    # granite-8b's serve layout, 4 slots x 8 kv heads, from 40 pages (640
    # tokens) a table row: ceil(132 / 32) = 5 blocks a pair
    assert pa.split_plan(4, 8, 4, 39, 16, 132) == 4
    assert pa.split_plan(4, 8, 4, 40, 16, 132) == 5
