"""Tests that need an NVIDIA card: the port's hand-written Hopper kernels
held against their plain PyTorch versions on the card.

They carry the ``cuda`` marker and skip where there is no CUDA device.
This file imports torch and numpy only, so it runs on a machine without
JAX:  python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as pa  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version is f32
    return torch.device("cuda")


def paged_inputs(seed, slots, hkv, g, d, page, lengths, maxp):
    """Random pools and a shuffled page table: a slot's pages are not
    contiguous in the pool, which is the point of the indirection."""
    rng = np.random.RandomState(seed)
    P = slots * maxp
    q = rng.randn(slots, hkv, g, d).astype(np.float32)
    pk = rng.randn(hkv, P, page, d).astype(np.float32)
    pv = rng.randn(hkv, P, page, d).astype(np.float32)
    table = rng.permutation(P).reshape(slots, maxp).astype(np.int32)
    return q, pk, pv, table, np.asarray(lengths, np.int32)


# (head_dim, G, page, lengths): ragged, including a dead slot (0), one
# token, a page boundary (page, page + 1) and several pages
CASES = [
    (128, 4, 16, [0, 1, 16, 17, 40, 100, 127, 64]),
    (64, 4, 16, [0, 1, 16, 17, 40, 100, 127, 64]),
    (128, 1, 8, [3, 0, 8, 9]),
    (64, 16, 32, [33, 0, 1, 96]),
    (128, 8, 64, [64, 65, 0, 200]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d,g,page,lengths", CASES)
def test_paged_kernel_matches_plain(cuda, d, g, page, lengths):
    maxp = -(-max(lengths) // page) + 1
    arrs = paged_inputs(0, len(lengths), 2, g, d, page, lengths, maxp)
    q, pk, pv, table, lens = (torch.from_numpy(a).to(cuda) for a in arrs)
    before = pa.paged_attention_decode.launches
    out = pa.paged_attention_decode(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    assert pa.paged_attention_decode.launches == before + 1
    ref = pa.paged_attention_ref(q, pk, pv, table, lens)
    # f32 on both sides; the kernel sums the D products and the page
    # positions in another order than the plain version's matmuls, so
    # the two differ by a few f32 ulps of values of order one
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    dead = lens == 0
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))


@pytest.mark.cuda
def test_paged_kernel_rejects_what_it_cannot_take(cuda):
    arrs = paged_inputs(1, 2, 2, 4, 96, 8, [3, 5], 2)
    q, pk, pv, table, lens = (torch.from_numpy(a).to(cuda) for a in arrs)
    with pytest.raises(NotImplementedError, match="head_dim"):
        pa.paged_attention_decode(q, pk, pv, table, lens)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention_decode(q[..., :64].contiguous(),
                                  pk[..., :64].contiguous(),
                                  pv[..., :64].contiguous(),
                                  table.long(), lens)


@pytest.mark.cuda
def test_paged_kernel_never_reads_past_a_slots_length(cuda):
    """NaN in every pool row past a slot's length, and in every page it
    does not own, leaves the kernel's output bit for bit unchanged."""
    lengths = [0, 1, 16, 17, 40]
    arrs = paged_inputs(2, len(lengths), 2, 4, 128, 16, lengths, 3)
    q, pk, pv, table, lens = (torch.from_numpy(a).to(cuda) for a in arrs)
    clean = pa.paged_attention_decode(q, pk, pv, table, lens)
    pk2, pv2 = torch.full_like(pk, float("nan")), torch.full_like(pv, 1e30)
    for b, n in enumerate(lengths):
        for t in range(n):
            pid = int(table[b, t // 16])
            pk2[:, pid, t % 16] = pk[:, pid, t % 16]
            pv2[:, pid, t % 16] = pv[:, pid, t % 16]
    poisoned = pa.paged_attention_decode(q, pk2, pv2, table, lens)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, clean)
