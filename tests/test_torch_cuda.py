"""Tests that need an NVIDIA card: the port's hand-written Hopper kernels
held against their plain PyTorch versions on the card.

They carry the ``cuda`` marker and skip where there is no CUDA device.
This file imports torch and numpy only, so it runs on a machine without
JAX:  python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compress import get_codec, uplink_channel  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gemm as gm  # noqa: E402
from repro_torch.kernels import grad_agg as ga  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from _torch_dist import _no_process_group_left  # noqa: E402,F401


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


# (Hkv, G): granite-20b's 48 query heads over one kv head, groups of 20
# and 32 over two kv heads (20 is not a multiple of a warp's rows; the
# second kv head's rows sit past the first's), 64, and 100, which the
# kernel takes in two passes of rows; with the group sizes above they
# reach every row layout the kernel picks from G
@pytest.mark.cuda
@pytest.mark.parametrize("hkv,g", [(1, 48), (2, 20), (2, 32), (1, 64),
                                   (1, 100)])
def test_paged_kernel_takes_any_group(cuda, hkv, g):
    lengths = [0, 1, 8, 9, 21, 40]
    arrs = paged_inputs(3, len(lengths), hkv, g, 128, 8, lengths, 6)
    q, pk, pv, table, lens = (torch.from_numpy(a).to(cuda) for a in arrs)
    before = pa.paged_attention_decode.launches
    out = pa.paged_attention_decode(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    assert pa.paged_attention_decode.launches == before + 1
    ref = pa.paged_attention_ref(q, pk, pv, table, lens)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    dead = lens == 0
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))


# (Hkv, G) of the decoder zoo's serving models at head_dim 128:
# qwen3-moe-30b-a3b (32 over 4 kv heads), qwen2-vl-2b (12 over 2) and
# jamba-v0.1-52b's attention layer (32 over 8)
@pytest.mark.cuda
@pytest.mark.parametrize("hkv,g", [(4, 8), (2, 6), (8, 4)])
def test_paged_kernel_at_the_zoo_groups(cuda, hkv, g):
    lengths = [0, 1, 16, 17, 31, 32]
    arrs = paged_inputs(4, len(lengths), hkv, g, 128, 16, lengths, 3)
    q, pk, pv, table, lens = (torch.from_numpy(a).to(cuda) for a in arrs)
    before = pa.paged_attention_decode.launches
    out = pa.paged_attention_decode(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    assert pa.paged_attention_decode.launches == before + 1
    ref = pa.paged_attention_ref(q, pk, pv, table, lens)
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


# (lengths, maxp, split): one block a slot at 3 pages, and a split over a
# cluster (70 pages a row) where the short slots leave ranks without pages
@pytest.mark.cuda
@pytest.mark.parametrize("lengths,maxp,split", [
    ([0, 1, 16, 17, 40], 3, False),
    ([1100, 0, 5, 1023, 64], 70, True),
])
def test_paged_kernel_never_reads_past_a_slots_length(cuda, lengths, maxp,
                                                      split):
    """NaN in every pool row past a slot's length, and in every page it
    does not own, leaves the kernel's output bit for bit unchanged."""
    arrs = paged_inputs(2, len(lengths), 2, 4, 128, 16, lengths, maxp)
    q, pk, pv, table, lens = (torch.from_numpy(a).to(cuda) for a in arrs)
    assert (pa.split_plan(len(lengths), 2, 4, maxp, 16, _sms()) > 1) == split
    clean = pa.paged_attention_decode(q, pk, pv, table, lens)
    pk2, pv2 = torch.full_like(pk, float("nan")), torch.full_like(pv, 1e30)
    for b, n in enumerate(lengths):
        for j in range(-(-n // 16)):
            pid, rows = int(arrs[3][b, j]), min(16, n - 16 * j)
            pk2[:, pid, :rows] = pk[:, pid, :rows]
            pv2[:, pid, :rows] = pv[:, pid, :rows]
    before = pa.paged_attention_decode.launches
    poisoned = pa.paged_attention_decode(q, pk2, pv2, table, lens)
    torch.cuda.synchronize()
    assert pa.paged_attention_decode.launches == before + 1
    assert torch.equal(poisoned, clean)


@pytest.mark.cuda
def test_paged_kernel_reads_a_table_row_too_wide_for_shared_memory(cuda):
    """A 60,000-page table row (page size 1) does not fit in shared memory
    beside the ring: the kernel reads its ids where they lie, and gives
    what the plain version gives on the row's live pages."""
    lengths = [1000, 0, 77]
    q, pk, pv, table, lens = _paged_on_card(cuda, 7, 1, 4, 64, 1, lengths,
                                            60000)
    before = pa.paged_attention_decode.launches
    out = pa.paged_attention_decode(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    assert pa.paged_attention_decode.launches == before + 1
    narrow = table[:, :1001].contiguous()  # pages past 1,000 are not read
    ref = pa.paged_attention_ref(q, pk, pv, narrow, lens)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(out[1], torch.zeros_like(out[1]))


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _paged_on_card(cuda, seed, hkv, g, d, page, lengths, maxp):
    arrs = paged_inputs(seed, len(lengths), hkv, g, d, page, lengths, maxp)
    return tuple(torch.from_numpy(a).to(cuda) for a in arrs)


# a long context split over a cluster: 3 slots up to 1,100 tokens (70
# pages a table row) over 2 kv heads; the 5-token slot has one live page,
# so all ranks but the first have none, and the dead slot has none at all
@pytest.mark.cuda
@pytest.mark.parametrize("g", [4, 48])
def test_paged_kernel_long_context_split_over_a_cluster(cuda, g):
    lengths = [1100, 5, 0]
    q, pk, pv, table, lens = _paged_on_card(cuda, 4, 2, g, 128, 16, lengths,
                                            70)
    assert pa.split_plan(3, 2, g, 70, 16, _sms()) > 1
    before = pa.paged_attention_decode.launches
    out = pa.paged_attention_decode(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    assert pa.paged_attention_decode.launches == before + 1
    ref = pa.paged_attention_ref(q, pk, pv, table, lens)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(out[2], torch.zeros_like(out[2]))


# (slots, Hkv, G, maxp, cluster the plan picks on an H100's 132 SMs):
# the cluster sizes that are not powers of two; 5 is granite-8b's serve
# layout (4 slots x 8 kv heads) once a table row holds 40 pages
@pytest.mark.cuda
@pytest.mark.parametrize("slots,hkv,g,maxp,cluster", [
    (11, 4, 4, 30, 3), (4, 8, 4, 48, 5), (3, 8, 4, 50, 6), (19, 1, 8, 40, 7),
])
def test_paged_kernel_splits_over_any_cluster_size(cuda, slots, hkv, g, maxp,
                                                   cluster):
    """Ragged lengths (a full row, a dead slot, a single token) split
    over clusters of 3, 5, 6 and 7 blocks give what the plain version
    gives."""
    if _sms() != 132:
        pytest.skip(f"cases sized for 132 SMs, the card has {_sms()}")
    lengths = [maxp * 16, 0, 1] + [(211 * i) % (maxp * 16 + 1)
                                   for i in range(3, slots)]
    q, pk, pv, table, lens = _paged_on_card(cuda, 8, hkv, g, 128, 16,
                                            lengths[:slots], maxp)
    assert pa.split_plan(slots, hkv, g, maxp, 16, _sms()) == cluster
    before = pa.paged_attention_decode.launches
    out = pa.paged_attention_decode(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    assert pa.paged_attention_decode.launches == before + 1
    ref = pa.paged_attention_ref(q, pk, pv, table, lens)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(out[1], torch.zeros_like(out[1]))


@pytest.mark.cuda
def test_paged_kernel_is_deterministic(cuda):
    """The cluster combines its partials in rank order, with no atomics:
    two launches on the same inputs give the same bits."""
    lengths = [1100, 5, 0, 333]
    q, pk, pv, table, lens = _paged_on_card(cuda, 5, 2, 4, 128, 16, lengths,
                                            70)
    assert pa.split_plan(4, 2, 4, 70, 16, _sms()) > 1
    first = pa.paged_attention_decode(q, pk, pv, table, lens)
    before = pa.paged_attention_decode.launches
    second = pa.paged_attention_decode(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    assert pa.paged_attention_decode.launches == before + 1
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_paged_kernel_without_a_split_when_pairs_fill_the_card(cuda):
    """Enough (slot, kv head) pairs to give every SM a block: the plan
    takes one block a pair, the other path of the plan."""
    slots = -(-_sms() // 2)
    lengths = [(7 * i) % 90 for i in range(slots)]
    q, pk, pv, table, lens = _paged_on_card(cuda, 6, 2, 4, 64, 16, lengths,
                                            6)
    assert pa.split_plan(slots, 2, 4, 6, 16, _sms()) == 1
    before = pa.paged_attention_decode.launches
    out = pa.paged_attention_decode(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    assert pa.paged_attention_decode.launches == before + 1
    ref = pa.paged_attention_ref(q, pk, pv, table, lens)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    dead = lens == 0
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))


def _randn(seed, shape, scale=1.0):
    return torch.from_numpy(
        (np.random.RandomState(seed).randn(*shape) * scale).astype(
            np.float32))


# (N, M, the path of B1's plan on a 132-SM card): a small wave, M not a
# multiple of 4 (the scalar walk), one client, the paper CNN's cut-2 and
# cut-1 payloads, the launch floor, the async engine's refills of 4 and
# cohorts of 16 at cut 2 (wave), 17 clients (the float4 walk), the stream path with a ragged last tile at K 2 (N 8), K 1
# (N 10, 16) and K 4 (N 1), and the LM boundary (8 x 2048 x 4096)
GRAD_AGG_CASES = [(3, 4096, "wave"), (5, 1001, "general"), (1, 7, "general"),
                  (10, 100352, "wave"), (10, 200704, "wave"),
                  (1, 4096, "wave"), (8, 600000, "stream"),
                  (8, 760000, "stream"), (4, 100352, "wave"),
                  (16, 100352, "wave"),
                  (16, 360000, "stream"), (17, 100352, "general"),
                  (10, 4 * 270413, "stream"), (1, 4 * 716805, "stream"),
                  (8, 2048 * 4096, "stream")]


def _agg_inputs(cuda, n, m):
    g = _randn(n * 7 + m % 1000, (n, m), 3.0).to(cuda)
    rho = torch.from_numpy(np.random.RandomState(1).dirichlet(
        np.ones(n)).astype(np.float32)).to(cuda)
    return g, rho


def _one_launch(fn, *args):
    before = ga.grad_agg_reduce.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert ga.grad_agg_reduce.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,path", GRAD_AGG_CASES)
def test_grad_agg_kernel_matches_plain(cuda, n, m, path):
    g, rho = _agg_inputs(cuda, n, m)
    assert ga.plan_for(g).path == path
    out = _one_launch(ga.grad_agg_reduce, g, rho)
    # same op order and IEEE multiply/add on both sides: bit for bit, and
    # within the stated 1e-6 relative in any case
    ref = ga.grad_agg_ref(g, rho)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=0)
    assert torch.equal(out, ref)
    # a view at an odd offset takes the scalar walk
    gv = g.reshape(-1)[1:1 + n * (m - 1)].reshape(n, m - 1)
    assert ga.plan_for(gv) == ga.general_plan(m - 1, ga._build.sm_count(
        cuda.index or 0), vec=False)
    assert torch.equal(_one_launch(ga.grad_agg_reduce, gv, rho),
                       ga.grad_agg_ref(gv, rho))


# (N, M): every path the source holds at N 1, 2, 10 and 16, each with a
# ragged last block or tile
GRAD_AGG_FORMS = [(1, 4 * 5003), (2, 4 * 40961), (10, 4 * 9001),
                  (16, 4 * 30011)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", GRAD_AGG_FORMS)
def test_grad_agg_every_path_and_form_bitwise(cuda, n, m):
    """The wave, the stream path at the card's SM count and at 3 SMs (many
    tiles a block), and the two general walks: one launch each, bit for
    bit against the plain version."""
    g, rho = _agg_inputs(cuda, n, m)
    ref = ga.grad_agg_ref(g, rho)
    sms = ga._build.sm_count(cuda.index or 0)
    plans = [ga.wave_plan(m)]
    plans += [ga.stream_plan(n, m, s) for s in (sms, 3)]
    plans += [ga.general_plan(m, sms, vec) for vec in (True, False)]
    for plan in plans:
        out = _one_launch(ga._launch, g, rho, plan)
        assert torch.equal(out, ref), plan


@pytest.mark.cuda
def test_grad_agg_kernel_refuses_a_plan_it_does_not_hold(cuda):
    """N past 16 on the wave or stream path, a grid of no block, and a
    wave grid one block short of M / 4 units: each raises, launching
    nothing."""
    g, rho = _agg_inputs(cuda, 17, 4096)
    short = ga.GradAggPlan("wave", ga.wave_plan(4096).grid - 1)
    for clients, plan in ((17, ga.wave_plan(4096)),
                          (17, ga.GradAggPlan("stream", 8)),
                          (16, short),
                          (16, ga.GradAggPlan("wave", 0)),
                          (16, ga.GradAggPlan("stream", 0)),
                          (16, ga.GradAggPlan("general", 0))):
        before = ga.grad_agg_reduce.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            ga._launch(g[:clients], rho[:clients], plan)
        assert ga.grad_agg_reduce.launches == before


# (N, T, D, block_t, block_d, B2's path, B3's path): the codec's flat
# view, several tiles of a 2-d tiling, the per-client channel view (and
# at the async engine's generation sizes, 4 and 16 clients); then
# every path of quantize_plan / dequant_plan: a small tile not 256 wide,
# bd = 6 (not a multiple of 4), the reference kernel's 256 x 256 and a
# 512 x 128 tile (clusters of 8), a tile above 65,536 elements, and D =
# 16 k + 8 (B3 on 8-wide tiles)
QUANT_CASES = [(1, 1, 4096, 1, 256, "warp", "vector"),
               (3, 16, 512, 8, 128, "warp", "vector"),
               (2, 64, 256, 64, 256, "cluster", "vector"),
               (10, 1, 100352, 1, 256, "warp", "vector"),
               (4, 1, 100352, 1, 256, "warp", "vector"),
               (16, 1, 100352, 1, 256, "warp", "vector"),
               (2, 6, 96, 3, 32, "warp", "vector"),
               (2, 4, 36, 2, 6, "general", "general"),
               (2, 512, 512, 256, 256, "cluster", "vector"),
               (1, 1024, 256, 512, 128, "cluster", "vector"),
               (1, 512, 256, 512, 256, "general", "vector"),
               (2, 4, 40, 2, 8, "warp", "general")]


def _quantize_and_aggregate(cuda, g, bits, bt, bd, stochastic):
    """B2 with one seed and with per-client seeds, then B3, each held bit
    for bit to its plain version and counting exactly one launch."""
    n = g.shape[0]
    seed = 0xDEADBEEF  # >= 2^31
    before = qz.quantize_pack.launches
    q, s = qz.quantize_pack(g, seed, bits, bt, bd, stochastic)
    torch.cuda.synchronize()
    assert qz.quantize_pack.launches == before + 1
    qr, sr = qz.quantize_ref(g, seed, bits, bt, bd, stochastic)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert s[0, 0, 0] == 1.0
    # per-client seeds, client index not hashed
    seeds = (torch.arange(n, device=cuda) * 0x9E3779B1 + seed) & 0xFFFFFFFF
    q, s = qz.quantize_pack(g, 0, bits, bt, bd, stochastic, seeds)
    torch.cuda.synchronize()
    assert qz.quantize_pack.launches == before + 2
    qr, sr = qz.quantize_ref(g, 0, bits, bt, bd, stochastic, seeds)
    assert torch.equal(q, qr) and torch.equal(s, sr)

    rho = torch.from_numpy(np.random.RandomState(2).rand(n).astype(
        np.float32)).to(cuda)
    before = qz.dequant_agg_reduce.launches
    out = qz.dequant_agg_reduce(q, s, rho, bits, bt, bd)
    torch.cuda.synchronize()
    assert qz.dequant_agg_reduce.launches == before + 1
    ref = qz.dequant_agg_ref(q, s, rho, bits, bt, bd)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(out, ref)  # same op order, one rounding per op
    return q, s


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("n,t,d,bt,bd,b2,b3", QUANT_CASES)
def test_quantize_kernel_bitwise(cuda, bits, stochastic, n, t, d, bt, bd,
                                 b2, b3):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert qz.quantize_plan(n, t, d, bt, bd, bits, sms).path == b2
    assert qz.dequant_plan(n, t, d, bt, bd, bits).path == b3
    g = _randn(d + n, (n, t, d), 2.0)
    g[0, :bt, :bd] = 0.0  # an all-zero tile: scale 1, codes 0
    _quantize_and_aggregate(cuda, g.to(cuda), bits, bt, bd, stochastic)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n,t,d,bt,bd", [(2, 4, 256, 1, 256),
                                         (2, 8, 512, 4, 128)])
def test_quantize_kernel_takes_unaligned_views(cuda, bits, n, t, d, bt, bd):
    """Contiguous views at an odd element offset take the general paths
    of B2 (g) and B3 (q), bit for bit."""
    buf = _randn(5, (n * t * d + 1,), 2.0).to(cuda)
    g = buf[1:].view(n, t, d)
    g[0, :bt, :bd] = 0.0
    assert g.data_ptr() % 16 and g.is_contiguous()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert qz.quantize_plan(n, t, d, bt, bd, bits, sms,
                            aligned=False).path == "general"
    q, s = _quantize_and_aggregate(cuda, g, bits, bt, bd, True)
    qbuf = torch.empty(q.numel() + 1, dtype=torch.int8, device=cuda)
    qv = qbuf[1:].view(q.shape)
    qv.copy_(q)
    assert qv.data_ptr() % 16 and qz.dequant_plan(
        n, t, d, bt, bd, bits, aligned=False).path == "general"
    rho = torch.rand(n, device=cuda)
    before = qz.dequant_agg_reduce.launches
    out = qz.dequant_agg_reduce(qv, s, rho, bits, bt, bd)
    torch.cuda.synchronize()
    assert qz.dequant_agg_reduce.launches == before + 1
    assert torch.equal(out, qz.dequant_agg_ref(q, s, rho, bits, bt, bd))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["int8", "int4"])
def test_codec_on_card_matches_cpu(cuda, name):
    """The routed codec launches the kernels on the card and gives the
    CPU's plain-version bits; the batched per-client channel equals K
    single encodes."""
    x = _randn(7, (4, 3, 1000), 5.0)
    codec = get_codec(name)
    before = (qz.quantize_pack.launches, qz.dequant_agg_reduce.launches)
    pc, pg = codec.encode(x, 77), codec.encode(x.to(cuda), 77)
    assert torch.equal(pg.data.cpu(), pc.data)
    assert torch.equal(pg.scale.cpu(), pc.scale)
    assert torch.equal(codec.decode(pg).cpu(), codec.decode(pc))
    up = uplink_channel(codec, x.to(cuda), 2 ** 32 - 3)
    assert (qz.quantize_pack.launches, qz.dequant_agg_reduce.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(up.cpu(), uplink_channel(codec, x, 2 ** 32 - 3))
    one_by_one = torch.stack([codec.roundtrip(
        x[k].to(cuda), (2 ** 32 - 3 + k * 0x9E3779B1) & 0xFFFFFFFF)
        for k in range(4)])
    assert torch.equal(up, one_by_one)


@pytest.mark.cuda
def test_codec_kernels_reject_what_they_cannot_take(cuda):
    g = torch.zeros(2, 3, 300, device=cuda)
    with pytest.raises(ValueError, match="tiles"):
        qz.quantize_pack(g, 0, 8, 1, 256)
    with pytest.raises(TypeError, match="float32"):
        ga.grad_agg_reduce(g.double(), torch.ones(2, device=cuda))


def ssd_inputs(seed, b, h, g, c, Q, P, N, decay=0.5):
    """xdt, a negative log-decay dA (as dt * A is) and per-group B, C."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return (rng.randn(b, h, c, Q, P).astype(f32),
            (-decay * rng.rand(b, h, c, Q)).astype(f32),
            rng.randn(b, g, c, Q, N).astype(f32),
            rng.randn(b, g, c, Q, N).astype(f32))


# (b, h, g, c, Q, P, N): mamba2-130m's serve head (24 heads, one group,
# chunk 128, head_dim 64, state 128, one y block a head), the reduced
# config with 2 groups, and a chunk that is not a multiple of the
# kernel's 16-row strips;
# Jamba's state size 16; Q 96, six strips over two y blocks of four
# warps, one warp of each idle; mamba2-130m's LM forward (4 x 24 x 8
# chunks: 768 y blocks of two heads and 768 state blocks, many times the
# SMs); head_dim 128 (two state
# blocks a chunk) with 2 groups; N and P not multiples of 4 (rows copied
# 4 bytes at a time); the largest chunk, 256; enough chunks that a y block
# takes two heads of a group (two groups of four heads), and as many with
# an odd count of heads a group (one head a y block)
SSD_CASES = [(1, 24, 1, 2, 128, 64, 128), (2, 4, 2, 3, 32, 64, 32),
             (1, 2, 1, 2, 36, 20, 12), (2, 8, 1, 2, 128, 64, 16),
             (1, 4, 1, 3, 96, 64, 64), (4, 24, 1, 8, 128, 64, 128),
             (1, 4, 2, 2, 64, 128, 128), (1, 2, 1, 2, 40, 18, 10),
             (1, 2, 1, 1, 256, 32, 32), (4, 8, 2, 10, 128, 32, 32),
             (2, 12, 4, 12, 128, 64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,g,c,Q,P,N", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, b, h, g, c, Q, P, N):
    xdt, dA, B, C = (torch.from_numpy(a).to(cuda)
                     for a in ssd_inputs(0, b, h, g, c, Q, P, N))
    before = ss.ssd_intra_chunk.launches
    y, st = ss.ssd_intra_chunk(xdt, dA, B, C)
    torch.cuda.synchronize()
    assert ss.ssd_intra_chunk.launches == before + 1
    yr, str_ = ss.ssd_intra_chunk_ref(xdt, dA, B, C)
    # f32 on both sides; sums of up to max(Q, N) products in other orders
    # differ by a few ulps of the largest output: 1e-5 of it is the bound
    for out, ref in ((y, yr), (st, str_)):
        scale = float(ref.abs().max())
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.cuda
def test_ssd_kernel_never_evaluates_above_the_diagonal(cuda):
    """A steep decay makes exp(cs_i - cs_j) overflow above the diagonal;
    the kernel must not compute it there (inf * 0 would be NaN)."""
    xdt, dA, B, C = (torch.from_numpy(a).to(cuda)
                     for a in ssd_inputs(1, 1, 2, 1, 2, 128, 64, 128,
                                         decay=30.0))
    y, st = ss.ssd_intra_chunk(xdt, dA, B, C)
    yr, str_ = ss.ssd_intra_chunk_ref(xdt, dA, B, C)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    # the decays are differences of cumsums of order 30 * 128 = 3840,
    # which float32 holds to about 2e-4, and the two cumsums add in other
    # orders: the exponentials agree to about 1e-4 relative, so 1e-3 of
    # the largest output is the bound here
    torch.testing.assert_close(y, yr, rtol=0,
                               atol=1e-3 * float(yr.abs().max()))


@pytest.mark.cuda
def test_ssd_kernel_rejects_what_it_cannot_take(cuda):
    xdt, dA, B, C = (torch.from_numpy(a).to(cuda)
                     for a in ssd_inputs(2, 1, 2, 1, 1, 32, 16, 8))
    with pytest.raises(NotImplementedError, match="forward only"):
        ss.ssd_intra_chunk(xdt.requires_grad_(), dA, B, C)
    with torch.no_grad():
        ss.ssd_intra_chunk(xdt, dA, B, C)  # no grad needed: it launches
    with pytest.raises(TypeError, match="float32"):
        ss.ssd_intra_chunk(xdt.detach().double(), dA, B, C)
    # past the kernel's limits (chunk 256, head_dim 128, state 128): raised
    # before launch, naming them
    for shape in ((128, 64, 256), (512, 64, 64), (128, 256, 64)):
        big = ssd_inputs(3, 1, 1, 1, 1, *shape)
        with pytest.raises(NotImplementedError, match="state size of 1..128"):
            ss.ssd_intra_chunk(*(torch.from_numpy(a).to(cuda) for a in big))


# (B, Hq, Hkv, S, D, window, q scale): GQA 4:1 at head_dim 128, a ragged
# length, a sliding window, a head_dim outside {64, 128}, no GQA;
# granite-8b's head layout at reduced length; S not a multiple of 8 with
# a head_dim that is not one either (the MMA's k-dimension pads 36 to 40
# with zeros); peaked scores, q x 2 (a CPU emulation gives 2.2e-3 for one
# TF32 product, 5.0e-6 for the kernel's 3xTF32 split); a head_dim that is
# not a multiple of 4, whose rows the kernel copies 4 bytes at a time
FLASH_CASES = [(1, 8, 2, 512, 128, None, 1.0), (2, 4, 4, 100, 64, None, 1.0),
               (1, 4, 2, 256, 64, 48, 1.0), (1, 2, 1, 130, 96, 33, 1.0),
               (1, 2, 2, 64, 32, None, 1.0),
               (1, 32, 8, 1024, 128, None, 1.0),
               (1, 4, 2, 77, 36, None, 1.0),
               (1, 8, 2, 256, 128, None, 2.0),
               (1, 4, 2, 45, 30, 20, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,hq,hkv,S,D,window,qscale", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, B, hq, hkv, S, D, window, qscale):
    rng = np.random.RandomState(S + D)
    q, k, v = (torch.from_numpy(rng.randn(B, h, S, D).astype(
        np.float32)).to(cuda) for h in (hq, hkv, hkv))
    q = q * qscale
    before = fa.flash_attention_bhsd.launches
    out = fa.flash_attention_bhsd(q, k, v, window)
    torch.cuda.synchronize()
    assert fa.flash_attention_bhsd.launches == before + 1
    ref = fa.flash_attention_ref(q, k, v, window)
    # outputs are softmax averages of unit-normal values; the two sum the
    # head_dim and key products in other orders: the reference's own
    # kernel-vs-oracle bound, 2e-5
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_flash_kernel_windowed_at_starcoder2_heads(cuda):
    """starcoder2-3b's head layout (24 query heads over 2 kv heads,
    head_dim 128) with its window of 4,096 over 4,608 positions: the
    masked tiles at both edges of the band, and whole tiles outside it
    skipped."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, h, 4608, 128).astype(
        np.float32)).to(cuda) for h in (24, 2, 2))
    before = fa.flash_attention_bhsd.launches
    out = fa.flash_attention_bhsd(q, k, v, 4096)
    torch.cuda.synchronize()
    assert fa.flash_attention_bhsd.launches == before + 1
    ref = fa.flash_attention_ref(q, k, v, 4096)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D", [(128, 128), (77, 96)])
def test_flash_kernel_pairs_each_weight_with_its_key(cuda, S, D):
    """V's rows are one-hot in the key's index (mod D), so the output
    holds each key's softmax weight in that key's column: the kernel's
    reuse of the score fragment as the A operand of P V (keys 2t, 2t + 1
    of each 8-key group as k-indices t, t + 4) must read V's rows in the
    same order, or a weight lands in a wrong column (an error of order
    one, for rows that see few keys)."""
    rng = np.random.RandomState(7)
    q, k = (torch.from_numpy(2 * rng.randn(1, h, S, D).astype(
        np.float32)).to(cuda) for h in (4, 2))
    v = torch.zeros(1, 2, S, D, device=cuda)
    keys = torch.arange(S, device=cuda)
    v[:, :, keys, keys % D] = 1.0
    out = fa.flash_attention_bhsd(q, k, v)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q, k, v)
    assert float(ref[0, :, 1].max()) > 0.5  # weights of order one
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 2, 64, 160, device=cuda)
    with pytest.raises(NotImplementedError, match="head_dim"):
        fa.flash_attention_bhsd(q, q, q)
    q = torch.zeros(1, 2, 64, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward only"):
        fa.flash_attention_bhsd(q, q, q)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention_bhsd(q.detach().half(), q.detach().half(),
                                q.detach().half())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,seq", [("granite-8b", 100),
                                      ("mamba2-130m", 70)])
def test_lm_forward_flash_launches_its_kernel_per_layer(cuda, arch, seq):
    """The split LM forward with impl="flash" at reduced size: one B4
    (attention) or B5 (SSM) launch per layer, logits within 1e-4 of the
    impl="jnp" path on the card, and a refusal under autograd (the
    kernels are forward only)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm

    plan = lm.build_plan(reduced_config(get_config(arch)), 1)
    params = lm.init_lm(0, plan, torch.float32, cuda)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, plan.cfg.vocab_size, (2, seq))).to(cuda)
    counter = fa.flash_attention_bhsd if arch == "granite-8b" \
        else ss.ssd_intra_chunk
    before = counter.launches
    with torch.no_grad():
        logits = {impl: lm.server_forward(params, plan, lm.client_forward(
            params, plan, toks, impl=impl)[0], impl=impl)[0]
            for impl in ("flash", "jnp")}
    torch.cuda.synchronize()
    assert counter.launches == before + plan.cfg.num_layers
    torch.testing.assert_close(logits["flash"], logits["jnp"], atol=1e-4,
                               rtol=1e-4)
    params["embed"]["table"].requires_grad_()
    with pytest.raises(NotImplementedError, match="forward only"):
        lm.lm_loss(params, plan, toks, toks, impl="flash")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-v0.1-52b"])
def test_moe_forward_card_matches_cpu(cuda, arch):
    """The split forward of a reduced MoE model (and the Jamba hybrid)
    on the card, with impl="flash" (B4, and B5 in Jamba's Mamba-2 layer)
    and impl="jnp", against the CPU's jnp forward from the same weights:
    logits within 1e-4 (the card's and the CPU's f32 sums differ by
    ~1e-6), and every MoE layer's routing equal, unless the CPU's k-th
    and (k+1)-th probabilities lie within 1e-6 of each other there."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm, moe

    plan = lm.build_plan(reduced_config(get_config(arch)), 1)
    params = lm.init_lm(0, plan, torch.float32, "cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, plan.cfg.vocab_size, (2, 96)))
    routes = []
    route = moe.route

    def spy(p, m, x2d, *seq):
        out = route(p, m, x2d, *seq)
        probs = torch.softmax(x2d @ p["router"]["w"].to(x2d.dtype), -1)
        routes.append((out[0].cpu(), probs.cpu()))
        return out

    moe.route = spy
    try:
        logits = {}
        for dev, impl in (("cpu", "jnp"), ("cuda", "jnp"), ("cuda", "flash")):
            p = params if dev == "cpu" else _tree_to(params, cuda)
            with torch.no_grad():
                logits[dev, impl] = lm.server_forward(
                    p, plan, lm.client_forward(p, plan, toks.to(dev),
                                               impl=impl)[0],
                    impl=impl)[0].cpu()
    finally:
        moe.route = route
    n = len(routes) // 3
    assert n >= 1
    k = plan.cfg.moe.top_k
    for i in range(n):
        idx, probs = routes[i]
        for other in (routes[n + i][0], routes[2 * n + i][0]):
            rows = (other != idx).any(-1)
            srt = probs[rows].sort(-1, descending=True).values
            assert bool((srt[:, k - 1] - srt[:, k] <= 1e-6).all())
    for key in (("cuda", "jnp"), ("cuda", "flash")):
        torch.testing.assert_close(logits[key], logits["cpu", "jnp"],
                                   atol=1e-4, rtol=1e-4)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


# ---------------------------------------------------------------- CCC
# The CCC strategy runs no hand-written kernel: these hold its batched
# tensor code on the card against the numpy oracles it mirrors.

@pytest.mark.cuda
@pytest.mark.parametrize("bandwidth", [20e6, 2e5])
def test_ccc_batched_solve_on_card_matches_numpy(cuda, bandwidth):
    """f32 on the card against the float64 scalar solver: equal
    feasibility, chi and psi within the reference's f32 bound (1e-4)."""
    from repro_torch.ccc.convex import solve_p21, solve_p21_batched
    from repro_torch.sysmodel.comm import CommParams, path_loss_gain
    from repro_torch.sysmodel.comp import CompParams

    rng = np.random.RandomState(3)
    gains = np.stack([path_loss_gain(rng.uniform(0.05, 0.5, 10), rng)
                      for _ in range(32)])
    X = rng.uniform(1e5, 5e7, 32)
    comm, comp = CommParams(total_bandwidth=bandwidth), CompParams()
    res = solve_p21_batched(torch.tensor(gains, dtype=torch.float32,
                                         device=cuda),
                            torch.tensor(X, dtype=torch.float32, device=cuda),
                            16.0, comm, comp)
    assert res.chi.device.type == "cuda"
    for i in range(32):
        ref = solve_p21(gains[i], X[i], 16, comm, comp)
        assert bool(res.feasible[i]) == ref.feasible
        if ref.feasible:
            np.testing.assert_allclose(float(res.chi[i]), ref.chi, rtol=1e-4)
            np.testing.assert_allclose(float(res.psi[i]), ref.psi, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("codecs", [("fp32",), ("fp32", "bf16", "int8",
                                                 "int4")])
def test_ccc_batched_env_on_card_matches_scalar_env(cuda, codecs):
    from repro_torch.ccc.env import (BatchedCuttingPointEnv, CuttingPointEnv,
                                     cnn_env_config)

    cfg = cnn_env_config(horizon=10, batch=16, epsilon=0.001, seed=3,
                         codecs=codecs)
    scalar = CuttingPointEnv(cfg)
    scalar.reset()
    benv = BatchedCuttingPointEnv(cfg, n_envs=scalar.n_actions, device=cuda)
    st, _ = benv.reset()
    st = st._replace(gains=torch.tensor(
        np.broadcast_to(scalar.gains, (benv.n_envs, cfg.n_clients)),
        dtype=torch.float32, device=cuda))
    _, obs, r, _, info = benv.step(st, torch.arange(benv.n_envs,
                                                    device=cuda))
    assert obs.device.type == "cuda"
    for a in range(scalar.n_actions):
        v, codec = scalar.decode_action(a)
        gamma, chi, psi, _ = scalar.cost_terms(v, codec)
        np.testing.assert_allclose(float(info["chi"][a]), chi, rtol=1e-3)
        np.testing.assert_allclose(float(info["psi"][a]), psi, rtol=1e-3)
        np.testing.assert_allclose(float(r[a]),
                                   -(cfg.w * gamma + chi + psi), rtol=1e-3)


@pytest.mark.cuda
def test_ccc_fused_step_trains_on_card(cuda):
    from repro_torch.ccc.ddqn import BatchedDDQNAgent, DDQNConfig
    from repro_torch.ccc.env import BatchedCuttingPointEnv, cnn_env_config

    cfg = cnn_env_config(horizon=3, batch=16, epsilon=0.001, seed=2)
    benv = BatchedCuttingPointEnv(cfg, n_envs=32, device=cuda)
    agent = BatchedDDQNAgent(DDQNConfig(state_dim=benv.state_dim,
                                        n_actions=benv.n_actions, batch=64,
                                        target_update=2, seed=0),
                             device=cuda)
    st, ob = benv.reset()
    p0 = agent.qnet.l1.weight.detach().clone()
    losses = []
    for _ in range(4):  # 2 x 32 transitions reach the warm-up of 64
        st, ob, r, done, info, loss = agent.fused_step(benv, st, ob)
        assert r.device.type == "cuda" and bool(torch.isfinite(r).all())
        losses.append(float(loss))
    assert losses[0] == 0.0 and all(x > 0 for x in losses[1:])
    assert agent.grad_steps == 3 and agent.replay.n == 128
    assert not torch.equal(agent.qnet.l1.weight, p0)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,sampler", [("sfl_ga", "uniform"),
                                            ("psl", "rho")])
def test_host_bank_streams_match_device_bank_on_card(cuda, scheme, sampler):
    """The host bank's side-stream prefetch and event-ordered drains give
    the device bank's rounds bit for bit on the card, prefetch on and
    off; the staged slices were consumed (hits) and never more than two
    K-slices sat on the card."""
    from repro_torch.configs.paper_cnn import LIGHT_CONFIG
    from repro_torch.core.simulator import FedSimulator, SimConfig

    n, k, b = 12, 4, 8

    def sim(bank, prefetch=True):
        cfg = SimConfig(scheme=scheme, cut=2, n_clients=n, batch=b,
                        cohort=k, sampler=sampler, bank=bank,
                        bank_prefetch=prefetch, drift_metric=True,
                        uplink_codec="int8", downlink_codec="int8")
        return FedSimulator(LIGHT_CONFIG, cfg, seed=3, device=cuda)

    sims = [sim("device"), sim("host"), sim("host", prefetch=False)]
    rng = np.random.RandomState(0)
    for _ in range(6):
        x = rng.rand(k, 1, b, 28, 28, 1).astype(np.float32)
        y = rng.randint(0, 10, (k, 1, b))
        outs = [s.run_round(x, y) for s in sims]
        assert outs[0] == outs[1] == outs[2]
        for s in sims[1:]:
            for side in ("client", "server"):
                for pb, qb in zip(s.state[side], sims[0].state[side]):
                    for name in pb:
                        assert torch.equal(pb[name].to(cuda), qb[name])
    st = sims[1].bank.stats()
    assert st["prefetch_hits"] > 0
    assert st["device_bytes_peak"] <= 2 * st["bank_bytes"] // n * k
    assert sims[1].state["client"][0]["w"].is_pinned()
    for s in sims:
        s.close()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["device", "host"])
def test_duplicate_scatter_keeps_last_occurrence_on_card(cuda, backend):
    """CUDA leaves the winner among duplicate indexed writes undefined;
    the bank picks each index's last row on the host first."""
    from repro_torch.core.bank import ClientBank

    bank = ClientBank({"w": torch.zeros(64, 1000)}, n_clients=64,
                      stacked=True, backend=backend, device=cuda)
    idx = np.array([5, 9, 5, 5, 9, 1], np.int64)
    upd = torch.arange(6, dtype=torch.float32, device=cuda)[:, None] \
        .expand(6, 1000).contiguous()
    bank.scatter(idx, {"w": upd})
    bank.flush()
    got = bank.tree["w"].cpu()
    assert torch.equal(got[5], torch.full((1000,), 3.0))
    assert torch.equal(got[9], torch.full((1000,), 4.0))
    assert torch.equal(got[1], torch.full((1000,), 5.0))
    assert got[[0, 2, 63]].abs().sum() == 0
    bank.close()


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,sampler", [("sfl_ga", "uniform"),
                                            ("psl", "rho")])
def test_sharded_bank_matches_device_bank_on_card(
        cuda, scheme, sampler, tmp_path, _no_process_group_left):
    """The sharded bank over a one-rank nccl group (``make_bank_mesh``
    over a ``HashStore``: no TCP, no environment) gives the device bank's
    rounds bit for bit on the card, across a ``set_cut`` migration and a
    save and resume; at one rank it holds the whole bank."""
    from repro_torch.configs.paper_cnn import LIGHT_CONFIG
    from repro_torch.core.simulator import FedSimulator, SimConfig

    n, k, b = 16, 4, 8

    def sim(bank):
        cfg = SimConfig(scheme=scheme, cut=2, n_clients=n, batch=b,
                        cohort=k, sampler=sampler, bank=bank,
                        drift_metric=True, uplink_codec="int8",
                        downlink_codec="int8")
        return FedSimulator(LIGHT_CONFIG, cfg, seed=3, device=cuda)

    sims = [sim("device"), sim("sharded")]
    assert torch.distributed.get_backend() == "nccl"
    rng = np.random.RandomState(0)
    batches = [(rng.rand(k, 1, b, 28, 28, 1).astype(np.float32),
                rng.randint(0, 10, (k, 1, b))) for _ in range(6)]
    path = str(tmp_path / "sharded.ckpt")
    for t, (x, y) in enumerate(batches):
        if t == 2:
            assert sims[0].set_cut(1) == sims[1].set_cut(1)
        outs = [s.run_round(x, y) for s in sims]
        assert outs[0] == outs[1]
        assert _same_state(sims[0], sims[1], cuda)
        if t == 3:
            sims[1].save(path)
    st = sims[1].bank.stats()
    assert st["backend"] == "sharded"
    assert st["device_bytes"] == st["bank_bytes"]  # one rank: every row
    fresh = sim("sharded")
    assert fresh.restore(path)["t"] == 4
    for x, y in batches[4:]:
        fresh.run_round(x, y)
    assert _same_state(fresh, sims[0], cuda)


@pytest.mark.cuda
def test_sharded_bank_unit_ops_on_card(cuda, _no_process_group_left):
    """gather (duplicates, a signed zero), scatter with duplicates (the
    last occurrence wins), broadcast and the reductions against the
    device bank on the card, bit for bit."""
    from repro_torch.core.bank import ClientBank
    from repro_torch.core.protocol import ProtocolEngine

    rng = np.random.RandomState(1)
    tree = {"w": torch.from_numpy(rng.randn(64, 1000).astype(np.float32))}
    tree["w"][7, 3] = -0.0
    dev = ClientBank(tree, n_clients=64, stacked=True, device=cuda)
    sh = ClientBank(tree, n_clients=64, stacked=True, backend="sharded",
                    device=cuda)
    idx = np.array([5, 9, 5, 7, 9, 1], np.int64)
    g = sh.gather(idx)
    assert torch.equal(g["w"], dev.gather(idx)["w"])
    assert str(g["w"][3, 3].item()) == "-0.0"
    upd = {"w": torch.arange(6, dtype=torch.float32, device=cuda)[:, None]
           .expand(6, 1000).contiguous()}
    for bank in (dev, sh):
        bank.scatter(idx, upd)
    got = sh.tree["w"].full_tensor()
    assert torch.equal(got, dev.tree["w"])
    assert torch.equal(got[5].cpu(), torch.full((1000,), 2.0))
    rho = torch.rand(64, device=cuda)
    assert torch.equal(sh.rho_mean(rho)["w"], dev.rho_mean(rho)["w"])
    assert sh.drift(ProtocolEngine.client_drift) == \
        dev.drift(ProtocolEngine.client_drift)
    for bank in (dev, sh):
        bank.scatter(None, upd, broadcast=True)
    assert torch.equal(sh.tree["w"].full_tensor(), dev.tree["w"])


def _async_parts(n=12, k=4, b=8):
    """A pure-in-d data stream and a simulator factory for the async
    engine's card tests (light CNN, sfl_ga, int8 both ways)."""
    from repro_torch.configs.paper_cnn import LIGHT_CONFIG
    from repro_torch.core.simulator import FedSimulator, SimConfig

    def data_fn(d, idx):
        rng = np.random.RandomState(100 + d)
        return (rng.rand(len(idx), 1, b, 28, 28, 1).astype(np.float32),
                rng.randint(0, 10, (len(idx), 1, b)))

    def sim(device, bank="device"):
        cfg = SimConfig(scheme="sfl_ga", cut=2, n_clients=n, batch=b,
                        cohort=k, sampler="uniform", bank=bank,
                        drift_metric=True, uplink_codec="int8",
                        downlink_codec="int8")
        return FedSimulator(LIGHT_CONFIG, cfg, seed=3, device=device)

    return data_fn, sim


def _same_state(a, b, device):
    """Two simulators' states bit for bit (a sharded bank's leaves made
    whole first)."""
    def whole(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    for side in ("client", "server"):
        for pa, pb in zip(a.state[side], b.state[side]):
            for name in pa:
                if not torch.equal(whole(pa[name]).to(device),
                                   whole(pb[name]).to(device)):
                    return False
    return True


@pytest.mark.cuda
def test_async_degenerate_schedule_is_run_round_on_card(cuda):
    """B = K and zero-spread completion times: the engine's steps are
    ``run_round`` calls bit for bit on the card (phase 13 (a)), with one
    B1 and two B2/B3 launches a round."""
    from repro_torch.sysmodel.latency import constant_completion_fn

    data_fn, sim = _async_parts()
    a, b = sim(cuda), sim(cuda)
    eng = b.async_engine(data_fn, completion_fn=constant_completion_fn(12))
    before = ga.grad_agg_reduce.launches, qz.quantize_pack.launches
    for t in range(4):
        assert eng.step() == {**a.run_round(*data_fn(
            t, a.cohort_for_round(t)[0])), "clock": float(t + 1),
            "merged": 4, "staleness_mean": 0.0, "staleness_max": 0.0,
            "queue_depth": 0, "merge_idx": t}
    assert eng.sync_steps == 4 and _same_state(a, b, cuda)
    assert (ga.grad_agg_reduce.launches - before[0],
            qz.quantize_pack.launches - before[1]) == (8, 16)


@pytest.mark.cuda
def test_async_sharded_bank_matches_device_on_card(cuda,
                                                   _no_process_group_left):
    """Buffered merges (B 2 of K 4, straggler 8) over the sharded bank
    (one nccl rank) agree with the device bank bit for bit after every
    merge (phase 13 (c))."""
    data_fn, sim = _async_parts()
    sims = [sim(cuda), sim(cuda, bank="sharded")]
    engs = [s.async_engine(data_fn, buffer=2, straggler_factor=8.0)
            for s in sims]
    for _ in range(6):
        outs = [e.step() for e in engs]
        assert outs[0] == outs[1]
        assert _same_state(sims[0], sims[1], cuda)


@pytest.mark.cuda
def test_async_banks_and_resume_bit_identical_on_card(cuda, tmp_path):
    """Buffered merges (B 2 of K 4, straggler 8) on the device and host
    banks agree bit for bit after every merge, and an engine saved
    mid-run and resumed in a fresh simulator ends where the
    uninterrupted run does (phase 13 (c))."""
    data_fn, sim = _async_parts()
    path = str(tmp_path / "async.ckpt")
    sims = [sim(cuda), sim(cuda, bank="host")]
    engs = [s.async_engine(data_fn, buffer=2, straggler_factor=8.0)
            for s in sims]
    for m in range(8):
        outs = [e.step() for e in engs]
        assert outs[0] == outs[1]
        assert _same_state(sims[0], sims[1], cuda)
        if m == 3:
            engs[1].save(path)
    assert engs[0].stats()["mean_staleness"] >= 0
    assert sims[1].bank.stats()["prefetch_hits"] > 0
    fresh = sim(cuda, bank="host")
    eng = fresh.async_engine(data_fn, buffer=2, straggler_factor=8.0)
    assert eng.restore(path)["async_merge_idx"] == 4
    for _ in range(4):
        eng.step()
    assert eng.stats() == engs[1].stats()
    assert _same_state(fresh, sims[1], cuda)
    for s in sims + [fresh]:
        s.close()


def _lm_parts(algo, codec, peft, tau):
    from repro_torch.configs import (PeftSpec, TrainConfig, get_config,
                                     reduced_config)
    from repro_torch.core import algorithms as alg
    from repro_torch.models import lm

    cfg = reduced_config(get_config("granite-8b")).with_overrides(
        num_layers=3, d_model=64, d_ff=128, vocab_size=256)
    spec = PeftSpec(rank=4, alpha=8.0) if peft else None
    plan = lm.build_plan(cfg, 1, peft=spec)
    base = lm.init_lm(0, plan, device="cpu")
    split = alg.split_lm_lora_params(
        base, lm.init_lm_loras(1, plan, device="cpu"), 3) if peft \
        else alg.split_lm_params(base, 3)
    tcfg = TrainConfig(model=cfg, algo=algo, cut_layer=1,
                       compute_dtype="float32", param_dtype="float32",
                       lr=0.05, remat=False, tau=tau, uplink_codec=codec,
                       downlink_codec=codec,
                       peft="lora" if peft else "none")
    return plan, split, tcfg


@pytest.mark.cuda
@pytest.mark.parametrize("algo,codec,peft,tau", [
    ("sfl_ga", "int8", False, 1), ("psl", "int4", True, 1),
    ("sfl", "fp32", False, 2), ("sfl_ga", "fp32", True, 2)])
def test_lm_train_step_on_card_matches_cpu(cuda, algo, codec, peft, tau):
    """One step of the split LM from the same state on the card (kernels
    B1-B3) and on the CPU (plain versions): the loss within 1e-5
    relative, the params within 2e-5 (sgd), and the launches that
    ``chip_smoke.predicted_launches`` counts (B1 once an epoch for
    sfl_ga, B2 and B3 twice an epoch with an int codec). An int codec
    runs one local epoch: a code the two devices round apart (C3) would
    start the second epoch from other params."""
    from repro_torch.core import algorithms as alg
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves, tree_map

    plan, split, tcfg = _lm_parts(algo, codec, peft, tau)
    opt = make_optimizer("sgd", 0.05)
    rng = np.random.RandomState(0)
    shape = (3, 2, 16) if tau == 1 else (3, tau, 2, 16)
    toks = torch.from_numpy(rng.randint(0, 256, shape))
    labels = torch.from_numpy(rng.randint(0, 256, shape))
    out = []
    for dev in ("cpu", cuda):
        p = tree_map(lambda x: x.to(dev), split)
        b = {"tokens": toks.to(dev), "labels": labels.to(dev),
             "seed": np.uint32(9)}
        before = (ga.grad_agg_reduce.launches, qz.quantize_pack.launches,
                  qz.dequant_agg_reduce.launches)
        step = alg.make_train_step(plan, tcfg, opt, 3)
        p, _, m = step(p, opt.init(alg.trainable_params(p)), b)
        torch.cuda.synchronize()
        after = (ga.grad_agg_reduce.launches, qz.quantize_pack.launches,
                 qz.dequant_agg_reduce.launches)
        out.append((p, float(m["loss"]),
                    tuple(a - b for a, b in zip(after, before))))
    (pc, lc, nc), (pg, lg, ng) = out
    assert nc == (0, 0, 0)
    b1 = tau if algo == "sfl_ga" else 0
    bq = 2 * tau if codec != "fp32" else 0
    assert ng == (b1, bq, bq)
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(tree_leaves(alg.trainable_params(pg)),
                    tree_leaves(alg.trainable_params(pc))):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_lm_launcher_banks_and_resume_on_card(cuda, tmp_path):
    """LoRA on the smoke preset on the card: the device and the host bank
    train the same bits, and a resumed run writes the uninterrupted
    run's checkpoint byte for byte (phase 14 (c) at a small size)."""
    import msgpack

    from repro_torch.launch import train

    flags = ["--arch", "granite-8b", "--preset", "smoke", "--layers", "4",
             "--seq", "32", "--peft", "lora", "--optimizer", "adamw",
             "--lr", "0.001", "--clients", "8", "--cohort", "2",
             "--uplink-codec", "int8", "--downlink-codec", "int8",
             "--dynamic-cut", "2,3,2", "--quiet", "--device", "cuda"]
    paths = {k: str(tmp_path / f"{k}.ckpt") for k in
             ("device", "host", "first", "resumed")}
    train.main(flags + ["--steps", "3", "--bank", "device", "--checkpoint",
                        paths["device"]])
    train.main(flags + ["--steps", "3", "--bank", "host", "--checkpoint",
                        paths["host"]])
    train.main(flags + ["--steps", "2", "--bank", "host", "--checkpoint",
                        paths["first"]])
    train.main(flags + ["--steps", "1", "--bank", "host", "--resume",
                        paths["first"], "--checkpoint", paths["resumed"]])

    def payload(path):
        with open(path, "rb") as f:
            data = f.read()
        unp = msgpack.Unpacker(raw=False)
        unp.feed(data)
        unp.unpack()
        return data, data[unp.tell():]

    assert payload(paths["device"])[1] == payload(paths["host"])[1]
    assert payload(paths["resumed"])[0] == payload(paths["host"])[0]


def _launches():
    return (ga.grad_agg_reduce.launches, qz.quantize_pack.launches,
            qz.dequant_agg_reduce.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_whisper_step_on_card_matches_cpu(cuda, codec):
    """One sfl_ga step of the split whisper (reduced whisper-tiny, cut 1,
    N 2) from the same state on the card and on the CPU: two boundaries,
    so two B1 launches, and with int8 four B2 and four B3 (each boundary
    encodes and decodes its uplink and its downlink broadcast); the loss
    within 1e-5 relative and the params within 2e-5. With int8, as
    ``chip_smoke.py`` phase 14 (d) holds it: a code the two devices round
    apart (ROADMAP C3: the encoder's states cross at 2 x 32 x 256 values
    a client) moves its tile's cotangent by a quantum, which reaches the
    client gradients upstream; the params are held to 2e-5 on all but a
    1e-2 share and every element to one step's reach (2 lr)."""
    from repro_torch.configs import TrainConfig, get_config, reduced_config
    from repro_torch.core import algorithms as alg
    from repro_torch.launch import specs
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves, tree_map

    cfg = reduced_config(get_config("whisper-tiny"))
    split = specs._whisper_split_stacked(cfg, 1, 2, seed=0, device="cpu")
    tcfg = TrainConfig(model=cfg, algo="sfl_ga", compute_dtype="float32",
                       param_dtype="float32", uplink_codec=codec,
                       downlink_codec=codec)
    opt = make_optimizer("sgd", 0.05)
    rng = np.random.RandomState(0)
    fe = torch.from_numpy(rng.randn(2, 2, cfg.encoder.num_frames,
                                    cfg.d_model).astype(np.float32))
    toks = torch.from_numpy(rng.randint(0, 512, (2, 2, 8)))
    labels = torch.from_numpy(rng.randint(0, 512, (2, 2, 8)))
    out = []
    for dev in ("cpu", cuda):
        p = tree_map(lambda x: x.to(dev), split)
        before = _launches()
        step = alg.make_whisper_train_step(cfg, tcfg, opt, 2)
        p, _, m = step(p, opt.init(p), {
            "frame_embeds": fe.to(dev), "tokens": toks.to(dev),
            "labels": labels.to(dev), "seed": np.uint32(9)})
        torch.cuda.synchronize()
        out.append((p, float(m["loss"]),
                    tuple(a - b for a, b in zip(_launches(), before))))
    (pc, lc, nc), (pg, lg, ng) = out
    assert nc == (0, 0, 0)
    assert ng == ((2, 4, 4) if codec == "int8" else (2, 0, 0))
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    err = torch.cat([(a.cpu() - b).abs().reshape(-1)
                     for a, b in zip(tree_leaves(pg), tree_leaves(pc))])
    if codec == "fp32":
        assert float(err.max()) <= 2e-5
    else:
        assert float(err.max()) <= 2 * 0.05
        assert float((err > 2e-5).float().mean()) <= 1e-2


@pytest.mark.cuda
def test_lm_async_generation_on_card_matches_cpu(cuda):
    """One generation of the async LM loop (``make_gen_step``, sfl_ga
    int8, 3 clients with cohort weights) on the card and on the CPU: one
    B1 and two B2/B3 launches; the loss within 1e-5 relative, the server
    delta and the client rows within 2e-5."""
    from repro_torch.core import algorithms as alg
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves, tree_map

    plan, split, tcfg = _lm_parts("sfl_ga", "int8", False, 1)
    opt = make_optimizer("sgd", 0.05)
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(0, 256, (3, 2, 16)))
    labels = torch.from_numpy(rng.randint(0, 256, (3, 2, 16)))
    w = np.array([0.9, 1.2, 0.6], np.float32)
    out = []
    for dev in ("cpu", cuda):
        p = tree_map(lambda x: x.to(dev), split)
        before = _launches()
        gen = alg.make_gen_step(plan, tcfg, opt, 3)
        o, _ = gen(p, opt.init(p), {"tokens": toks.to(dev),
                                    "labels": labels.to(dev), "rho": w,
                                    "seed": np.uint32(5)})
        torch.cuda.synchronize()
        out.append((o, tuple(a - b for a, b in zip(_launches(), before))))
    (oc, nc), (og, ng) = out
    assert nc == (0, 0, 0) and ng == (1, 2, 2)
    lc, lg = float(oc["loss"]), float(og["loss"])
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for key in ("server_delta", "client"):
        for a, b in zip(tree_leaves(og[key]), tree_leaves(oc[key])):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["sfl_ga", "sfl"])
def test_lm_step_on_card_holds_to_its_roofline(cuda, algo):
    """``chip_smoke.py`` phase 17 (b) at a small width: the step counted
    on fake tensors (``analysis.roofline.OpCounter``) and on the card
    counts the same FLOPs exactly; the timed p50 is not below the f32
    compute bound at the card's peak; sfl_ga launches B1 once a step,
    sfl never."""
    import time

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.roofline import OpCounter, device_peaks
    from repro_torch.configs import TrainConfig, get_config, reduced_config
    from repro_torch.core import algorithms as alg
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer

    cfg = reduced_config(get_config("granite-8b")).with_overrides(
        num_layers=3)
    plan = lm.build_plan(cfg, 2)
    tcfg = TrainConfig(model=cfg, algo=algo, cut_layer=2,
                       compute_dtype="float32", param_dtype="float32")
    opt = make_optimizer("sgd", 0.01)
    n, b, S = 2, 1, 64

    def setup(device, gen):
        params = alg.split_lm_params(
            lm.init_lm(3, plan, torch.float32, device=device), n)
        toks = torch.randint(0, cfg.vocab_size, (2, n, b, S), generator=gen,
                             device=device)
        return (alg.make_train_step(plan, tcfg, opt, n), params,
                opt.init(params), {"tokens": toks[0], "labels": toks[1]})

    with FakeTensorMode():
        step, params, state, batch = setup("cpu", None)
        fake = OpCounter()
        with fake:
            step(params, state, batch)
    step, params, state, batch = setup(
        cuda, torch.Generator(device=cuda).manual_seed(3))
    before = ga.grad_agg_reduce.launches
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    real = OpCounter()
    with real:
        step(params, state, batch)
    torch.cuda.synchronize()
    assert real.stats.flops == fake.stats.flops > 0
    peaks = device_peaks(torch.cuda.get_device_name(0))
    assert float(np.median(times[1:])) >= \
        fake.stats.flops / peaks.flop_per_s("float32")
    assert ga.grad_agg_reduce.launches - before == (5 if algo == "sfl_ga"
                                                    else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,codec,peft,tau", [
    ("sfl_ga", "fp32", False, 1), ("sfl_ga", "int8", True, 2),
    ("sfl", "fp32", False, 1)])
def test_remat_step_on_card_equals_plain_step(cuda, algo, codec, peft,
                                              tau):
    """The split LM's step with ``remat=True`` against ``remat=False`` on
    the card, from the same state and batches (reduced granite-8b at 3
    layers, cut 1): two steps give the same params, optimizer state and
    losses bit for bit, and the same kernel launches (B1 once an epoch
    for sfl_ga, B2 and B3 twice an epoch with an int codec)."""
    import dataclasses

    from repro_torch.core import algorithms as alg
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves, tree_map

    plan, split, tcfg = _lm_parts(algo, codec, peft, tau)
    split = tree_map(lambda x: x.to(cuda), split)
    opt = make_optimizer("sgd", 0.05)
    rng = np.random.RandomState(0)
    shape = (3, 2, 16) if tau == 1 else (3, tau, 2, 16)
    batches = [{"tokens": torch.from_numpy(rng.randint(0, 256, shape)).to(
        cuda), "labels": torch.from_numpy(rng.randint(0, 256, shape)).to(
        cuda), "seed": np.uint32(9 + i)} for i in range(2)]
    out = []
    for remat in (False, True):
        step = alg.make_train_step(
            plan, dataclasses.replace(tcfg, remat=remat), opt, 3)
        p, state = split, opt.init(alg.trainable_params(split))
        before = _launches()
        losses = []
        for b in batches:
            p, state, m = step(p, state, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        out.append((p, state, losses,
                    tuple(a - b for a, b in zip(_launches(), before))))
    (p0, s0, l0, n0), (p1, s1, l1, n1) = out
    b1 = 2 * tau if algo == "sfl_ga" else 0
    bq = 4 * tau if codec != "fp32" else 0
    assert n0 == n1 == (b1, bq, bq)
    assert l0 == l1
    for a, b in zip(tree_leaves(p0) + tree_leaves(s0),
                    tree_leaves(p1) + tree_leaves(s1)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernels_bench_holds_each_kernel_on_card(cuda):
    """``benchmarks/torch_kernels_bench.py`` on the card: each of its
    seven kernels at the reference's shapes held to its plain version
    (B1-B3 bit for bit, B4 and B5 within ``chip_smoke``'s kernel
    tolerance; the bench raises otherwise), a kernel row and a plain row
    each, and every kernel launched."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmarks import torch_kernels_bench as kb

    counters = (ga.grad_agg_reduce, qz.quantize_pack, qz.dequant_agg_reduce,
                fa.flash_attention_bhsd, ss.ssd_intra_chunk)
    before = [c.launches for c in counters]
    rows = kb.run("cuda")
    assert [n for n, _ in rows] == [
        f"{stem}_{kind}_{shape}" for stem, shape in kb.ROWS
        for kind in ("kernel", "plain")]
    assert all(us > 0 for _, us in rows)
    assert all(c.launches > b for c, b in zip(counters, before))


# G1 (kernels/gemm.py) at every `linear` shape of the benchmark's cells:
# (label, rows a client, clients, K, N); the server's products fold the
# clients into M, the clients' take one weight a client (the batch axis).
# granite-4.0-h's experts: (rows an expert, experts, K, N), the server's
# 9 held experts at C 712 and the 4 clients' 36 at C 178 (batched: an
# expert's weight each, as the MoE layer runs them)
GEMM_SHAPES = [
    ("granite-q-o", 1024, 4, 4096, 4096),
    ("granite-k-v", 1024, 4, 4096, 1024),
    ("granite-gate-up", 1024, 4, 4096, 14336),
    ("granite-down", 1024, 4, 14336, 4096),
    ("granite-head", 1024, 4, 4096, 49152),
    ("mamba2-in-proj", 2048, 4, 768, 3352),
    ("mamba2-out-proj", 2048, 4, 1536, 768),
    ("mamba2-head", 2048, 4, 768, 50280),
    ("granite4h-experts-gate-up", 712, 9, 4096, 768),
    ("granite4h-experts-down", 712, 9, 768, 4096),
    ("granite4h-client-experts-gate-up", 178, 36, 4096, 768),
    ("granite4h-client-experts-down", 178, 36, 768, 4096),
]


def _gemm_operands(form, batch, M, K, N, seed=0):
    """(a, b) of one form for Y (M, N) = X (M, K) W (K, N): "y" (x, w),
    "dx" (dy, w), "dw" (x, dy); batch None for 2-d operands."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if batch is None else (batch,)

    def randn(*shape):
        return torch.randn(lead + shape, generator=gen, device="cuda")

    x, w, dy = randn(M, K), randn(K, N), None
    if form != "y":
        dy = randn(M, N)
    return {"y": (x, w), "dx": (dy, w), "dw": (x, dy)}[form]


def _normwise(c, ref):
    return float((c.double() - ref).norm() / ref.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["server", "clients"])
@pytest.mark.parametrize("form", gm.FORMS)
@pytest.mark.parametrize("label,rows,n,K,N", GEMM_SHAPES,
                         ids=[s[0] for s in GEMM_SHAPES])
def test_gemm_kernel_f32_accurate(cuda, label, rows, n, K, N, form, batched):
    """Each form against an f64 product: within 3x the error of cuBLAS's
    f32 product of the same operands, and 100x below plain TF32's. The
    heads run only on the server."""
    if batched and "head" in label:
        pytest.skip("the head is the server's: no per-client weight")
    batch, M = (n, rows) if batched else (None, n * rows)
    a, b = _gemm_operands(form, batch, M, K, N)
    before = gm.gemm.launches
    c = gm.gemm(a, b, form)
    torch.cuda.synchronize()
    assert gm.gemm.launches == before + 1
    ref = gm.gemm_ref(a.double(), b.double(), form)
    f32 = gm.gemm_ref(a, b, form)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = gm.gemm_ref(a, b, form)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err, err32, errtf = (_normwise(t, ref) for t in (c, f32, tf32))
    assert err <= 3 * err32, (err, err32)
    assert 100 * err <= errtf, (err, errtf)


@pytest.mark.cuda
@pytest.mark.parametrize("form", gm.FORMS)
def test_gemm_kernel_bits_depend_on_nothing_but_k(cuda, form):
    """Two launches give the same bits; a client's product computed in
    the batch gives the same bits as computed alone; and rows computed
    at another M give the same bits. Ragged M, N and K included."""
    batch, M, K, N = 3, 300, 200, 3352
    a, b = _gemm_operands(form, batch, M, K, N, seed=1)
    c = gm.gemm(a, b, form)
    assert torch.equal(c, gm.gemm(a, b, form))
    for i in range(batch):
        assert torch.equal(c[i], gm.gemm(a[i], b[i], form))
    if form == "dw":  # the output's rows are K's: cut the columns of x
        assert torch.equal(c[0][:130], gm.gemm(a[0][:, :132], b[0], form)[
            :130])
    else:
        assert torch.equal(c[0][:130], gm.gemm(a[0][:130], b[0], form))


@pytest.mark.cuda
def test_gemm_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.randn(256, 64, device=cuda)
    w = torch.randn(64, 32, device=cuda)
    bad = [
        (x.bfloat16(), w.bfloat16()),                 # not f32
        (torch.randn(256, 66, device=cuda)[:, :64], w),  # rows of 264 bytes
        (x, torch.randn(32, 64, device=cuda).t()),    # last axis strided
        (torch.randn(256 * 64 + 1, device=cuda)[1:].view(256, 64), w),
    ]
    for a, b in bad:
        with pytest.raises(ValueError):
            gm.gemm(a, b)
    with pytest.raises(ValueError):
        gm.gemm(x, torch.randn(65, 32, device=cuda))  # K does not match
    with pytest.raises(ValueError):
        gm.gemm(x, w.cpu())


@pytest.mark.cuda
def test_granite_step_counts_its_gemm_launches(cuda):
    """An sfl_ga step of granite-8b's layer layout (narrowed, 4 layers,
    cut 2, 4 clients of 1 x 128 tokens) sends every linear to G1: its
    forward, dX and dW, one launch each (the clients' under one vmap a
    layer), 3 x (7 a layer x 4 + the head) = 87 launches a step, and
    nothing left on torch.matmul."""
    from repro_torch.configs import TrainConfig, get_config, reduced_config
    from repro_torch.core import algorithms as alg
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer

    cfg = reduced_config(get_config("granite-8b")).with_overrides(
        num_layers=4, d_model=256, d_ff=512, vocab_size=1024)
    plan = lm.build_plan(cfg, 2)
    split = alg.split_lm_params(lm.init_lm(0, plan, device=cuda), 4)
    tcfg = TrainConfig(model=cfg, algo="sfl_ga", cut_layer=2,
                       compute_dtype="float32", param_dtype="float32",
                       lr=0.01, remat=False)
    opt = make_optimizer("sgd", 0.01)
    step = alg.make_train_step(plan, tcfg, opt, 4)
    state = opt.init(split)
    gen = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, 1024, (2, 4, 1, 128), generator=gen, device=cuda)
    batch = {"tokens": toks[0], "labels": toks[1], "seed": np.uint32(3)}
    for i in range(2):
        launches, passed = gm.gemm.launches, gm.gemm.passed
        split, state, m = step(split, state, batch)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(m["loss"]))
        assert gm.gemm.launches - launches == 3 * (7 * 4 + 1)
        assert gm.gemm.passed == passed
