"""B2 and B3, the int8/int4 codec kernels, in the port against the
reference.

The plain versions (``repro_torch.kernels.quantize.quantize_ref`` and
``dequant_agg_ref``, what the wrappers run for CPU tensors) are held
against the reference's jnp oracles and its Pallas kernels in interpret
mode: payloads and scales bit for bit, the aggregate within 1e-6 (bit
for bit at N = 1). The routed ``IntQuantCodec`` and the batched
per-client channel are held to the reference codec bit for bit. The
Hopper kernels are held against the plain versions on the card in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compress import channel as jchannel  # noqa: E402
from repro.compress.codecs import get_codec as ref_codec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.compress import channel, get_codec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

# (N, T, D, block_t, block_d): one tile, several tiles in both axes, the
# codec's flat (1, 1, numel_pad) view in (1, 256) tiles
CASES = [(1, 8, 128, 8, 128), (3, 16, 256, 8, 128), (2, 32, 512, 16, 256),
         (1, 1, 1024, 1, 256)]
SEEDS = [0, 12345, 0x80000001, 0xFFFFFFFF]  # including seeds >= 2^31


def _g(seed, shape, scale=3.0):
    g = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    return g


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("n,t,d,bt,bd", CASES)
def test_quantize_plain_bitwise_vs_oracle_and_pallas(bits, stochastic, n, t,
                                                     d, bt, bd):
    g = _g(n * t + d, (n, t, d))
    g[0, :bt, :bd] = 0.0  # an all-zero tile: scale 1, codes 0
    for seed in SEEDS:
        q, s = ops.quantize(torch.from_numpy(g), seed, bits, bt, bd,
                            stochastic)
        qo, so = ref.quantize_ref(jnp.asarray(g), jnp.uint32(seed), bits, bt,
                                  bd, stochastic)
        np.testing.assert_array_equal(q.numpy(), np.asarray(qo))
        np.testing.assert_array_equal(s.numpy(), np.asarray(so))
        assert s[0, 0, 0] == 1.0 and not q[0, :bt, :bd // (8 // bits)].any()
    qp, sp = jops.quantize(jnp.asarray(g), jnp.uint32(SEEDS[2]), bits,
                           block_t=bt, block_d=bd, stochastic=stochastic)
    q, s = ops.quantize(torch.from_numpy(g), SEEDS[2], bits, bt, bd,
                        stochastic)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sp))


def test_quantize_model_layout():
    g = _g(5, (2, 4, 8, 128))
    q, s = ops.quantize(torch.from_numpy(g), 9, 8, 32, 128)
    qo, so = jops.quantize(jnp.asarray(g), jnp.uint32(9), 8, backend="jnp",
                           block_t=32, block_d=128)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qo))
    np.testing.assert_array_equal(s.numpy(), np.asarray(so))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", [1, 3])
def test_dequant_agg_plain_vs_oracle_and_pallas(bits, n):
    g = _g(n, (n, 16, 256))
    q, s = ref.quantize_ref(jnp.asarray(g), jnp.uint32(3), bits, 8, 128)
    rho = np.random.RandomState(n).dirichlet(np.ones(n)).astype(np.float32)
    if n == 1:
        rho[:] = 1.0
    got = ops.dequant_agg(torch.from_numpy(np.array(q)),
                          torch.from_numpy(np.array(s)),
                          torch.from_numpy(rho), bits, 8, 128).numpy()
    oracle = np.asarray(ref.dequant_agg_ref(q, s, jnp.asarray(rho), bits, 8,
                                            128))
    pallas = np.asarray(jops.dequant_agg(q, s, jnp.asarray(rho), bits,
                                         block_t=8, block_d=128))
    # f32; the reference's einsum may sum the N clients in another order
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    if n == 1:  # one client, rho = 1: the codec's decode, bit for bit
        np.testing.assert_array_equal(got, oracle)
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("name", ["int8", "int4"])
@pytest.mark.parametrize("shape", [(3, 5, 200), (4, 1, 256), (7,)])
def test_routed_codec_bitwise(name, shape):
    x = _g(len(shape), shape)
    for seed in (0, 0x9E3779B1):
        pr = ref_codec(name).encode(jnp.asarray(x), jnp.uint32(seed))
        pt = get_codec(name).encode(torch.from_numpy(x), seed)
        np.testing.assert_array_equal(pt.data.numpy(), np.asarray(pr.data))
        np.testing.assert_array_equal(pt.scale.numpy(), np.asarray(pr.scale))
        np.testing.assert_array_equal(
            get_codec(name).decode(pt).numpy(),
            np.asarray(ref_codec(name).decode(pr)))


def test_codec_routes_through_the_kernel_wrappers(monkeypatch):
    """encode/decode call ops.quantize / ops.dequant_agg on the (1, 1,
    numel_pad) view in (1, 256) tiles at rho = 1."""
    seen = []
    real_q, real_d = ops.quantize, ops.dequant_agg

    def spy_q(g, seed, bits, bt, bd, stochastic, client_seeds=None):
        seen.append(("q", tuple(g.shape), bt, bd))
        return real_q(g, seed, bits, bt, bd, stochastic, client_seeds)

    def spy_d(q, s, rho, bits, bt, bd):
        seen.append(("d", tuple(q.shape), bt, bd, rho.tolist()))
        return real_d(q, s, rho, bits, bt, bd)

    monkeypatch.setattr(ops, "quantize", spy_q)
    monkeypatch.setattr(ops, "dequant_agg", spy_d)
    get_codec("int4").roundtrip(torch.from_numpy(_g(1, (3, 100))), 5)
    assert seen == [("q", (1, 1, 512), 1, 256),
                    ("d", (1, 1, 256), 1, 256, [1.0])]


def test_flat_view_is_the_one_that_matches_the_codec():
    """The codec's bits are quantize_pack's on the (1, 1, numel_pad) view;
    the (1, numel_pad/256, 256) view has the same tiles and scales but
    hashes (0, row, col) instead of (0, 0, flat index): other codes."""
    x = _g(11, (4, 256))
    pc = ref_codec("int8").encode(jnp.asarray(x), jnp.uint32(7))
    q1, s1 = ref.quantize_ref(jnp.asarray(x.reshape(1, 1, -1)),
                              jnp.uint32(7), 8, 1, 256)
    q2, s2 = ref.quantize_ref(jnp.asarray(x.reshape(1, 4, 256)),
                              jnp.uint32(7), 8, 1, 256)
    np.testing.assert_array_equal(np.asarray(q1).reshape(4, 256),
                                  np.asarray(pc.data))
    np.testing.assert_array_equal(np.asarray(s2).reshape(-1),
                                  np.asarray(pc.scale))
    assert not np.array_equal(np.asarray(q2).reshape(4, 256),
                              np.asarray(pc.data))


@pytest.mark.parametrize("name", ["int8", "int4"])
@pytest.mark.parametrize("seed", [0, 0xFFFFFFF0])
def test_batched_client_encode_equals_single_encodes(name, seed):
    """One B2 and one B3 call for K clients give the bits of K separate
    roundtrips with seeds seed + n * GOLDEN, and the reference's vmapped
    uplink channel."""
    x = _g(2, (4, 3, 100), 5.0)
    codec = get_codec(name)
    seeds = channel.client_seeds(seed, 4)
    np.testing.assert_array_equal(
        seeds.numpy(), np.asarray(jchannel.client_seeds(jnp.uint32(seed), 4)))
    p = codec.encode_clients(torch.from_numpy(x), seeds)
    for k in range(4):
        single = codec.encode(torch.from_numpy(x[k]), int(seeds[k]))
        assert torch.equal(p.data[k], single.data)
        assert torch.equal(p.scale[k], single.scale)
    up = channel.uplink_channel(codec, torch.from_numpy(x), seed)
    assert torch.equal(up, codec.decode_clients(p))
    want = jchannel.uplink_channel(ref_codec(name), jnp.asarray(x),
                                   jnp.uint32(seed))
    np.testing.assert_array_equal(up.numpy(), np.asarray(want))


def test_cpu_tensors_count_no_launch():
    before = (qz.quantize_pack.launches, qz.dequant_agg_reduce.launches)
    get_codec("int8").roundtrip(torch.from_numpy(_g(0, (300,))), 1)
    assert (qz.quantize_pack.launches,
            qz.dequant_agg_reduce.launches) == before


def test_plain_version_rejects_a_ragged_tiling():
    with pytest.raises(ValueError, match="tiles"):
        qz.quantize_ref(torch.zeros(1, 3, 100), 0, 8, 2, 64)
    with pytest.raises(ValueError, match="bits"):
        qz.quantize_ref(torch.zeros(1, 2, 64), 0, 6, 2, 64)


# (N, T, D, block_t, block_d) for the launch plans, from shapes alone: the
# codec's flat tile at cut 2, the sfl_ga broadcast and granite-8b's serve
# step; small tiles that are not 256 wide (one with fewer units than
# lanes); bd = 6 and bd = 2 (not multiples of 4); the reference kernel's
# 256 x 256 at the LM boundary and on few tiles; 512 x 128 (a cluster of
# 8); a tile above 65,536 elements; D = 16 k + 8; mid-size tiles on few
# and on many tiles
PLAN_CASES = [(10, 1, 100352, 1, 256), (1, 1, 100352, 1, 256),
              (1, 1, 16384, 1, 256), (3, 16, 512, 8, 128), (2, 6, 96, 3, 32),
              (1, 4, 4, 1, 4), (2, 4, 36, 2, 6), (3, 8, 10, 4, 2),
              (8, 2048, 4096, 256, 256), (2, 512, 512, 256, 256),
              (2, 64, 256, 64, 256), (1, 1024, 256, 512, 128),
              (1, 512, 256, 512, 256), (2, 4, 40, 2, 8), (1, 8, 24, 4, 24),
              (2, 64, 64, 32, 64), (5, 96, 1000, 32, 40)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n,t,d,bt,bd", PLAN_CASES)
def test_quantize_plan_covers_every_tile_once(n, t, d, bt, bd, bits,
                                              aligned):
    """Each tile has exactly one warp, cluster or block; each 4-element
    unit of a tile exactly one (thread, k) on the vector paths; clusters
    of at most 8 and at most 32 values a thread in registers."""
    plan = qz.quantize_plan(n, t, d, bt, bd, bits, sms=132, aligned=aligned)
    tiles = n * (t // bt) * (d // bd)
    if plan.path == "warp":
        owner = np.arange(plan.grid * qz.WARPS)
        assert plan.cluster == 1
        assert len(owner) - tiles < qz.WARPS  # no idle block
        threads = 32
    elif plan.path == "cluster":
        owner = np.arange(plan.grid) // plan.cluster
        assert plan.grid == tiles * plan.cluster
        threads = plan.cluster * qz.THREADS
    else:
        owner = np.arange(plan.grid)
        assert (plan.cluster, plan.units) == (1, 0)
        threads = None
    per_tile = np.bincount(owner[owner < tiles], minlength=tiles)
    expect = plan.cluster if plan.path == "cluster" else 1
    assert (per_tile == expect).all()
    assert 1 <= plan.cluster <= qz.MAX_CLUSTER
    assert plan.values <= 32
    if threads is not None:
        assert plan.values == 4 * plan.units
        u = (np.arange(threads)[:, None]
             + np.arange(plan.units)[None, :] * threads).ravel()
        units = bt * bd // 4
        assert (np.bincount(u[u < units], minlength=units) == 1).all()
        # a power of two, and no smaller one would hold the tile
        assert plan.units & (plan.units - 1) == 0
        assert plan.units == 1 or (plan.units // 2) * threads < units


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n,t,d,bt,bd", PLAN_CASES)
def test_quantize_plan_takes_vector_paths_only_where_they_hold(n, t, d, bt,
                                                               bd, aligned):
    """Warp path iff g is aligned, bd % 4 == 0 and the tile has at most
    1,024 elements; cluster path iff the same up to 65,536; else general."""
    bits = 4 if bd % 2 == 0 else 8
    path = qz.quantize_plan(n, t, d, bt, bd, bits, 132, aligned).path
    vector = aligned and bd % 4 == 0
    elems = bt * bd
    want = ("warp" if vector and elems <= qz.WARP_TILE else
            "cluster" if vector and elems <= qz.CLUSTER_TILE else "general")
    assert path == want


def test_quantize_plan_at_the_main_path_shapes():
    """The cut-2 uplink is one wave of warps on 132 SMs; the LM
    boundary's 256 x 256 tiles take clusters of 8 holding 32 values a
    thread; a 512 x 128 tile too, a 64 x 256 tile on 2 tiles spreads to 8
    blocks a tile to fill the card."""
    assert qz.quantize_plan(10, 1, 100352, 1, 256, 8, 132) == qz.QuantPlan(
        "warp", 490, 1, 2, 8)
    assert qz.quantize_plan(8, 2048, 4096, 256, 256, 8, 132) == \
        qz.QuantPlan("cluster", 8192, 8, 8, 32)
    assert qz.quantize_plan(1, 1024, 256, 512, 128, 4, 132).cluster == 8
    assert qz.quantize_plan(2, 64, 256, 64, 256, 8, 132)[:4] == (
        "cluster", 16, 8, 2)
    # many mid-size tiles fill the card at one block a tile
    assert qz.quantize_plan(64, 256, 256, 64, 64, 8, 132)[:3] == (
        "cluster", 1024, 1)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n,t,d,bt,bd", PLAN_CASES)
def test_dequant_plan_covers_every_output_once(n, t, d, bt, bd, bits,
                                               aligned):
    """Vector path iff q is aligned and bd % 16 == 0 (16 outputs a thread
    inside one tile column); its threads, or the general path's warps,
    cover the (T, D) output with no idle block."""
    plan = qz.dequant_plan(n, t, d, bt, bd, bits, aligned)
    assert plan.path == ("vector" if aligned and bd % 16 == 0
                         else "general")
    if plan.path == "vector":
        assert d % 16 == 0 and (d // 16) * 16 == d
        work, per_block = t * (d // 16), qz.THREADS
    else:
        work, per_block = t * -(-d // qz.SEGMENT), qz.WARPS
    assert (plan.grid - 1) * per_block < work <= plan.grid * per_block
