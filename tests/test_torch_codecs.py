"""The port's cut-layer codecs and wire pricing against the reference.

Integer- and hash-determined results match bit for bit: int8/int4
payloads and scales, the counter hash, bf16 and fp8 casts (including the
reference's NaNs: fp8 for |x| > 464, where torch alone would saturate,
and the sign of a bf16 NaN), the payload specs and the serving traffic
formulas.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compress.codecs import get_codec as ref_codec  # noqa: E402
from repro.kernels.quantize import hash_uniform as ref_hash  # noqa: E402
from repro.sysmodel import payload as ref_payload  # noqa: E402
from repro.sysmodel import traffic as ref_traffic  # noqa: E402
from repro_torch.compress.codecs import get_codec, hash_uniform  # noqa: E402
from repro_torch.sysmodel import payload, traffic  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


def _x(seed, shape, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("name", ["int8", "int4"])
@pytest.mark.parametrize("seed", [0, 12345, 0x7FFFFFFF])
@pytest.mark.parametrize("shape", [(3, 5, 200), (4, 1, 256), (7,)])
def test_int_codec_bitwise(name, seed, shape):
    x = _x(seed % 97, shape)
    x.flat[0] = 0.0
    pr = ref_codec(name).encode(jnp.asarray(x), jnp.uint32(seed))
    pt = get_codec(name).encode(torch.from_numpy(x), seed)
    np.testing.assert_array_equal(pt.data.numpy(), np.asarray(pr.data))
    np.testing.assert_array_equal(pt.scale.numpy(), np.asarray(pr.scale))
    np.testing.assert_array_equal(get_codec(name).decode(pt).numpy(),
                                  np.asarray(ref_codec(name).decode(pr)))


def test_int_codec_all_zero_tile_scale_is_one():
    x = np.zeros((2, 256), np.float32)
    x[1] = _x(1, (256,))
    pt = get_codec("int8").encode(torch.from_numpy(x), 3)
    assert pt.scale[0] == 1.0 and torch.equal(pt.data[0],
                                              torch.zeros_like(pt.data[0]))


def test_hash_uniform_bitwise():
    rng = np.random.RandomState(0)
    n, t, d = (rng.randint(0, 2 ** 32, 4096, dtype=np.uint64)
               for _ in range(3))
    for seed in (0, 1, 0xDEADBEEF):
        want = np.asarray(ref_hash(jnp.asarray(n.astype(np.uint32)),
                                   jnp.asarray(t.astype(np.uint32)),
                                   jnp.asarray(d.astype(np.uint32)),
                                   jnp.uint32(seed)))
        got = hash_uniform(torch.from_numpy(n.astype(np.int64)),
                           torch.from_numpy(t.astype(np.int64)),
                           torch.from_numpy(d.astype(np.int64)), seed)
        np.testing.assert_array_equal(got.numpy(), want)


def test_fp32_passthrough_is_identity():
    x = torch.from_numpy(_x(2, (3, 4)))
    c = get_codec("fp32")
    assert c.roundtrip(x) is x
    assert c.decode(c.encode(x)) is x


SPECIAL = np.array([0.0, 1.0, -1.0, 1e-9, 240.5, 447.0, 448.0, 463.9, 464.0,
                    464.1, -464.0, -470.0, 500.0, 1e6, np.inf, -np.inf,
                    np.nan, -np.nan], np.float32)


@pytest.mark.parametrize("name", ["bf16", "fp8"])
def test_cast_codecs_bitwise(name):
    x = np.concatenate([_x(3, (500,), 200.0), SPECIAL])
    pr = ref_codec(name).encode(jnp.asarray(x))
    pt = get_codec(name).encode(torch.from_numpy(x))
    width = np.uint16 if name == "bf16" else np.uint8
    np.testing.assert_array_equal(
        pt.data.view(torch.uint16 if name == "bf16" else torch.uint8)
        .numpy().view(width), np.asarray(pr.data).view(width))
    np.testing.assert_array_equal(get_codec(name).decode(pt).numpy(),
                                  np.asarray(ref_codec(name).decode(pr)))


def test_fp8_nan_above_464_where_torch_saturates():
    x = torch.tensor([463.9, 464.0, 464.1, -470.0, float("inf")])
    assert torch.isfinite(x.to(torch.float8_e4m3fn).float()).all()
    y = get_codec("fp8").roundtrip(x)
    assert y[:2].tolist() == [448.0, 448.0]
    assert torch.isnan(y[2:]).all()


@pytest.mark.parametrize("density", [0.1, 0.5])
def test_topk_matches_reference_on_tie_free_data(density):
    # distinct magnitudes: jax.lax.top_k and torch.topk are not known to
    # order ties alike, so ties would make the index sets incomparable
    x = np.random.RandomState(4).permutation(
        np.arange(1, 301, dtype=np.float32)) * np.where(
        np.random.RandomState(5).rand(300) > 0.5, 1, -1).astype(np.float32)
    x = x.reshape(3, 100)
    name = f"topk{round(density * 100)}"
    rc, tc = ref_codec(name), get_codec(name)
    pr, pt = rc.encode(jnp.asarray(x)), tc.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(pt.meta.numpy(), np.asarray(pr.meta))
    np.testing.assert_array_equal(pt.data.numpy(), np.asarray(pr.data))
    np.testing.assert_array_equal(tc.decode(pt).numpy(),
                                  np.asarray(rc.decode(pr)))
    _, st = tc.encode_ef(torch.from_numpy(x), tc.init_state(x.shape))
    _, sr = rc.encode_ef(jnp.asarray(x), rc.init_state(x.shape))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sr))


@pytest.mark.parametrize("name", ["fp32", "bf16", "fp8", "int8", "int4",
                                  "topk10", "topk99"])
def test_payload_specs_and_wire_bits_match(name):
    assert dataclasses.astuple(payload.spec_for(name)) == \
        dataclasses.astuple(ref_payload.spec_for(name))
    for numel in (0, 1, 255, 256, 257, 4096 * 16):
        for raw in (16.0, 32.0):
            assert traffic.wire_bits(name, numel, raw) == \
                ref_traffic.wire_bits(name, numel, raw)
    assert get_codec(name).payload_bits((3, 257)) == \
        ref_codec(name).payload_bits((3, 257))


@pytest.mark.parametrize("codec", ["fp32", "int8", "int4", "fp8"])
def test_serving_traffic_formulas_match(codec):
    for n_live in (0, 1, 3):
        assert traffic.decode_step_traffic(
            n_live=n_live, d_model=4096, codec=codec) == \
            ref_traffic.decode_step_traffic(n_live=n_live, d_model=4096,
                                            codec=codec)
    for S in (1, 16, 33):
        assert traffic.prefill_traffic(
            prompt_len=S, d_model=256, codec=codec,
            raw_bits_per_elem=16.0) == ref_traffic.prefill_traffic(
            prompt_len=S, d_model=256, codec=codec, raw_bits_per_elem=16.0)


def test_ledger_categories_match_reference():
    from repro.obs.ledger import LEDGER_CATEGORIES as ref_cats
    from repro_torch.obs.ledger import LEDGER_CATEGORIES

    assert LEDGER_CATEGORIES == ref_cats
    assert set(traffic._empty_breakdown()) == set(LEDGER_CATEGORIES)
