"""Kernel B4 (causal / windowed flash attention): the port's plain version
and ``ops.flash_attention`` against the reference on the CPU.

The reference's Pallas kernel runs as its own tests run it (interpret
mode, through ``ops.flash_attention``), its oracle as
``ref.sdpa_ref``. Inputs are drawn with numpy from a seed and handed to
both. Tolerance: 2e-5, the reference's own bound for its kernel in f32
(``tests/test_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

TOL = 2e-5


def _qkv(seed, B, S, hq, hkv, D):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, h, D).astype(np.float32) for h in (hq, hkv, hkv)]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


# (B, S, Hq, Hkv, D, window): the reference's f32 cases -- GQA, no GQA at
# D = 128, a sliding window, a head_dim outside {64, 128} (the reference
# pads it to 128 on its kernel path)
CASES = [(2, 128, 4, 2, 64, None), (1, 256, 4, 1, 64, None),
         (2, 128, 8, 2, 128, None), (1, 128, 4, 4, 64, 32),
         (1, 128, 2, 2, 112, None)]


@pytest.mark.parametrize("B,S,hq,hkv,D,window", CASES)
def test_ops_flash_attention_matches_the_reference(B, S, hq, hkv, D, window):
    q, k, v = _qkv(S + D, B, S, hq, hkv, D)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              window=window)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kern = rops.flash_attention(jq, jk, jv, causal=True, window=window)
    oracle = rops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  backend="jnp")
    _close(out, kern)
    _close(out, oracle)


@pytest.mark.parametrize("S,window", [(100, None), (130, 33), (64, 200)])
def test_plain_version_takes_ragged_lengths(S, window):
    """The reference's kernel asserts S divides its tile; the port masks
    the ragged last tile. Held against the oracle on the BHSD layout."""
    q, k, v = (np.swapaxes(a, 1, 2) for a in _qkv(S, 1, S, 4, 2, 64))
    out = fa.flash_attention_bhsd(*(torch.from_numpy(np.ascontiguousarray(a))
                                    for a in (q, k, v)), window)
    want = rref.sdpa_ref(*(jnp.asarray(a) for a in (q, k, v)), True, window)
    _close(out, want)


def test_attend_train_flash_matches_the_masked_softmax():
    """``impl="flash"`` and ``impl="jnp"`` are the same function."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import attention as attn_mod

    cfg = reduced_config(get_config("granite-8b"))
    gen = torch.Generator().manual_seed(0)
    p = attn_mod.init_attention(gen, cfg)
    x = torch.randn(2, 48, cfg.d_model, generator=gen)
    pos = torch.arange(48)[None].expand(2, 48)
    a = attention.attend_train(p, cfg, x, pos, impl="flash")
    b = attention.attend_train(p, cfg, x, pos, impl="jnp")
    torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="impl"):
        attention.attend_train(p, cfg, x, pos, impl="pallas")


def test_head_dim_above_128_raises_as_in_the_reference():
    q = torch.zeros(1, 64, 2, 160)
    with pytest.raises(NotImplementedError, match="head_dim"):
        ops.flash_attention(q, q, q)


def _tf32(x):
    """``cvt.rna.tf32.f32``: the f32 bit pattern rounded to 10 mantissa
    bits, to nearest, ties away from zero."""
    u = x.numpy().view(np.uint32)
    return torch.from_numpy(((u + np.uint32(0x1000))
                             & np.uint32(0xFFFFE000)).view(np.float32))


def _mm_tf32(a, b, terms):
    """a @ b on TF32 operands, f32 sums: one product (hi.hi), or the
    kernel's three (lo.hi + hi.lo + hi.hi, lo = tf32(x - hi)). Each TF32
    product is exact in f32 (11 x 11 significant bits)."""
    ahi, bhi = _tf32(a), _tf32(b)
    if terms == 1:
        return ahi @ bhi
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _attention_tf32(q, k, v, terms):
    """Causal GQA attention with both products (q.k and p.v) of the plain
    version taken as :func:`_mm_tf32` does."""
    B, Hq, S, D = q.shape
    kf = k.repeat_interleave(Hq // k.shape[1], dim=1)
    vf = v.repeat_interleave(Hq // v.shape[1], dim=1)
    s = _mm_tf32(q * (1.0 / np.sqrt(D)), kf.transpose(-1, -2), terms)
    i = torch.arange(S)
    s = torch.where(i[None, :] <= i[:, None], s, fa.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _mm_tf32(p, vf, terms) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("qscale", [1.0, 2.0])
def test_one_tf32_product_misses_the_tolerance_and_three_hold_it(qscale):
    """Why the card's kernel splits each operand: at S 256, D 128, GQA
    4:1 and unit-normal inputs (q x 1, x 2), one TF32 product (10 mantissa
    bits) puts the output ~1e-3 from the plain version, outside the 2e-5
    that holds the kernel, and the 3xTF32 split stays well inside it."""
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(1, h, 256, 128).astype(np.float32))
               for h in (8, 2, 2))
    q = q * qscale
    ref = fa.flash_attention_ref(q, k, v)
    err1 = float((_attention_tf32(q, k, v, 1) - ref).abs().max())
    err3 = float((_attention_tf32(q, k, v, 3) - ref).abs().max())
    assert err1 > 10 * TOL, err1
    assert err3 < TOL / 2, err3
