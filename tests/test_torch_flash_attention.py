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

TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_threads():
    """One large parallel ``exp`` first: on the CPU the first one in a
    process can be off by ~1e-4 relative on one worker thread's chunk,
    and later ones are not (pinned in ``test_torch_cpu_exp.py``)."""
    torch.exp(torch.randn(1 << 20))


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
