"""Kernel B5 (the Mamba-2 SSD intra-chunk step) and the SSD around it:
the port against the reference on the CPU.

The port's plain version of B5 (``ssd_intra_chunk_ref``, B and C per
group) is held against the reference's Pallas kernel, run as its own
tests run it (interpret mode, B and C expanded to every head); the
port's ``ops.ssd`` against the reference's ``ops.ssd`` (interpret) and
``ref.ssd_ref``; ``ssd_chunked`` against the reference's; and
``_ssd_any_length`` over a ragged length against the reference's O(S)
recurrence ``ref.ssd_sequential_ref``; and ``ssd_chunked``'s
vector-Jacobian product (the train step's backward through the SSD)
against the reference's under ``jax.vjp``, also under ``torch.func.vmap``
over clients. Inputs are drawn with numpy from a seed and handed to
both. Tolerance: 1e-4, the reference's own bound for its kernel
(``tests/test_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.ssd_scan import ssd_intra_chunk as r_intra  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

TOL = 1e-4


def _inputs(seed, b, s, h, p, g, n, state=False):
    """x, dt, A, B, C (and an initial state) as the reference's tests
    draw them: dt a softplus times 0.1, A = -exp(N(0, 0.25))."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    out = [rng.randn(b, s, h, p).astype(f32),
           (np.log1p(np.exp(rng.randn(b, s, h))) * 0.1).astype(f32),
           (-np.exp(rng.randn(h) * 0.5)).astype(f32),
           (rng.randn(b, s, g, n) * 0.3).astype(f32),
           (rng.randn(b, s, g, n) * 0.3).astype(f32)]
    if state:
        out.append((rng.randn(b, h, p, n) * 0.5).astype(f32))
    return out


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


# (b, h, g, c, Q, P, N)
INTRA_CASES = [(2, 4, 1, 3, 32, 64, 32), (1, 4, 2, 2, 16, 16, 8),
               (1, 2, 1, 1, 128, 64, 128)]


@pytest.mark.parametrize("b,h,g,c,Q,P,N", INTRA_CASES)
def test_plain_intra_chunk_matches_the_pallas_kernel(b, h, g, c, Q, P, N):
    rng = np.random.RandomState(Q + N)
    xdt = rng.randn(b, h, c, Q, P).astype(np.float32)
    dA = (-0.3 * rng.rand(b, h, c, Q)).astype(np.float32)
    B = rng.randn(b, g, c, Q, N).astype(np.float32)
    C = rng.randn(b, g, c, Q, N).astype(np.float32)
    y, st = ss.ssd_intra_chunk(*(torch.from_numpy(a)
                                 for a in (xdt, dA, B, C)))
    rep = h // g
    yr, str_ = r_intra(jnp.asarray(xdt), jnp.asarray(dA),
                       jnp.asarray(np.repeat(B, rep, axis=1)),
                       jnp.asarray(np.repeat(C, rep, axis=1)),
                       interpret=True)
    _close(y, yr)
    _close(st, str_)


def _tf32(x):
    """``cvt.rna.tf32.f32``: the f32 bit pattern rounded to 10 mantissa
    bits, to nearest, ties away from zero."""
    u = x.contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((u + np.uint32(0x1000))
                             & np.uint32(0xFFFFE000)).view(np.float32))


def _mm_tf32(a, b, terms):
    """a @ b on TF32 operands, f32 sums: one product (hi.hi), or the card
    kernel's three (lo.hi + hi.lo + hi.hi, lo = tf32(x - hi)). Each TF32
    product is exact in f32 (11 x 11 significant bits)."""
    ahi, bhi = _tf32(a), _tf32(b)
    if terms == 1:
        return ahi @ bhi
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _intra_chunk_tf32(xdt, dA, B, C, terms):
    """The plain version's arithmetic with its three products (C B^T, the
    decayed scores times xdt, and the state) taken as :func:`_mm_tf32`
    does; B and C per head."""
    Q = xdt.shape[3]
    cs = torch.cumsum(dA, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    lower = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.where(lower, torch.exp(torch.where(lower, seg, 0.0)), 0.0)
    y = _mm_tf32(_mm_tf32(C, B.transpose(-1, -2), terms) * L, xdt, terms)
    bw = B * torch.exp(cs[..., -1:] - cs)[..., None]
    return y, _mm_tf32(xdt.transpose(-1, -2), bw, terms)


@pytest.mark.parametrize("which", ["y", "state"])
def test_one_tf32_product_misses_the_tolerance_and_three_hold_it(which):
    """Why the card's B5 splits each operand: at mamba2-130m's chunk (Q
    128, head_dim 64, state 128; 24 heads, 2 chunks) one TF32 product
    (10 mantissa bits) puts y and the state ~5e-4 of their largest value
    from the plain version, far outside the 1e-5 of it that holds the
    kernel on the card, and the 3xTF32 split stays well inside it."""
    rng = np.random.RandomState(16)
    b, h, c, Q, P, N = 1, 24, 2, 128, 64, 128
    xdt, B, C = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 for shape in ((b, h, c, Q, P), (b, h, c, Q, N),
                               (b, h, c, Q, N)))
    dA = torch.from_numpy((-0.5 * rng.rand(b, h, c, Q)).astype(np.float32))
    k = ("y", "state").index(which)
    ref = ss.ssd_intra_chunk_ref(xdt, dA, B, C)[k]
    tol = 1e-5 * float(ref.abs().max())
    err1 = float((_intra_chunk_tf32(xdt, dA, B, C, 1)[k] - ref).abs().max())
    err3 = float((_intra_chunk_tf32(xdt, dA, B, C, 3)[k] - ref).abs().max())
    assert err1 > 10 * tol, (err1, tol)
    assert err3 < tol / 2, (err3, tol)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 128, 4, 64, 1, 32, 32),
    (1, 64, 2, 64, 2, 16, 16),
    (1, 256, 8, 64, 1, 128, 64),
])
def test_ops_ssd_matches_the_reference(b, s, h, p, g, n, chunk):
    arrs = _inputs(s + n, b, s, h, p, g, n, state=True)
    x, dt, A, B, C, h0 = arrs
    for init in (None, h0):
        y, st = ops.ssd(*(torch.from_numpy(a) for a in (x, dt, A, B, C)),
                        chunk=chunk, initial_state=None if init is None
                        else torch.from_numpy(init))
        jargs = [jnp.asarray(a) for a in (x, dt, A, B, C)]
        jinit = None if init is None else jnp.asarray(init)
        yk, stk = rops.ssd(*jargs, chunk, initial_state=jinit)
        yr, str_ = rref.ssd_ref(*jargs, chunk, jinit)
        for want_y, want_st in ((yk, stk), (yr, str_)):
            _close(y, want_y)
            _close(st, want_st)
        yc, stc = ssm.ssd_chunked(*(torch.from_numpy(a)
                                    for a in (x, dt, A, B, C)), chunk,
                                  None if init is None
                                  else torch.from_numpy(init))
        _close(yc, yr)
        _close(stc, str_)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_any_length_matches_the_sequential_recurrence(g, with_state,
                                                      use_kernel):
    """40 = one chunk of 32 through the chunked head, 8 through the
    sequential tail seeded with the head's state."""
    b, s, h, p, n, chunk = 2, 40, 4, 16, 8, 32
    arrs = _inputs(7 * g, b, s, h, p, g, n, state=True)
    x, dt, A, B, C, h0 = arrs
    init = h0 if with_state else None
    y, st = ssm._ssd_any_length(
        *(torch.from_numpy(a) for a in (x, dt, A, B, C)), chunk,
        None if init is None else torch.from_numpy(init), use_kernel)
    yr, str_ = rref.ssd_sequential_ref(
        *(jnp.asarray(a) for a in (x, dt, A, B, C)),
        None if init is None else jnp.asarray(init))
    _close(y, yr)
    _close(st, str_)
    # and the reference's own ragged path, head and tail
    ya, sta = rssm._ssd_any_length(
        *(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk,
        None if init is None else jnp.asarray(init), use_kernel)
    _close(y, ya)
    _close(st, sta)


def _cotangents(seed, b, s, h, p, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, p).astype(np.float32),
            rng.randn(b, h, p, n).astype(np.float32))


def _torch_vjp(arrs, chunk, cots):
    """ssd_chunked's outputs and the gradients of x, dt, A, B, C (and
    the initial state, where given) against the cotangents of y and the
    final state."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    init = leaves[5] if len(leaves) > 5 else None
    y, st = ssm.ssd_chunked(*leaves[:5], chunk, init)
    grads = torch.autograd.grad((y, st), leaves,
                                tuple(torch.from_numpy(c) for c in cots))
    return [y, st, *grads]


# (b, s, h, p, g, n, chunk): one group, groups of 2 heads, a group a head
VJP_CASES = [(2, 64, 4, 16, 1, 8, 16), (1, 64, 4, 16, 2, 8, 32),
             (1, 32, 4, 8, 4, 16, 16)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", VJP_CASES)
def test_ssd_chunked_vjp_matches_the_reference(b, s, h, p, g, n, chunk,
                                               with_state):
    """The port contracts per group, where the reference's ``jnp.einsum``
    chooses its own order: y, the final state and every input's gradient
    agree within the tolerance."""
    arrs = _inputs(s + 3 * g, b, s, h, p, g, n, state=True)
    if not with_state:
        arrs = arrs[:5]
    cots = _cotangents(s + g, b, s, h, p, n)

    def ref(*a):
        return rssm.ssd_chunked(*a[:5], chunk,
                                a[5] if len(a) > 5 else None)
    want, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in arrs))
    want_grads = vjp(tuple(jnp.asarray(c) for c in cots))
    got = _torch_vjp(arrs, chunk, cots)
    assert len(got) == 2 + len(want_grads)
    for g_, w in zip(got, [*want, *want_grads]):
        _close(g_.detach(), w)


def test_ssd_chunked_vjp_under_vmap_matches_the_loop_over_clients():
    """As the clients' layers call it: one vmap over a leading client
    axis (each client its own A, groups of 2 heads, an initial state),
    forward and backward, equal to each client's call on its own."""
    K, b, s, h, p, g, n, chunk = 3, 1, 64, 4, 16, 2, 8, 32
    per = [_inputs(40 + k, b, s, h, p, g, n, state=True) for k in range(K)]
    arrs = [np.stack(a) for a in zip(*per)]
    cots = [np.stack(c) for c in zip(*(_cotangents(50 + k, b, s, h, p, n)
                                       for k in range(K)))]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, st = torch.func.vmap(
        lambda x, dt, A, B, C, h0: ssm.ssd_chunked(x, dt, A, B, C, chunk,
                                                   h0))(*leaves)
    grads = torch.autograd.grad((y, st), leaves,
                                tuple(torch.from_numpy(c) for c in cots))
    got = [y.detach(), st.detach(), *grads]
    for k in range(K):
        want = _torch_vjp(per[k], chunk, tuple(c[k] for c in cots))
        for g_, w in zip(got, want):
            _close(g_[k], w.detach())


def test_ssd_rejects_a_ragged_sequence():
    x, dt, A, B, C = (torch.from_numpy(a)
                      for a in _inputs(0, 1, 40, 2, 8, 1, 8))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd(x, dt, A, B, C, chunk=32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.ssd_chunked(x, dt, A, B, C, chunk=32)
