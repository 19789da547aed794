"""Public wrappers around the port's kernels, in the model's layouts.

Counterpart of ``repro.kernels.ops``. There is no backend switch: the
tensor's device decides (the plain version on the CPU, the Hopper kernel
on the card), as each kernel's wrapper documents. :func:`matmul`, the
model's ``linear`` and experts' products, :func:`moe_positions`, the MoE
layer's position-in-expert count, and :func:`moe_combine`, its combine,
are the port's own: on the TPU XLA's ``dot``, ``cumsum`` and gather
took them.
"""
from __future__ import annotations

import torch

from repro_torch import is_dtensor
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM,
                                                 flash_attention_bhsd)
from repro_torch.kernels.gemm import BM, gemm, gemm_ref, kernel_ready
from repro_torch.kernels.grad_agg import grad_agg_reduce
from repro_torch.kernels.moe_combine import MAX_K as COMBINE_MAX_K
from repro_torch.kernels.moe_combine import moe_combine as combine_rows
from repro_torch.kernels.moe_combine import moe_combine_grad, moe_combine_ref
from repro_torch.kernels.moe_count import MAX_E as COUNT_MAX_E
from repro_torch.kernels.moe_count import moe_positions as count_positions
from repro_torch.kernels.moe_count import moe_positions_ref
from repro_torch.kernels.paged_attention import paged_attention_decode
from repro_torch.kernels.quantize import dequant_agg_reduce, quantize_pack
from repro_torch.kernels.ssd_scan import ssd_intra_chunk


def flash_attention(q, k, v, window=None):
    """Causal (and, with ``window``, sliding-window) attention. q: (B, S,
    Hq, D), k/v: (B, T, Hkv, D) -- model layout (BSHD). Returns (B, S, Hq,
    D) in q's dtype; the kernel computes in float32.

    The reference zero-pads a head_dim outside {64, 128} to 128, the TPU's
    lane width, with q scaled by sqrt(128 / D) so the scores stay the
    same; the Hopper kernel takes any head_dim up to 128 as it is, which
    is the same function. head_dim > 128 raises, as in the reference."""
    D = q.shape[-1]
    if D > MAX_HEAD_DIM:
        raise NotImplementedError(f"flash attention takes head_dim <= "
                                  f"{MAX_HEAD_DIM}, got {D}")

    def bhsd(t):
        return t.transpose(1, 2).to(torch.float32).contiguous()

    out = flash_attention_bhsd(bhsd(q), bhsd(k), bhsd(v), window)
    return out.transpose(1, 2).to(q.dtype)


def paged_attention(q, pages_k, pages_v, page_table, lengths):
    """Batched single-token decode over a paged KV cache.

    q: (slots, Hq, D), one query token per slot in the model's head
    layout; pages_k/pages_v: (Hkv, num_pages, page_size, D); page_table:
    (slots, max_pages) int32; lengths: (slots,) int32 including the
    just-written token. Returns (slots, Hq, D).

    The reference pads the GQA group G to the TPU's 8-row sublane tile;
    the Hopper kernel shares each K/V page across the G rows of a kv head
    and takes G as it is, so nothing is padded here."""
    slots, Hq, D = q.shape
    Hkv = pages_k.shape[0]
    qg = q.reshape(slots, Hkv, Hq // Hkv, D).contiguous()
    out = paged_attention_decode(qg, pages_k, pages_v, page_table, lengths)
    return out.reshape(slots, Hq, D)


def ssd(x, dt, A, B, C, chunk: int, initial_state=None):
    """Full SSD: the intra-chunk kernel (B5) + the inter-chunk recurrence
    in plain PyTorch, as the reference runs it in jnp.

    x: (b, s, h, p), dt: (b, s, h), A: (h,), B/C: (b, s, g, n), s a
    multiple of ``chunk``; initial_state (b, h, p, n) or None. Returns
    (y (b, s, h, p) in x's dtype, final_state (b, h, p, n) float32). Its
    plain counterpart is ``models.ssm.ssd_chunked``. B and C go to the
    kernel per group, not expanded to every head."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    c = s // chunk
    dtf = dt.float()
    xdt = x.float() * dtf[..., None]
    dA = dtf * A.float()

    def chunked(t, width):  # (b, s, k, width) -> (b, k, c, chunk, width)
        return t.float().reshape(b, c, chunk, -1, width).permute(
            0, 3, 1, 2, 4).contiguous()

    xdt_c = chunked(xdt, p)
    dA_c = dA.reshape(b, c, chunk, h).permute(0, 3, 1, 2).contiguous()
    B_c, C_c = chunked(B, n), chunked(C, n)
    y_diag, states = ssd_intra_chunk(xdt_c, dA_c, B_c, C_c)

    # inter-chunk recurrence (c is small)
    A_cs = torch.cumsum(dA_c, dim=-1)                       # (b, h, c, Q)
    decay = torch.exp(A_cs[..., -1])                        # (b, h, c)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prevs = []
    for ci in range(c):
        prevs.append(state)
        state = state * decay[:, :, ci, None, None] + states[:, :, ci]
    prev = torch.stack(prevs, dim=2).reshape(b, g, h // g, c, p, n)

    # off-diagonal: y_off[q] = C[q] @ prev_state * exp(A_cs[q])
    y_off = torch.einsum("bgcqn,bgrcpn->bgrcqp", C_c, prev).reshape(
        b, h, c, chunk, p) * torch.exp(A_cs)[..., None]
    y = (y_diag + y_off).permute(0, 2, 3, 1, 4).reshape(b, s, h, p)
    return y.to(x.dtype), state


def grad_agg(g, rho):
    """sum_n rho_n g_n over the client axis (eq. 5). g: (N, T, D) or
    (N, B, S, D) -- any (N, ...) works; returns g.shape[1:]."""
    return grad_agg_reduce(g.contiguous(), rho.contiguous())


def _ntd(g):
    """(N, B, S, D) -> (N, B*S, D); (N, T, D) as it is."""
    if g.dim() == 4:
        return g.reshape(g.shape[0], g.shape[1] * g.shape[2], g.shape[3])
    return g


def quantize(g, seed=0, bits: int = 8, block_t: int = 256,
             block_d: int = 256, stochastic: bool = True, client_seeds=None):
    """Per-client per-tile symmetric quantization of (N, T, D) or
    (N, B, S, D) smashed data. Returns (q int8 payload, scales f32);
    ``bits=4`` packs two values per int8 word. The (block_t, block_d)
    tiling is the on-wire scale granularity; the matching
    :func:`dequant_agg` must use the same one. ``client_seeds``: see
    ``kernels.quantize.quantize_pack``."""
    return quantize_pack(_ntd(g).contiguous(), seed, bits, block_t, block_d,
                         stochastic, client_seeds)


def dequant_agg(q, scales, rho, bits: int = 8, block_t: int = 256,
                block_d: int = 256):
    """Fused decode + eq. 5 reduce of N quantized payloads. Returns
    (T, D) f32."""
    return dequant_agg_reduce(q.contiguous(), scales.contiguous(),
                              rho.contiguous(), bits, block_t, block_d)


def _admits(rows, *others) -> bool:
    """The terms every rule shares: ``rows`` (the operand whose rows the
    kernel reads) on the card, no dispatch mode and no DTensor among the
    operands, also through ``vmap``. The device is read on ``rows`` only;
    each rule adds its own dtypes and layouts."""
    return (rows.is_cuda and not torch._C._len_torch_dispatch_stack()
            and not any(is_dtensor(t, through_vmap=True)
                        for t in (rows, *others)))


def takes_kernel(x, w) -> bool:
    """The rule of :func:`matmul`, on what it can see of its operands: a
    float32 product on the card with at least one output tile of rows
    (``gemm.BM``), contiguous operands and rows of whole 16-byte words
    goes to G1. A batch of weights w (B, K, N) takes x (B, M, K) of the
    same batch, with a tile of rows in each product (M >= ``gemm.BM``).
    Everything else stays on ``torch.matmul`` (``torch.bmm`` for a batch
    of weights): the CPU, bf16/f16, decode-sized row counts, other
    layouts, DTensors, and any run under a dispatch mode (fake tensors,
    FLOP counters), which can see aten products and not the kernel."""
    if not (w.dim() in (2, 3) and x.dim() >= 2 and x.dtype == torch.float32
            and w.dtype == torch.float32 and x.is_contiguous()
            and _admits(x, w)):
        return False
    K, N = w.shape[-2:]
    if w.dim() == 3 and not (x.dim() == 3 and x.shape[0] == w.shape[0]
                             and x.shape[1] >= BM):
        return False
    return (x.shape[-1] == K and K % 4 == 0 and N % 4 == 0 and K > 0
            and x.numel() >= BM * K and w.is_contiguous())


def _product(a, b, form):
    """One product of G1's forms: the kernel where both operands are laid
    out as it reads them (on the card; the plain version on the CPU),
    else ``torch.matmul``, counted in ``gemm.passed``."""
    if a.device.type == "cpu" or (kernel_ready(a) and kernel_ready(b)):
        return gemm(a, b, form)
    gemm.passed += 1
    return gemm_ref(a, b, form)


class _Matmul(torch.autograd.Function):
    """x @ w through G1: the forward Y = X W and the backward's dX = dY
    W^T and dW = X^T dY, each one launch. w is (K, N), the rows of x
    (..., K) folded into M, or (B, K, N) with x (B, M, K). The ``vmap``
    rule maps per-client weights to the kernel's batch axis (clients x B
    of them where each client holds a batch) and folds the clients into
    M where one weight is shared; a shared batch of weights takes
    ``torch.matmul``, counted in ``gemm.passed``."""

    @staticmethod
    def forward(x, w):
        if w.dim() == 3:
            return _product(x, w, "y")
        y = _product(x.reshape(-1, x.shape[-1]), w, "y")
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if w.dim() == 3:
            if ctx.needs_input_grad[0]:
                dx = _product(dy, w, "dx")
            if ctx.needs_input_grad[1]:
                dw = _product(x, dy, "dw")
            return dx, dw
        dy2 = dy.reshape(-1, w.shape[-1])
        if ctx.needs_input_grad[0]:
            dx = _product(dy2, w, "dx").reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = _product(x.reshape(-1, x.shape[-1]), dy2, "dw")
        return dx, dw

    @staticmethod
    def vmap(info, in_dims, x, w):
        xd, wd = in_dims
        n = info.batch_size
        x = x.movedim(xd, 0) if xd is not None else x.expand(n, *x.shape)
        if wd is None and w.dim() == 3:  # one batch for every client
            if x.is_cuda:
                gemm.passed += 1
            return torch.matmul(x, w), 0
        if wd is None:  # one weight for every client: clients fold into M
            return _Matmul.apply(x, w), 0
        w = w.movedim(wd, 0)
        wb = w.reshape(-1, *w.shape[-2:])  # clients (x B) on the batch axis
        y = _Matmul.apply(x.reshape(wb.shape[0], -1, x.shape[-1]), wb)
        return y.reshape(*x.shape[:-1], w.shape[-1]), 0


def matmul(x, w):
    """``x @ w`` for the model's ``linear``, x (..., K) and w (K, N), and
    for the MoE layer's experts, x (B, M, K) and a batch of weights w (B,
    K, N). Where :func:`takes_kernel` holds it runs on G1
    (``kernels/gemm.py``), the backward too, under ``torch.func.vmap``
    and checkpoints alike; otherwise it is ``x @ w``, or ``torch.bmm(x,
    w)`` for a batch of weights, as it was, the CPU's bit for bit. On
    the card ``gemm.launches`` counts the kernel's products and
    ``gemm.passed`` those left on ``torch.matmul`` or ``torch.bmm``."""
    if takes_kernel(x, w):
        return _Matmul.apply(x, w)
    if x.is_cuda:
        gemm.passed += 1
    return torch.bmm(x, w) if w.dim() == 3 else x @ w


def count_takes_kernel(ids, E: int) -> bool:
    """The rule of :func:`moe_positions`, on what it can see of the
    expert ids ``ids`` and the expert count ``E``: int64 ids on the card,
    1 <= E <= ``COUNT_MAX_E`` and fewer than 2^31 pairs go to M2, in any
    layout (the op flattens them, as the earlier expression did: the
    router's top-k ids are a strided view). Everything else stays on the
    earlier one-hot ``cumsum``: the CPU, other dtypes, DTensors (also
    through ``vmap``: the dry run), and any run under a dispatch mode
    (fake tensors, FLOP counters, op recorders), which can see aten ops
    and not the kernel."""
    return (ids.dtype == torch.int64 and 1 <= E <= COUNT_MAX_E
            and ids.numel() < 2 ** 31 and _admits(ids))


class _Positions(torch.autograd.Function):
    """M2's count, positions of integer ids (no gradient). The ``vmap``
    rule folds the clients into one count: client b's ids move by b E
    over n E experts, so each client counts only its own pairs, in its
    own order, as under the reference's ``jax.vmap``."""

    @staticmethod
    def forward(ids, E):
        return count_positions(ids, E)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, ids, E):
        n = info.batch_size
        ids = ids.movedim(in_dims[0], 0)
        off = torch.arange(n, device=ids.device).view(
            n, *[1] * (ids.dim() - 1)) * E
        return moe_positions(ids + off, n * E), 0


def moe_positions(ids, E: int):
    """The MoE layer's position-in-expert count: ``ids`` (T, k) int64,
    each (token, choice)'s expert among ``E``; returns (T, k) int32, each
    pair's position among the earlier pairs (token-major, choice-minor)
    routed to the same expert.

    Where :func:`count_takes_kernel` holds it runs on M2
    (``kernels/moe_count.py``) over the flattened ids (a copy where they
    are strided, as before), one launch a call, under
    ``torch.func.vmap`` (the clients folded into one launch) and
    checkpoints alike. Otherwise it is the earlier expression op for op:
    the (T k, E) int32 one-hot, ``cumsum`` over dim 0, minus 1, each
    pair's own column gathered. Both give the same integers. On the card
    ``moe_positions.launches`` of ``kernels/moe_count.py`` counts M2's
    launches and ``moe_positions.passed`` the counts left on the plain
    version."""
    if count_takes_kernel(ids, E):
        return _Positions.apply(ids.reshape(-1), E).view(ids.shape)
    if ids.is_cuda:
        count_positions.passed += 1
    return moe_positions_ref(ids, E)


def combine_takes_kernel(ye, gates) -> bool:
    """The rule of :func:`moe_combine`, on what it can see of the expert
    products' output ``ye`` (..., d) and a group's ``gates`` (T, k):
    float32 on the card, rows of whole 16-byte words, ``ye`` contiguous
    and at most ``COMBINE_MAX_K`` choices go to M1. Everything else stays
    on the earlier gather and ``einsum``: the CPU, other dtypes, DTensors
    (also through ``vmap``: the dry run), and any run under a dispatch
    mode (fake tensors, FLOP counters, op recorders), which can see aten
    ops and not the kernel."""
    if not (ye.dim() >= 2 and ye.dtype == torch.float32
            and gates.dtype == torch.float32 and ye.is_contiguous()
            and _admits(ye, gates)):
        return False
    d = ye.shape[-1]
    return d > 0 and d % 4 == 0 and gates.shape[-1] <= COMBINE_MAX_K


class _Combine(torch.autograd.Function):
    """M1's combine over (R, d) rows: y = the kept rows of each token
    weighted by its gates; the backward is M1's, dye and dgates in one
    pass over the rows. The ``vmap`` rule folds the clients into rows:
    client b's slots move by b R (the slack R becomes B R) and its
    tokens follow client b - 1's."""

    @staticmethod
    def forward(ye, slot, gates):
        return combine_rows(ye, slot, gates)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        ye, slot, gates = ctx.saved_tensors
        dye, dgates = moe_combine_grad(dy.contiguous(), ye, slot, gates)
        return (dye if ctx.needs_input_grad[0] else None, None,
                dgates if ctx.needs_input_grad[2] else None)

    @staticmethod
    def vmap(info, in_dims, ye, slot, gates):
        n = info.batch_size
        ye, slot, gates = (t.movedim(dim, 0) if dim is not None
                           else t.expand(n, *t.shape)
                           for t, dim in zip((ye, slot, gates), in_dims))
        R, d = ye.shape[1:]
        T, k = slot.shape[1:]
        off = torch.arange(n, device=slot.device).view(n, 1, 1) * R
        rows = torch.where(slot < R, slot + off, n * R)
        y = _Combine.apply(ye.reshape(n * R, d), rows.reshape(n * T, k),
                           gates.reshape(n * T, k).contiguous())
        return y.reshape(n, T, d), 0


def moe_combine(ye, slots, gates, keeps):
    """The MoE layer's combine: ``ye`` (held, G Cg, d), the expert
    products' output, expert-major; ``slots``, ``gates`` and ``keeps``
    one (Tg, k) each a routing group, a slot indexing the group's (held
    Cg) rows with the slack ``held Cg`` for a pair not kept. Returns the
    (G Tg, d) sum of each token's kept rows weighted by its gates.

    Where :func:`combine_takes_kernel` holds it runs on M1
    (``kernels/moe_combine.py``), one launch over every group, the
    backward too, under ``torch.func.vmap`` and checkpoints alike: the
    slots index ``ye``'s rows directly and no zero row is appended.
    Otherwise it is the earlier expression op for op, group by group: a
    zero row appended, ``flat[slot]`` and the ``einsum`` over the gates
    times the kept mask. On the card ``moe_combine.launches`` of
    ``kernels/moe_combine.py`` counts M1's launches and
    ``moe_combine.passed`` the combines left on the plain version."""
    n, GC, d = ye.shape
    G = len(slots)
    Cg = GC // G
    if combine_takes_kernel(ye, gates[0]):
        R = n * GC
        if G == 1:  # the group's slots are ye's rows, the slack is R
            slot, gate = slots[0], gates[0]
        else:
            slot = torch.cat([torch.where(keep, s // Cg * GC + g * Cg
                                          + s % Cg, R)
                              for g, (s, keep) in enumerate(zip(slots,
                                                                keeps))])
            gate = torch.cat(gates)
        return _Combine.apply(ye.reshape(R, d), slot.contiguous(),
                              gate.contiguous())
    if ye.is_cuda:
        combine_rows.passed += 1
    ye_g = ye.reshape(n, G, Cg, d)
    zero = torch.zeros((1, d), dtype=ye.dtype, device=ye.device)
    ys = [moe_combine_ref(ye_g[:, g].reshape(n * Cg, d), slot, gate, keep,
                          zero)
          for g, (slot, gate, keep) in enumerate(zip(slots, gates, keeps))]
    return torch.cat(ys, 0)
