"""Public wrappers around the port's kernels, in the model's layouts.

Counterpart of ``repro.kernels.ops``. There is no backend switch: the
tensor's device decides (the plain version on the CPU, the Hopper kernel
on the card), as each kernel's wrapper documents.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM,
                                                 flash_attention_bhsd)
from repro_torch.kernels.grad_agg import grad_agg_reduce
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
