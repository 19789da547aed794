"""Public wrappers around the port's kernels, in the model's layouts.

Counterpart of ``repro.kernels.ops``. There is no backend switch: the
tensor's device decides (the plain version on the CPU, the Hopper kernel
on the card), as each kernel's wrapper documents.
"""
from __future__ import annotations

from repro_torch.kernels.grad_agg import grad_agg_reduce
from repro_torch.kernels.paged_attention import paged_attention_decode
from repro_torch.kernels.quantize import dequant_agg_reduce, quantize_pack


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
