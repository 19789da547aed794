"""Public wrappers around the port's kernels, in the model's layouts.

Counterpart of ``repro.kernels.ops``. There is no backend switch: the
tensor's device decides (the plain version on the CPU, the Hopper kernel
on the card), as each kernel's wrapper documents.
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention import paged_attention_decode


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
