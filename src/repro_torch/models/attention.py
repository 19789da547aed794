"""GQA attention with RoPE: projections, training and prefill attention,
and the dense cache.

Port of ``repro.models.attention``: the q/k/v projections with RoPE,
full-sequence causal attention for the split LM's forward
(``attend_train``: the flash kernel B4 with ``impl="flash"``, the
masked softmax with ``impl="jnp"``), exact-length causal prefill
attention (query-chunked above a threshold, as in the reference), and
the prefill's dense ``KVCache``, whose rows the server scatters into its
paged pool. The serve engine's one-token decode runs over the paged
cache (``models.paging``); ``attend_decode`` is the reference's dense
one-token decode (``lm.decode_step``). Softcaps are carried as the
reference has them. A sliding-window model's dense cache is a ring of
``min(max_len, window)`` rows laid out by ``position % capacity``, so a
stream of any length decodes in O(window) memory; paged serving is
full-causal only, and sliding-window models serve through
``lm.prefill``/``lm.decode_step``. Under M-RoPE a decode position is
broadcast to the three (t, h, w) planes.

The encoder-decoder (``models.encdec``) takes two more forms, as the
reference computes them: bidirectional attention (``causal=False``, the
unmasked softmax, and no RoPE when ``positions`` is None) and
cross-attention, whose keys and values are projected from the encoder's
states (``cross_kv_x``; RoPE, if any, on the queries only). In decode a
cross step reads the projected encoder KV (``attend_decode(...,
cross=True)``) and returns the cache unchanged. Kernel B4 is causal
only, so ``impl="flash"`` reaches it for causal self-attention alone.

A NoPE model (``cfg.position_embedding == "nope"``) takes no RoPE on
any path, and ``cfg.attention_multiplier``, when set, is the softmax's
scale in place of 1/sqrt(D); B4 computes neither, so ``impl="flash"``
refuses such a model.

Multi-head latent attention (``cfg.is_mla``; Kimi K2's, DeepSeek-V3's)
trains through ``attend_train`` alone: q = q_b(rmsnorm(q_a(x))); one
kv_a(x) gives the kv latent and a rope key of one head; k's and v's
heads are kv_b(rmsnorm(latent)); each q and k head is its nope part and
its rope part (interleaved pairs, ``blocks.apply_rope_interleaved``),
the rope key broadcast to every head; the masked softmax then runs at
the q.k width with v at its own width (``_sdpa``). Under YaRN
(``cfg.yarn``) RoPE takes YaRN's frequencies and the softmax scale its
mscale (``softmax_scale``). Each forward opens
the ``obs`` span ``mla`` (projections, norms, RoPE, ``wo``) and inside
it ``mla_scores`` (scores, softmax, values); under remat both open
again in the backward's recompute. B4, B6, the dense caches and the
serve engine compute grouped-query heads only and refuse it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.blocks import (apply_rope, apply_rope_interleaved,
                                       init_linear, init_rmsnorm, linear,
                                       rmsnorm, rope_sin_cos)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, C, Hkv, D) -- C = capacity (max_len or window)
    v: torch.Tensor  # (B, C, Hkv, D)
    # tokens ever written; with a window the ring row of position p is
    # p % C
    length: int


def init_attention(gen, cfg: ModelConfig, dtype=torch.float32, device="cpu"):
    if cfg.is_mla:
        return init_mla(gen, cfg, dtype, device)
    hd = cfg.resolved_head_dim
    d, hq, hkv = cfg.d_model, cfg.num_heads * hd, cfg.num_kv_heads * hd
    p = {
        "wq": init_linear(gen, d, hq, cfg.attn_bias, dtype, device),
        "wk": init_linear(gen, d, hkv, cfg.attn_bias, dtype, device),
        "wv": init_linear(gen, d, hkv, cfg.attn_bias, dtype, device),
        "wo": init_linear(gen, hq, d, False, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, device)
        p["k_norm"] = init_rmsnorm(hd, dtype, device)
    return p


def init_mla(gen, cfg: ModelConfig, dtype=torch.float32, device="cpu"):
    """MLA's leaves: the q and kv down-projections (kv_a's output is the
    latent and the shared rope key), their latents' RMSNorms, the
    up-projections (kv_b's output a head's k nope part, then its v), and
    ``wo``."""
    d, H = cfg.d_model, cfg.num_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "q_a": init_linear(gen, d, qr, False, dtype, device),
        "q_a_norm": init_rmsnorm(qr, dtype, device),
        "q_b": init_linear(gen, qr, H * qk, False, dtype, device),
        "kv_a": init_linear(gen, d, kvr + cfg.qk_rope_head_dim, False, dtype,
                            device),
        "kv_a_norm": init_rmsnorm(kvr, dtype, device),
        "kv_b": init_linear(gen, kvr, H * (cfg.qk_nope_head_dim
                                           + cfg.v_head_dim), False, dtype,
                            device),
        "wo": init_linear(gen, H * cfg.v_head_dim, d, False, dtype, device),
    }


def softmax_scale(cfg: ModelConfig) -> float:
    """MLA's scores' scale: under YaRN with ``yarn_mscale_all_dim``, (q.k
    width)^-1/2 x mscale^2; else 0, which ``_sdpa`` reads as 1/sqrt(q.k
    width)."""
    if cfg.yarn is not None and cfg.yarn_mscale_all_dim:
        m = 0.1 * cfg.yarn_mscale_all_dim * math.log(cfg.yarn_factor) + 1.0
        return m * m / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    return 0.0


def _project_mla(params, cfg: ModelConfig, x, positions):
    """x: (B, S, d) -> q, k (B, S, H, nope + rope), v (B, S, H, v width):
    MLA's projections, with RoPE on the rope parts at ``positions``."""
    B, S = x.shape[:2]
    H, nope, rope = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = linear(params["q_b"], rmsnorm(params["q_a_norm"],
                                      linear(params["q_a"], x),
                                      cfg.norm_eps)).reshape(B, S, H, -1)
    latent, k_rope = linear(params["kv_a"], x).split(
        [cfg.kv_lora_rank, rope], dim=-1)
    kv = linear(params["kv_b"], rmsnorm(params["kv_a_norm"], latent,
                                        cfg.norm_eps)).reshape(B, S, H, -1)
    k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
    sin, cos = rope_sin_cos(positions, rope, cfg.rope_theta, yarn=cfg.yarn)
    q = torch.cat([q[..., :nope],
                   apply_rope_interleaved(q[..., nope:], sin, cos)], dim=-1)
    k_rope = apply_rope_interleaved(k_rope[:, :, None, :], sin, cos)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rope)], dim=-1)
    return q, k, v


def _attend_mla(params, cfg: ModelConfig, x, positions):
    with obs.span("mla"):
        q, k, v = _project_mla(params, cfg, x, positions)
        with obs.span("mla_scores"):
            out = _maybe_chunked_causal(q, k, v, cfg.sliding_window,
                                        cfg.logit_softcap, softmax_scale(cfg))
        B, S = x.shape[:2]
        return linear(params["wo"], out.reshape(B, S, -1))


def _project_qkv(params, cfg: ModelConfig, x, positions, cross_kv_x=None):
    """x: (B, S, d) -> q (B, S, Hq, D), k/v (B, T, Hkv, D). K and V come
    from ``cross_kv_x`` (B, T, d) when given, else from x (T = S). RoPE
    is applied when ``positions`` is given and the model has RoPE: to q
    and k, or under a cross source to q only. Grouped-query heads only:
    an MLA model raises."""
    if cfg.is_mla:
        raise ValueError(f"{cfg.name}: multi-head latent attention trains "
                         f"through attend_train only; the dense and paged "
                         f"caches hold grouped-query heads")
    B, S = x.shape[:2]
    hd = cfg.resolved_head_dim
    src = x if cross_kv_x is None else cross_kv_x
    T = src.shape[1]
    q = linear(params["wq"], x).reshape(B, S, cfg.num_heads, hd)
    k = linear(params["wk"], src).reshape(B, T, cfg.num_kv_heads, hd)
    v = linear(params["wv"], src).reshape(B, T, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if positions is not None and cfg.position_embedding == "rope":
        sin, cos = rope_sin_cos(positions, hd, cfg.rope_theta,
                                cfg.mrope_sections)
        q = apply_rope(q, sin, cos)
        if cross_kv_x is None:
            k = apply_rope(k, sin, cos)
    return q, k, v


def _sdpa(q, k, v, mask, logit_softcap: float = 0.0, scale: float = 0.0):
    """q: (B,S,Hq,D), k: (B,T,Hkv,D), v: (B,T,Hkv,Dv) (Dv = D but under
    MLA); mask: (B,S,T) or (S,T) bool or None. Returns (B,S,Hq,Dv). The
    scores are scaled by ``scale``, or divided by sqrt(D) when it is 0
    (``cfg.attention_multiplier``, or MLA's ``softmax_scale``)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, S, Hkv, G, D).to(torch.float32)
    kf = k.to(torch.float32)
    scores = torch.einsum("bshgd,bthd->bhgst", qf, kf)
    scores = scores * scale if scale else scores / math.sqrt(D)
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        scores = torch.where(mask[:, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", w.to(v.dtype), v)
    return out.reshape(B, S, Hq, v.shape[-1])


# Above this query length prefill processes queries in blocks (exact math,
# O(block x T) live scores instead of O(S x T)), as the reference does.
Q_CHUNK_THRESHOLD = 8192
Q_CHUNK_BLOCK = 2048


def causal_mask(S: int, T: int, offset: int = 0,
                window: Optional[int] = None, device="cpu"):
    """(S, T) bool; query i attends key j iff j <= i+offset and within window."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m


def _maybe_chunked_causal(q, k, v, window, logit_softcap, scale=0.0):
    S, T = q.shape[1], k.shape[1]
    if S == T and S >= Q_CHUNK_THRESHOLD and S % Q_CHUNK_BLOCK == 0:
        outs = [_sdpa(q[:, i:i + Q_CHUNK_BLOCK], k, v,
                      causal_mask(Q_CHUNK_BLOCK, T, i, window, q.device),
                      logit_softcap, scale)
                for i in range(0, S, Q_CHUNK_BLOCK)]
        return torch.cat(outs, dim=1)
    return _sdpa(q, k, v, causal_mask(S, T, window=window, device=q.device),
                 logit_softcap, scale)


def attend_train(params, cfg: ModelConfig, x, positions, impl: str = "jnp",
                 causal: bool = True, cross_kv_x=None):
    """Full-sequence attention. x: (B, S, d). Causal (or sliding-window)
    self-attention by default: ``impl="flash"`` runs kernel B4
    (``kernels.ops.flash_attention``; its plain version on the CPU) and,
    like the reference's flash branch, applies no ``logit_softcap``;
    ``impl="jnp"`` is the masked softmax. ``causal=False`` (the encoder)
    or a ``cross_kv_x`` (the decoder's cross-attention) is the unmasked
    softmax under either ``impl``, as in the reference. ``impl="flash"``
    refuses a NoPE, rescaled or MLA model
    (``cfg.attention_is_reference``). An MLA model is causal
    self-attention only."""
    if impl not in ("jnp", "flash"):
        raise ValueError(f"impl must be 'jnp' or 'flash', got {impl!r}")
    if impl == "flash" and not cfg.attention_is_reference:
        raise ValueError(f"{cfg.name}: kernel B4 computes RoPE attention "
                         f"at 1/sqrt(head_dim) over grouped-query heads; "
                         f"this model sets {cfg.port_fields_set()}: use "
                         f"impl='jnp'")
    if cfg.is_mla:
        if not causal or cross_kv_x is not None:
            raise ValueError(f"{cfg.name}: multi-head latent attention is "
                             f"causal self-attention only")
        return _attend_mla(params, cfg, x, positions)
    q, k, v = _project_qkv(params, cfg, x, positions, cross_kv_x)
    scale = cfg.attention_multiplier
    if causal and cross_kv_x is None:
        if impl == "flash":
            out = kops.flash_attention(q, k, v, window=cfg.sliding_window)
        else:
            out = _maybe_chunked_causal(q, k, v, cfg.sliding_window,
                                        cfg.logit_softcap, scale)
    else:
        out = _sdpa(q, k, v, None, logit_softcap=cfg.logit_softcap,
                    scale=scale)
    B, S = x.shape[:2]
    return linear(params["wo"], out.reshape(B, S, -1))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cpu") -> KVCache:
    """Empty dense cache of ``max_len`` rows, or of the window's when it
    is smaller."""
    cap = max_len if cfg.sliding_window is None else min(
        max_len, cfg.sliding_window)
    hd = cfg.resolved_head_dim
    z = torch.zeros((batch, cap, cfg.num_kv_heads, hd), dtype=dtype,
                    device=device)
    return KVCache(z, torch.zeros_like(z), 0)


def attend_decode(params, cfg: ModelConfig, x, cache: KVCache,
                  cross: bool = False):
    """One-token decode against the dense cache. x: (B, 1, d). Returns
    (y, new_cache); the new token (position ``length``) lands in row
    ``length % C``. With a sliding window the ring keeps exactly the last
    C positions, and every written row is attended: the rows are laid
    out by position, not by order, and the softmax over them does not
    care. Without one a full cache raises. With ``cross`` the cache is
    the projected encoder KV: the query (no RoPE) attends all of it, and
    the cache comes back unchanged."""
    B, pos = x.shape[0], cache.length
    if cross:
        q, _, _ = _project_qkv(params, cfg, x, None)
        out = _sdpa(q, cache.k, cache.v, None,
                    logit_softcap=cfg.logit_softcap,
                    scale=cfg.attention_multiplier)
        return linear(params["wo"], out.reshape(B, 1, -1)), cache
    cap = cache.k.shape[1]
    if cfg.sliding_window is None and pos >= cap:
        raise ValueError(f"cache of capacity {cap} is full")
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections:
        positions = positions[None].expand(3, B, 1)
    q, k, v = _project_qkv(params, cfg, x, positions)
    slot = pos % cap
    new_k, new_v = cache.k.clone(), cache.v.clone()
    new_k[:, slot] = k[:, 0]
    new_v[:, slot] = v[:, 0]
    valid = torch.arange(cap, device=x.device) <= min(pos, cap - 1)
    mask = valid[None, None, :].expand(B, 1, cap)
    out = _sdpa(q, new_k, new_v, mask, logit_softcap=cfg.logit_softcap,
                scale=cfg.attention_multiplier)
    return (linear(params["wo"], out.reshape(B, 1, -1)),
            KVCache(new_k, new_v, pos + 1))


def attend_prefill(params, cfg: ModelConfig, x, positions, max_len: int):
    """Full-sequence causal (or windowed) attention that also returns the
    dense cache (``init_cache``'s rows) for later decode.
    A prompt of at least C tokens leaves its last C keys in the ring,
    each at row ``position % C``. Returns (y, KVCache)."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = _maybe_chunked_causal(q, k, v, cfg.sliding_window, cfg.logit_softcap,
                                cfg.attention_multiplier)
    B, S = x.shape[:2]
    if cfg.sliding_window is None and S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds cache capacity "
                         f"{max_len}")
    cap = max_len if cfg.sliding_window is None else min(
        max_len, cfg.sliding_window)
    # the cache's rows, fresh (a roll of the last C, or a zero pad):
    # row p % C holds position p
    def ring(t):
        if S >= cap:
            return torch.roll(t[:, S - cap:], (S - cap) % cap, dims=1)
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, cap - S))

    return (linear(params["wo"], out.reshape(B, S, -1)),
            KVCache(ring(k), ring(v), S))


def mla_param_numel(cfg: ModelConfig) -> int:
    """Elements of ``init_mla``'s leaves."""
    H, qr, kvr = cfg.num_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return cfg.d_model * (qr + kvr + cfg.qk_rope_head_dim) + qr + kvr \
        + qr * H * qk + kvr * H * (cfg.qk_nope_head_dim + cfg.v_head_dim) \
        + H * cfg.v_head_dim * cfg.d_model


def attn_flops_per_token(cfg: ModelConfig, context: int) -> int:
    """Projections + score/value matmuls at a given context length."""
    ctx = min(context, cfg.sliding_window) if cfg.sliding_window else context
    if cfg.is_mla:
        norms = cfg.q_lora_rank + cfg.kv_lora_rank
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return 2 * (mla_param_numel(cfg) - norms) \
            + 2 * cfg.num_heads * ctx * (qk + cfg.v_head_dim)
    hd = cfg.resolved_head_dim
    proj = 2 * cfg.d_model * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    sdp = 2 * 2 * cfg.num_heads * hd * ctx
    return proj + sdp
