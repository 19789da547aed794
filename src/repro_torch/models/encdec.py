"""Whisper-style encoder-decoder (audio backbone).

Port of ``repro.models.encdec``. The mel+conv frontend is a stub, as in
the reference: callers provide precomputed frame embeddings (B,
num_frames, d_model). This module is the transformer that consumes them:
a bidirectional encoder (no RoPE) and a causal decoder (RoPE on its
self-attention) with cross-attention over the encoder's states. The
reference is followed in its own choices, not the Whisper paper's: RMSNorm
everywhere, no learned decoder positions, a learned encoder position
table (``enc_pos``), tied embeddings.

SFL split: the encoder, the embedding and the first ``cut`` decoder
layers are client-side, so two tensors cross the wire in split
training: the decoder's residual after ``dec_layers[:cut]`` and the
encoder's states (``whisper_client_forward``). The server holds the rest
of the decoder and an untied head.

Parameter trees are the reference's nested dicts and lists, with no
layer grouping, so ``convert.whisper_from_jax`` changes no layout.
``dtype`` defaults to float32, where the reference defaults to bf16.
Serving runs on the port's dense ``KVCache`` (``attention``) plus a static
cross KV a decoder layer (``DecLayerCache``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import require_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.blocks import (_normal, embed, init_embedding,
                                       init_linear, init_mlp, init_rmsnorm,
                                       linear, mlp, rmsnorm, unembed)


class DecLayerCache(NamedTuple):
    self_kv: attn_mod.KVCache
    cross_kv: attn_mod.KVCache  # projected encoder KV; never updated


def _init_enc_layer(gen, cfg: ModelConfig, dtype, device):
    return {
        "norm1": init_rmsnorm(cfg.d_model, dtype, device),
        "attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "norm2": init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                        cfg.mlp_bias, dtype, device),
    }


def _init_dec_layer(gen, cfg: ModelConfig, dtype, device):
    return {
        "norm1": init_rmsnorm(cfg.d_model, dtype, device),
        "self_attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "norm_x": init_rmsnorm(cfg.d_model, dtype, device),
        "cross_attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "norm2": init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                        cfg.mlp_bias, dtype, device),
    }


def _init(gen, cfg: ModelConfig, dtype, device):
    enc = cfg.encoder
    return {
        "enc_pos": _normal((enc.num_frames, cfg.d_model), gen, device, 0.02,
                           dtype),
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype,
                                device),
        "enc_layers": [_init_enc_layer(gen, cfg, dtype, device)
                       for _ in range(enc.num_layers)],
        "dec_layers": [_init_dec_layer(gen, cfg, dtype, device)
                       for _ in range(cfg.num_layers)],
        "enc_norm": init_rmsnorm(cfg.d_model, dtype, device),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }


def init_whisper(seed: int, cfg: ModelConfig, dtype=torch.float32,
                 device="cuda"):
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``: the reference's distributions, not jax's bits
    (``convert.whisper_from_jax`` carries the reference's own over)."""
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return _init(gen, cfg, dtype, dev)


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32,
                        device=device)[None, :].expand(B, S)


def encode(params, cfg: ModelConfig, frame_embeds):
    """frame_embeds: (B, F, d) precomputed (stub frontend)."""
    x = frame_embeds + params["enc_pos"].to(frame_embeds.dtype)[None]
    for p in params["enc_layers"]:
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        x = x + attn_mod.attend_train(p["attn"], cfg, h, None, causal=False)
        x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps),
                    cfg.mlp_act)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer_train(p, cfg: ModelConfig, x, enc_out, positions):
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + attn_mod.attend_train(p["self_attn"], cfg, h, positions)
    h = rmsnorm(p["norm_x"], x, cfg.norm_eps)
    x = x + attn_mod.attend_train(p["cross_attn"], cfg, h, None,
                                  causal=False, cross_kv_x=enc_out)
    return x + mlp(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps),
                   cfg.mlp_act)


def whisper_forward(params, cfg: ModelConfig, frame_embeds, dec_tokens,
                    cut: int = 0, boundary_fn=None, dtype=torch.float32):
    """Training forward. Returns logits (B, S, vocab).

    ``cut`` splits the decoder: the encoder and ``dec_layers[:cut]`` are
    client-side; ``boundary_fn`` wraps the decoder's residual there."""
    enc_out = encode(params, cfg, frame_embeds)
    B, S = dec_tokens.shape
    x = embed(params["embed"], dec_tokens.long(), dtype)
    positions = _positions(B, S, x.device)
    for i, p in enumerate(params["dec_layers"]):
        if boundary_fn is not None and i == cut:
            x = boundary_fn(x)
        x = _dec_layer_train(p, cfg, x, enc_out, positions)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x)


def whisper_loss(params, cfg: ModelConfig, frame_embeds, dec_tokens, labels,
                 cut: int = 0, boundary_fn=None, dtype=torch.float32):
    from repro_torch.models.lm import cross_entropy

    logits = whisper_forward(params, cfg, frame_embeds, dec_tokens, cut,
                             boundary_fn, dtype)
    return cross_entropy(logits, labels)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def whisper_prefill(params, cfg: ModelConfig, frame_embeds, dec_tokens,
                    max_len: int, dtype=torch.float32):
    """Encode, run the decoder prompt and build each decoder layer's
    caches: the self-attention's dense ``KVCache`` of ``max_len`` rows and
    the cross-attention's projected encoder KV. Returns (last-position
    logits (B, 1, V), caches)."""
    enc_out = encode(params, cfg, frame_embeds)
    B, S = dec_tokens.shape
    x = embed(params["embed"], dec_tokens.long(), dtype)
    positions = _positions(B, S, x.device)
    hd, F = cfg.resolved_head_dim, enc_out.shape[1]
    caches = []
    for p in params["dec_layers"]:
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        out, self_kv = attn_mod.attend_prefill(p["self_attn"], cfg, h,
                                               positions, max_len)
        x = x + out
        hx = rmsnorm(p["norm_x"], x, cfg.norm_eps)
        k = linear(p["cross_attn"]["wk"], enc_out).reshape(
            B, F, cfg.num_kv_heads, hd)
        v = linear(p["cross_attn"]["wv"], enc_out).reshape(
            B, F, cfg.num_kv_heads, hd)
        x = x + attn_mod.attend_train(p["cross_attn"], cfg, hx, None,
                                      causal=False, cross_kv_x=enc_out)
        x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps),
                    cfg.mlp_act)
        caches.append(DecLayerCache(self_kv, attn_mod.KVCache(k, v, F)))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x[:, -1:, :]), caches


def whisper_decode_step(params, cfg: ModelConfig, token, caches,
                        dtype=torch.float32):
    """token: (B, 1). Returns (logits (B, 1, V), new caches)."""
    x = embed(params["embed"], token.long(), dtype)
    new_caches = []
    for p, c in zip(params["dec_layers"], caches):
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        out, self_kv = attn_mod.attend_decode(p["self_attn"], cfg, h,
                                              c.self_kv)
        x = x + out
        hx = rmsnorm(p["norm_x"], x, cfg.norm_eps)
        out, _ = attn_mod.attend_decode(p["cross_attn"], cfg, hx,
                                        c.cross_kv, cross=True)
        x = x + out
        x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps),
                    cfg.mlp_act)
        new_caches.append(DecLayerCache(self_kv, c.cross_kv))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), new_caches


# ---------------------------------------------------------------------------
# SFL split layout (client = encoder + embed + dec_layers[:cut])
# ---------------------------------------------------------------------------

def split_whisper_params(seed: int, cfg: ModelConfig, cut: int,
                         dtype=torch.float32, device="cuda"):
    """Whisper drawn directly in {client, server} split form. The tied
    unembedding is untied: the head lives server-side (as for the LM
    zoo), drawn after the model from the same generator."""
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    params = _init(gen, cfg, dtype, dev)
    client = {
        "enc_pos": params["enc_pos"],
        "embed": params["embed"],
        "enc_layers": params["enc_layers"],
        "enc_norm": params["enc_norm"],
        "dec_layers": params["dec_layers"][:cut],
    }
    server = {
        "dec_layers": params["dec_layers"][cut:],
        "final_norm": params["final_norm"],
        "head": init_linear(gen, cfg.d_model, cfg.vocab_size, False, dtype,
                            dev),
    }
    return {"client": client, "server": server}


def whisper_client_forward(cparams, cfg: ModelConfig, frame_embeds,
                           dec_tokens, dtype=torch.float32):
    """Returns the smashed data: (decoder residual after
    ``dec_layers[:cut]``, encoder states). Both cross the wire in split
    training."""
    enc_out = encode(cparams, cfg, frame_embeds)
    B, S = dec_tokens.shape
    x = embed(cparams["embed"], dec_tokens.long(), dtype)
    positions = _positions(B, S, x.device)
    for p in cparams["dec_layers"]:
        x = _dec_layer_train(p, cfg, x, enc_out, positions)
    return x, enc_out


def whisper_server_forward(sparams, cfg: ModelConfig, x, enc_out):
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    for p in sparams["dec_layers"]:
        x = _dec_layer_train(p, cfg, x, enc_out, positions)
    x = rmsnorm(sparams["final_norm"], x, cfg.norm_eps)
    return linear(sparams["head"], x)
