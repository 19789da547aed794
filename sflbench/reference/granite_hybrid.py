"""Plain PyTorch layers of IBM Granite 4.0-H (``granitemoehybrid``;
https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json),
written from the published configuration and description, with nothing
of the program.

Layer ``i`` is a pre-norm pair of residual branches, each scaled by
``residual_multiplier`` (m, 0.22 published):

    h = x + m * mixer(rmsnorm(x))
    x = h + m * (moe(rmsnorm(h)) + shared(rmsnorm(h)))

The mixer is attention where ``i mod hybrid_period`` is one of
``hybrid_attn_offsets`` (layers 5, 15, 25, 35 of the 40), else a Mamba-2
mixer (``reference.model``'s: in_proj without bias, a depthwise causal
convolution with bias, the SSD, the gated RMSNorm over the whole inner
width as one group has it, out_proj). Attention is grouped-query and
causal, with no positional embedding (``position_embedding`` "nope") and
the softmax scale ``attention_multiplier`` (1/128) in place of
1/sqrt(head_dim). The embedding is multiplied by
``embedding_multiplier`` (12); the logits are rmsnorm(h) @ head divided
by ``logits_scaling`` (16).

Every layer's FFN is a mixture of experts: a linear router, the softmax
over all ``num_experts`` (72), the ``top_k`` (10) largest probabilities
(ties to the lower expert) renormalised to sum to 1 -- the softmax over
the top-k logits, as published -- as the gates; each expert a SwiGLU of
width ``d_ff_expert`` (768); beside it one shared SwiGLU of width
``d_ff_shared`` (1,536), added for every token. It returns the Switch
balance loss, num_experts * sum_e me_e ce_e over all the experts (me the
mean router probability, ce the share of the (token, choice) pairs
routed to e, a count without gradient).

Departures from the published model:

* capacity: an expert takes at most C = ceil(top_k T capacity_factor /
  num_experts) of a forward's T tokens, the first C (token, choice)
  pairs in token order; the rest are dropped. The published router is
  dropless;
* the expert share: the layer holds experts [expert_offset,
  expert_offset + experts_held) of ``num_experts`` (those of one card of
  an expert-parallel deployment): it routes over all of them, and adds
  only its own experts' part of the result; what the others would add is
  left out;
* the balance loss enters the loss with the port's weight, 0.01 (the
  published router_aux_loss_coef is not used here);
* the split unties the embedding: the clients keep the table, the server
  a head of the same shape (``reference``'s default leaves);
* weights are random, float32, from the run's seed.

A configuration without those keys (or with "rope" and multipliers of
0 and 1) gives RoPE attention at 1/sqrt(head_dim) and unscaled branches,
embedding and logits: the tests hold each field alone against the
program.

Everything is float32; the caller sets torch's TF32 flags
(``sfl.precision`` turns TF32 off, the control on). Each layer runs
under ``torch.utils.checkpoint`` (the same math, recomputed in the
backward), so that the full-width check fits on one card. A forward of
more than 65,536 tokens is refused: the routing is one group over the
whole forward.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.model import (attention_leaves, linear_leaf, mamba2,
                             mamba2_leaves, rmsnorm, rope, swiglu,
                             swiglu_leaves)

TINY = {"hybrid": dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                       vocab_size=128,
                       moe=dict(num_experts=8, top_k=3, d_ff_expert=16,
                                d_ff_shared=32, experts_held=2),
                       ssm=dict(state_dim=16, head_dim=16, chunk_size=16))}
MAX_TOKENS = 65536


def is_attn(model: dict, i: int) -> bool:
    return (i % model["hybrid_period"]) in model["hybrid_attn_offsets"]


def held(m: dict):
    """(first expert held, experts held)."""
    return m.get("expert_offset", 0), m.get("experts_held") or \
        m["num_experts"]


def shared_width(m: dict) -> int:
    return m.get("d_ff_shared") or m["d_ff_expert"] * m["num_shared_experts"]


def layer_leaves(model: dict, i: int) -> list:
    d, p = model["d_model"], f"layer{i}."
    m = model["moe"]
    n, f = held(m)[1], m["d_ff_expert"]
    out = [(p + "norm1.scale", (d,), "ones", 0.0)]
    out += attention_leaves(p + "attn.", model) if is_attn(model, i) \
        else mamba2_leaves(p + "ssm.", model)
    out.append((p + "norm2.scale", (d,), "ones", 0.0))
    out += [linear_leaf(p + "moe.router.w", d, m["num_experts"]),
            (p + "moe.w_gate", (n, d, f), "normal", 1.0 / math.sqrt(d)),
            (p + "moe.w_up", (n, d, f), "normal", 1.0 / math.sqrt(d)),
            (p + "moe.w_down", (n, f, d), "normal", 1.0 / math.sqrt(f))]
    return out + swiglu_leaves(p + "moe.shared.", d, shared_width(m))


def embed(p, tokens, model):
    return p["embed.table"][tokens.long()] * \
        model.get("embedding_multiplier", 1.0)


def logits(p, h, model):
    return rmsnorm(h, p["final_norm.scale"], model["norm_eps"]) \
        @ p["head.w"] / model.get("logits_scaling", 1.0)


def attention(p, pre, x, model):
    """Causal GQA: without a positional embedding where
    ``position_embedding`` is "nope", else with RoPE; the scores times
    ``attention_multiplier``, or over sqrt(head_dim) without one."""
    B, S, _ = x.shape
    H, Hkv, D = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    q = (x @ p[pre + "wq.w"]).view(B, S, H, D)
    k = (x @ p[pre + "wk.w"]).view(B, S, Hkv, D)
    v = (x @ p[pre + "wv.w"]).view(B, S, Hkv, D)
    if model.get("position_embedding", "rope") == "rope":
        q, k = rope(q, model["rope_theta"]), rope(k, model["rope_theta"])
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, heads, S, D)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    scale = model.get("attention_multiplier") or 1.0 / math.sqrt(D)
    scores = (q @ k.transpose(-1, -2)) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = (w @ v).transpose(1, 2).reshape(B, S, H * D)
    return o @ p[pre + "wo.w"]


def moe(p, pre, x, model):
    """(y, balance loss) of the expert share and the shared expert on x
    (B, S, d)."""
    m = model["moe"]
    E, k = m["num_experts"], m["top_k"]
    off, n = held(m)
    B, S, d = x.shape
    T = B * S
    if T > MAX_TOKENS:
        raise ValueError(f"{T} tokens in one forward; the reference routes "
                         f"at most {MAX_TOKENS}")
    xt = x.reshape(T, d)
    probs = torch.softmax(xt @ p[pre + "router.w"], dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :k], order[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    routed = torch.bincount(idx.reshape(-1), minlength=E).float()
    aux = E * torch.sum(probs.mean(0) * (routed / idx.numel()))
    C = max(1, math.ceil(k * T * m["capacity_factor"] / E))
    y = torch.zeros_like(xt)
    for j in range(n):
        rows, choice = (idx == off + j).nonzero(as_tuple=True)  # token order
        rows, choice = rows[:C], choice[:C]
        if rows.numel() == 0:
            continue
        h = xt[rows]
        out = (F.silu(h @ p[pre + "w_gate"][j]) * (h @ p[pre + "w_up"][j])) \
            @ p[pre + "w_down"][j]
        y = y.index_add(0, rows, out * gates[rows, choice, None])
    y = y + swiglu(p, pre + "shared.", xt)
    return y.reshape(B, S, d), aux


def _layer(p, i, x, model):
    pre, eps = f"layer{i}.", model["norm_eps"]
    r = model.get("residual_multiplier", 1.0)
    h = rmsnorm(x, p[pre + "norm1.scale"], eps)
    x = x + r * (attention(p, pre + "attn.", h, model) if is_attn(model, i)
                 else mamba2(p, pre + "ssm.", h, model))
    y, aux = moe(p, pre + "moe.", rmsnorm(x, p[pre + "norm2.scale"], eps),
                 model)
    return x + r * y, aux


def layer(p, i, x, model):
    """Layer ``i`` on the residual stream x (B, S, d): (x, the balance
    loss), its activations recomputed in the backward."""
    keys = [k for k in p if k.startswith(f"layer{i}.")]

    def run(x, *leaves):
        return _layer(dict(zip(keys, leaves)), i, x, model)

    return checkpoint(run, x, *[p[k] for k in keys], use_reentrant=False,
                      preserve_rng_state=False)
