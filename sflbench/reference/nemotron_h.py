"""Plain PyTorch layers of NVIDIA Nemotron 3 Nano 30B-A3B (``nemotron_h``;
https://huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16/blob/main/config.json),
written from the published configuration and the Nemotron-H
description, with nothing of the program.

The layers follow ``layer_pattern`` (the published
``hybrid_override_pattern``), one character a layer, and each layer is
one pre-norm residual branch:

    M:  x = x + mamba2(rmsnorm(x))
    *:  x = x + attention(rmsnorm(x))
    E:  x = x + moe(rmsnorm(x)) + shared(rmsnorm(x))
    -:  x = x + down(relu(rmsnorm(x) up)^2)

The Mamba-2 mixer has ``ssm.num_heads`` (64) heads of ``ssm.head_dim``
(64), so its inner width is their product (4,096), not expand x d:

    z, xBC, dt = split(x W_in)           widths d_inner, d_inner + 2 G N, H
    x, B, C    = split(silu(conv(xBC) + b_conv))   a depthwise causal
                                                   conv of width k (4)
    dt         = softplus(dt + dt_bias),  A = -exp(A_log)
    y          = SSD(x, dt, A, B, C) + D x          (reference.model.ssd)
    y          = gnorm(y * silu(z)) W_out

with B and C in ``n_groups`` (8) groups of state ``state_dim`` (128),
each group shared by H / G (8) consecutive heads, and gnorm the RMSNorm
taken over each group of d_inner / G (512) channels on its own, times
the norm's scale (Mamba-2's RMSNormGated with group_size).

Attention is causal grouped-query attention, ``num_heads`` (32) query
heads and ``num_kv_heads`` (2) key/value heads of ``head_dim`` (128),
no bias, no positional embedding (the published modeling code applies
none), softmax at 1/sqrt(head_dim).

The MoE's router (``n_group`` 1): s = sigmoid(x W_r) over all
``num_experts`` (128); the ``top_k`` (6) chosen on s + b, b the
per-expert correction bias (ties to the lower expert); the gates the
chosen experts' s over their sum (``norm_topk_prob``), times
``routed_scaling`` (2.5). Each expert is the ungated relu^2 FFN of width
``d_ff_expert`` (1,856), down(relu(x up)^2); one shared relu^2 FFN of
width ``d_ff_shared`` (3,712) is added for every token. The balance loss
is the sequence-wise one of ``reference.kimi_k2``.

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
* the correction bias is not updated (the aux-loss-free rule is left
  out): it is a fixed leaf drawn normal with ``kimi_k2.bias_std``'s std
  (0.0106 at 128 experts and top 6), takes no gradient and enters the
  loss times 0;
* the balance loss enters the loss with the port's weight, 0.01: the
  configuration gives none;
* the vocabulary is a slice (``vocab_size``), its embedding the
  clients' and its head, untied as published, the server's
  (``reference``'s default leaves);
* weights are random, float32, from the run's seed.

Everything is float32; the caller sets torch's TF32 flags
(``sfl.precision`` turns TF32 off, the control on). Each layer runs
under ``torch.utils.checkpoint`` (the same math, recomputed in the
backward), and attention takes one sequence at a time, so that the
full-width check fits on one card. A forward of more than 65,536 tokens
is refused: the routing is one group over the whole forward.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.kimi_k2 import bias_std, held, sequence_balance_loss
from reference.model import attention_leaves, linear_leaf, rmsnorm, ssd

TINY = {"hybrid": dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                       d_ff=48, vocab_size=128, num_layers=5,
                       layer_pattern="MEM*E",
                       ssm=dict(num_heads=4, head_dim=8, n_groups=2,
                                state_dim=16, chunk_size=16),
                       moe=dict(num_experts=8, top_k=2, d_ff_expert=16,
                                d_ff_shared=32, experts_held=4))}
MAX_TOKENS = 65536
AUX_WEIGHT = 0.01


def mamba_dims(model: dict) -> dict:
    s = model["ssm"]
    heads = s["num_heads"]
    d_inner = heads * s["head_dim"]
    gn = s["n_groups"] * s["state_dim"]
    return {"d_inner": d_inner, "heads": heads, "gn": gn,
            "conv_ch": d_inner + 2 * gn,
            "in_proj": 2 * d_inner + 2 * gn + heads}


def mamba_leaves(pre: str, model: dict) -> list:
    d, k, sd = model["d_model"], model["ssm"]["conv_dim"], mamba_dims(model)
    return [linear_leaf(pre + "in_proj.w", d, sd["in_proj"]),
            (pre + "conv_w", (k, sd["conv_ch"]), "normal", 1.0 / math.sqrt(k)),
            (pre + "conv_b", (sd["conv_ch"],), "zeros", 0.0),
            (pre + "A_log", (sd["heads"],), "a_log", 0.0),
            (pre + "D", (sd["heads"],), "ones", 0.0),
            (pre + "dt_bias", (sd["heads"],), "dt_bias", 0.0),
            (pre + "norm.scale", (sd["d_inner"],), "ones", 0.0),
            linear_leaf(pre + "out_proj.w", sd["d_inner"], d)]


def layer_leaves(model: dict, i: int) -> list:
    d, p, kind = model["d_model"], f"layer{i}.", model["layer_pattern"][i]
    if kind == "M":
        return [(p + "norm1.scale", (d,), "ones", 0.0)] + \
            mamba_leaves(p + "ssm.", model)
    if kind == "*":
        return [(p + "norm1.scale", (d,), "ones", 0.0)] + \
            attention_leaves(p + "attn.", model)
    out = [(p + "norm2.scale", (d,), "ones", 0.0)]
    if kind == "-":
        return out + [linear_leaf(p + "mlp.up.w", d, model["d_ff"]),
                      linear_leaf(p + "mlp.down.w", model["d_ff"], d)]
    m = model["moe"]
    n, f, fs = held(m)[1], m["d_ff_expert"], m["d_ff_shared"]
    return out + [
        linear_leaf(p + "moe.router.w", d, m["num_experts"]),
        (p + "moe.correction_bias", (m["num_experts"],), "normal",
         bias_std(m)),
        (p + "moe.w_up", (n, d, f), "normal", 1.0 / math.sqrt(d)),
        (p + "moe.w_down", (n, f, d), "normal", 1.0 / math.sqrt(f)),
        linear_leaf(p + "moe.shared.up.w", d, fs),
        linear_leaf(p + "moe.shared.down.w", fs, d)]


def relu2(x, up, down):
    return F.relu(x @ up).square() @ down


def gated_group_norm(y, z, scale, groups: int, eps: float):
    """RMSNorm of y * silu(z) over each of ``groups`` channel groups."""
    h = (y * F.silu(z)).unflatten(-1, (groups, -1))
    h = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + eps)
    return h.flatten(-2) * scale


def mamba2(p, pre, x, model):
    s, sd = model["ssm"], mamba_dims(model)
    B, S, _ = x.shape
    d_inner, H, gn = sd["d_inner"], sd["heads"], sd["gn"]
    z, xbc, dt = torch.split(x @ p[pre + "in_proj.w"],
                             [d_inner, d_inner + 2 * gn, H], dim=-1)
    w, k = p[pre + "conv_w"], p[pre + "conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(xp[:, m:m + S] * w[m] for m in range(k)) + p[pre + "conv_b"]
    xs, Bm, Cm = torch.split(F.silu(conv), [d_inner, gn, gn], dim=-1)
    xh = xs.reshape(B, S, H, s["head_dim"])
    dt = F.softplus(dt + p[pre + "dt_bias"])
    A = -torch.exp(p[pre + "A_log"])
    y = ssd(xh, dt, A, Bm.reshape(B, S, s["n_groups"], -1),
            Cm.reshape(B, S, s["n_groups"], -1), s["chunk_size"])
    y = (y + p[pre + "D"][None, None, :, None] * xh).reshape(B, S, d_inner)
    y = gated_group_norm(y, z, p[pre + "norm.scale"], s["n_groups"],
                         model["norm_eps"])
    return y @ p[pre + "out_proj.w"]


def attention(p, pre, x, model):
    """Causal GQA without a positional embedding, one sequence at a
    time."""
    B, S, _ = x.shape
    H, Hkv, D = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    outs = []
    for xb in x:
        q = (xb @ p[pre + "wq.w"]).view(S, H, D).transpose(0, 1)
        k = (xb @ p[pre + "wk.w"]).view(S, Hkv, D).transpose(0, 1)
        v = (xb @ p[pre + "wv.w"]).view(S, Hkv, D).transpose(0, 1)
        k = k.repeat_interleave(H // Hkv, dim=0)
        v = v.repeat_interleave(H // Hkv, dim=0)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(D)
        w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        outs.append((w @ v).transpose(0, 1).reshape(S, H * D))
    return torch.stack(outs) @ p[pre + "wo.w"]


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
    bias = p[pre + "correction_bias"]
    s = torch.sigmoid(xt @ p[pre + "router.w"])
    order = torch.sort(s.detach() + bias.detach(), dim=-1, descending=True,
                       stable=True)[1]
    idx = order[:, :k]
    chosen = s.gather(1, idx)
    gates = chosen / (chosen.sum(-1, keepdim=True) + 1e-20) \
        * m["routed_scaling"]
    aux = sequence_balance_loss(s, idx, B, S, E, k) + 0.0 * bias.sum()
    C = max(1, math.ceil(k * T * m["capacity_factor"] / E))
    y = torch.zeros_like(xt)
    for j in range(n):
        rows, choice = (idx == off + j).nonzero(as_tuple=True)  # token order
        rows, choice = rows[:C], choice[:C]
        if rows.numel() == 0:
            continue
        out = relu2(xt[rows], p[pre + "w_up"][j], p[pre + "w_down"][j])
        y = y.index_add(0, rows, out * gates[rows, choice, None])
    y = y + relu2(xt, p[pre + "shared.up.w"], p[pre + "shared.down.w"])
    return y.reshape(B, S, d), aux


def _layer(p, i, x, model):
    pre, eps = f"layer{i}.", model["norm_eps"]
    kind = model["layer_pattern"][i]
    if kind in "M*":
        h = rmsnorm(x, p[pre + "norm1.scale"], eps)
        mixer = mamba2 if kind == "M" else attention
        sub = "ssm." if kind == "M" else "attn."
        return x + mixer(p, pre + sub, h, model)
    h = rmsnorm(x, p[pre + "norm2.scale"], eps)
    if kind == "-":
        return x + relu2(h, p[pre + "mlp.up.w"], p[pre + "mlp.down.w"])
    y, aux = moe(p, pre + "moe.", h, model)
    return x + y, aux


def layer(p, i, x, model):
    """Layer ``i`` on the residual stream x (B, S, d): x, or (x, the
    balance loss) for an expert layer, its activations recomputed in the
    backward."""
    keys = [k for k in p if k.startswith(f"layer{i}.")]

    def run(x, *leaves):
        return _layer(dict(zip(keys, leaves)), i, x, model)

    return checkpoint(run, x, *[p[k] for k in keys], use_reentrant=False,
                      preserve_rng_state=False)
