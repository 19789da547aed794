"""Plain PyTorch layers of a hybrid family with mixture-of-experts FFNs
(Jamba, arXiv:2403.19887): written from the published description, with
nothing of the program.

Layer ``i`` is a pre-norm sublayer: an attention mixer where ``i mod
hybrid_period`` is one of ``hybrid_attn_offsets``, else a Mamba-2 mixer
(``reference.model``'s), then an FFN: a mixture of experts where ``i >=
first_k_dense`` and ``(i - first_k_dense) mod every == 0``, else a
SwiGLU MLP.

The mixture of experts (Switch / GShard): a linear router, the softmax
over the experts, the ``top_k`` largest probabilities (ties to the lower
expert), renormalised to sum to 1, as the gates; each expert a SwiGLU of
width ``d_ff_expert``; ``num_shared_experts`` shared experts as one
SwiGLU of ``num_shared_experts`` times that width, added for every
token. An expert takes at most C = ceil(top_k T capacity_factor /
num_experts) of a forward's T tokens, the first C (token, choice) pairs
in token order; the rest are dropped. The layer also returns the Switch
balance loss, num_experts * sum_e me_e ce_e, with me the mean router
probability of expert e and ce the share of the (token, choice) pairs
routed to it (a count, with no gradient).

A forward of more than 65,536 tokens is refused: the routing is one
group over the whole forward.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.model import (attention, attention_leaves, linear_leaf,
                             mamba2, mamba2_leaves, rmsnorm, swiglu,
                             swiglu_leaves)

TINY = {"hybrid": dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                       d_ff=64, vocab_size=128)}
MAX_TOKENS = 65536


def is_attn(model: dict, i: int) -> bool:
    return (i % model["hybrid_period"]) in model["hybrid_attn_offsets"]


def is_moe(model: dict, i: int) -> bool:
    m = model.get("moe")
    return bool(m) and i >= m["first_k_dense"] \
        and (i - m["first_k_dense"]) % m["every"] == 0


def layer_leaves(model: dict, i: int) -> list:
    d, p = model["d_model"], f"layer{i}."
    out = [(p + "norm1.scale", (d,), "ones", 0.0)]
    out += attention_leaves(p + "attn.", model) if is_attn(model, i) \
        else mamba2_leaves(p + "ssm.", model)
    out.append((p + "norm2.scale", (d,), "ones", 0.0))
    if not is_moe(model, i):
        return out + swiglu_leaves(p + "mlp.", d, model["d_ff"])
    m = model["moe"]
    E, f = m["num_experts"], m["d_ff_expert"]
    out += [linear_leaf(p + "moe.router.w", d, E),
            (p + "moe.w_gate", (E, d, f), "normal", 1.0 / math.sqrt(d)),
            (p + "moe.w_up", (E, d, f), "normal", 1.0 / math.sqrt(d)),
            (p + "moe.w_down", (E, f, d), "normal", 1.0 / math.sqrt(f))]
    if m.get("num_shared_experts"):
        out += swiglu_leaves(p + "moe.shared.", d,
                             f * m["num_shared_experts"])
    return out


def moe(p, pre, x, model):
    """(y, balance loss) of the mixture of experts on x (B, S, d)."""
    m = model["moe"]
    E, k = m["num_experts"], m["top_k"]
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
    for e in range(E):
        rows, choice = (idx == e).nonzero(as_tuple=True)  # token order
        rows, choice = rows[:C], choice[:C]
        if rows.numel() == 0:
            continue
        h = xt[rows]
        out = (F.silu(h @ p[pre + "w_gate"][e]) * (h @ p[pre + "w_up"][e])) \
            @ p[pre + "w_down"][e]
        y = y.index_add(0, rows, out * gates[rows, choice, None])
    if m.get("num_shared_experts"):
        y = y + swiglu(p, pre + "shared.", xt)
    return y.reshape(B, S, d), aux


def layer(p, i, x, model):
    """Layer ``i`` on the residual stream x (B, S, d): x, or (x, the
    balance loss) for a mixture-of-experts layer."""
    pre, eps = f"layer{i}.", model["norm_eps"]
    h = rmsnorm(x, p[pre + "norm1.scale"], eps)
    x = x + (attention(p, pre + "attn.", h, model) if is_attn(model, i)
             else mamba2(p, pre + "ssm.", h, model))
    h = rmsnorm(x, p[pre + "norm2.scale"], eps)
    if not is_moe(model, i):
        return x + swiglu(p, pre + "mlp.", h)
    y, aux = moe(p, pre + "moe.", h, model)
    return x + y, aux
