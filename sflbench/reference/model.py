"""Plain PyTorch layers of the two families the benchmark runs.

Written from the published descriptions, with nothing of the program:

* dense (granite-8b, arXiv:2405.04324): pre-norm decoder layers, RMSNorm,
  grouped-query attention with rotary embeddings (rotate-half, theta from
  the configuration), causal softmax, a SwiGLU MLP;
* ssm (mamba2-130m, arXiv:2405.21060): pre-norm Mamba-2 mixers: one input
  projection to (z, x, B, C, dt), a depthwise causal convolution of
  width k with SiLU over (x, B, C), the SSD recurrence with A = -exp(A_log)
  and dt = softplus(dt + dt_bias), the skip D x, the gated RMSNorm
  rmsnorm(y * silu(z)) and the output projection.

The SSD is evaluated chunk by chunk: inside a chunk as its masked
quadratic form, across chunks by carrying the (H, P, N) state. A weight
``w`` is (d_in, d_out) and applied as ``x @ w``. Everything is float32;
the caller sets torch's TF32 flags (``sfl.precision``).

This is the default family (``reference/__init__.py``): its leaves are
the usual distributions of these families, linear weights normal with
std 1 / sqrt(d_in), norm scales 1; for a Mamba-2 mixer the depthwise
conv normal / sqrt(k), A_log = log(1..H), D = 1, and dt_bias the inverse
softplus of a dt drawn log-uniformly in [dt_min, dt_max].
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# CPU size a model of each arch_type is cut to in the tests
TINY = {
    "dense": dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                  d_ff=128, vocab_size=256),
    "ssm": dict(d_model=32, vocab_size=256, num_layers=4,
                ssm=dict(state_dim=16, head_dim=16, chunk_size=16)),
}


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["num_heads"]


def ssm_dims(model: dict) -> dict:
    s = model["ssm"]
    d_inner = s["expand"] * model["d_model"]
    heads = d_inner // s["head_dim"]
    gn = s["n_groups"] * s["state_dim"]
    return {"d_inner": d_inner, "heads": heads, "gn": gn,
            "conv_ch": d_inner + 2 * gn,
            "in_proj": 2 * d_inner + 2 * gn + heads}


def linear_leaf(name, d_in, d_out):
    return (name, (d_in, d_out), "normal", 1.0 / math.sqrt(d_in))


def attention_leaves(pre, model):
    d, hd = model["d_model"], head_dim(model)
    hq, hkv = model["num_heads"] * hd, model["num_kv_heads"] * hd
    return [linear_leaf(pre + "wq.w", d, hq),
            linear_leaf(pre + "wk.w", d, hkv),
            linear_leaf(pre + "wv.w", d, hkv),
            linear_leaf(pre + "wo.w", hq, d)]


def swiglu_leaves(pre, d, ff):
    return [linear_leaf(pre + "gate.w", d, ff),
            linear_leaf(pre + "up.w", d, ff),
            linear_leaf(pre + "down.w", ff, d)]


def mamba2_leaves(pre, model):
    d, s, sd = model["d_model"], model["ssm"], ssm_dims(model)
    return [linear_leaf(pre + "in_proj.w", d, sd["in_proj"]),
            (pre + "conv_w", (s["conv_dim"], sd["conv_ch"]), "normal",
             1.0 / math.sqrt(s["conv_dim"])),
            (pre + "conv_b", (sd["conv_ch"],), "zeros", 0.0),
            (pre + "A_log", (sd["heads"],), "a_log", 0.0),
            (pre + "D", (sd["heads"],), "ones", 0.0),
            (pre + "dt_bias", (sd["heads"],), "dt_bias", 0.0),
            (pre + "norm.scale", (sd["d_inner"],), "ones", 0.0),
            linear_leaf(pre + "out_proj.w", sd["d_inner"], d)]


def layer_leaves(model: dict, i: int) -> list:
    d = model["d_model"]
    p = f"layer{i}."
    out = [(p + "norm1.scale", (d,), "ones", 0.0)]
    if model["arch_type"] == "dense":
        return out + attention_leaves(p + "attn.", model) + \
            [(p + "norm2.scale", (d,), "ones", 0.0)] + \
            swiglu_leaves(p + "mlp.", d, model["d_ff"])
    if model["arch_type"] == "ssm":
        return out + mamba2_leaves(p + "ssm.", model)
    raise ValueError(f"arch_type {model['arch_type']!r} is not this "
                     f"family's (dense and ssm only)")


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x: (B, S, H, D), positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = 1.0 / (torch.tensor(theta, dtype=torch.float32, device=x.device)
                 ** (torch.arange(half, dtype=torch.float32, device=x.device)
                     / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, pre, x, model):
    B, S, _ = x.shape
    H, Hkv = model["num_heads"], model["num_kv_heads"]
    D = model.get("head_dim") or model["d_model"] // H
    q = rope((x @ p[pre + "wq.w"]).view(B, S, H, D), model["rope_theta"])
    k = rope((x @ p[pre + "wk.w"]).view(B, S, Hkv, D), model["rope_theta"])
    v = (x @ p[pre + "wv.w"]).view(B, S, Hkv, D)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, heads, S, D)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(D)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = (w @ v).transpose(1, 2).reshape(B, S, H * D)
    return o @ p[pre + "wo.w"]


def swiglu(p, pre, x):
    return (F.silu(x @ p[pre + "gate.w"]) * (x @ p[pre + "up.w"])) \
        @ p[pre + "down.w"]


def ssd(x, dt, A, Bm, Cm, chunk):
    """y of the SSD. x: (b, S, H, P); dt: (b, S, H); A: (H,); Bm, Cm: (b,
    S, G, N)."""
    b, S, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=2)  # (b, S, H, N)
    Ch = Cm.repeat_interleave(rep, dim=2)
    state = x.new_zeros(b, H, P, Bh.shape[-1])
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        xdt = x[:, sl] * dt[:, sl, :, None]           # (b, Q, H, P)
        cs = torch.cumsum(dt[:, sl] * A, dim=1)       # (b, Q, H)
        diff = cs[:, :, None, :] - cs[:, None, :, :]  # (b, Qt, Qs, H)
        decay = torch.exp(torch.where(tril[None, :, :, None], diff,
                                      float("-inf")))
        scores = torch.einsum("bthn,bshn->btsh", Ch[:, sl], Bh[:, sl]) * decay
        y = torch.einsum("btsh,bshp->bthp", scores, xdt)
        y = y + torch.einsum("bthn,bhpn->bthp", Ch[:, sl], state) \
            * torch.exp(cs)[..., None]
        ys.append(y)
        to_end = torch.exp(cs[:, -1:, :] - cs)        # (b, Q, H)
        state = state * torch.exp(cs[:, -1])[..., None, None] + torch.einsum(
            "bsh,bshp,bshn->bhpn", to_end, xdt, Bh[:, sl])
    return torch.cat(ys, dim=1)


def mamba2(p, pre, x, model):
    s = model["ssm"]
    B, S, d = x.shape
    d_inner = s["expand"] * d
    H = d_inner // s["head_dim"]
    gn = s["n_groups"] * s["state_dim"]
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
    y = rmsnorm(y * F.silu(z), p[pre + "norm.scale"], model["norm_eps"])
    return y @ p[pre + "out_proj.w"]


def layer(p, i, x, model):
    """Decoder layer ``i`` on the residual stream x (B, S, d)."""
    pre, eps = f"layer{i}.", model["norm_eps"]
    h = rmsnorm(x, p[pre + "norm1.scale"], eps)
    if model["arch_type"] == "dense":
        x = x + attention(p, pre + "attn.", h, model)
        return x + swiglu(p, pre + "mlp.",
                          rmsnorm(x, p[pre + "norm2.scale"], eps))
    if model["arch_type"] == "ssm":
        return x + mamba2(p, pre + "ssm.", h, model)
    raise ValueError(f"no reference layer for {model['arch_type']!r}")


def cross_entropy(logits, labels):
    """Mean token cross-entropy. logits (T, V), labels (T,)."""
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - logits.gather(-1, labels[:, None].long())[:, 0]).mean()
