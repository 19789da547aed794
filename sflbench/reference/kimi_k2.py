"""Plain PyTorch layers of Moonshot AI's Kimi K2 (``kimi_k2``;
https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/config.json),
written from the published configuration and DeepSeek-V3's description
of the same architecture (arXiv:2412.19437 §2.1), with nothing of the
program.

Layer ``i`` is a pre-norm pair of residual branches:

    h = x + mla(rmsnorm(x))
    x = h + ffn(rmsnorm(h))

where the FFN is a SwiGLU of width ``d_ff`` (18,432) in the first
``first_k_dense`` layers (layer 0) and a mixture of experts after them.

Multi-head latent attention, H heads (64), no bias:

* q = q_b(rmsnorm(q_a(x))), through a ``q_lora_rank`` (1,536) latent;
  each head is ``qk_nope_head_dim`` (128) dimensions without RoPE, then
  ``qk_rope_head_dim`` (64) with it;
* kv_a(x) is a ``kv_lora_rank`` (512) latent and one rope key of 64
  dimensions, shared by every head; kv_b(rmsnorm(latent)) gives each
  head's 128 nope dimensions of k and its v of ``v_head_dim`` (128);
* RoPE pairs dimensions (2i, 2i+1) at frequency i (the published code's
  pairing), with YaRN's frequencies: theta^(-2i/R) below the correction
  range, divided by the factor (32) above it, a linear ramp between; the
  range is DeepSeek-V3's ``yarn_find_correction_range`` at beta_fast and
  beta_slow over the original length (4,096), which at R 64 and theta
  50,000 is frequencies 19 to 20. The cos/sin factor mscale /
  mscale_all_dim is 1 (both published as 1);
* the causal softmax of q.k over all 192 dimensions -- written here as
  the nope scores per head plus the rope scores against the one shared
  key -- times (192)^-1/2 x mscale^2, mscale = 0.1 mscale_all_dim
  ln(factor) + 1; the values at their own width; o_proj.

The router (``scoring_func`` sigmoid, ``topk_method`` noaux_tc, one
group): s = sigmoid(x W_r) over all ``num_experts`` (384); the ``top_k``
(8) chosen on s + b, b the per-expert ``e_score_correction_bias`` (ties
to the lower expert); the gates the chosen experts' s over their sum,
times ``routed_scaling`` (2.827). Each expert is a SwiGLU of width
``d_ff_expert`` (2,048); one shared SwiGLU of the same width is added
for every token. The balance loss is DeepSeek-V3's sequence-wise one
(``seq_aux``): per sequence of S tokens, sum_i f_i P_i with f_i = E / (k
S) times the sequence's pairs routed to i and P_i the sequence's mean of
s_i / sum_j s_j; averaged over the sequences.

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
* the correction bias is not updated (DeepSeek-V3's aux-free rule, b_i
  -/+ gamma by each expert's load after a step, is left out): it is a
  fixed leaf drawn normal with the std ``bias_std`` gives, the expected
  gap between neighbouring sorted scores at the top_k-th place at the
  seeded start, so that the choice on s + b differs from the choice on
  s at the margin. It takes no gradient; it enters the loss times 0, so
  that autograd gives it its gradient, zero;
* the balance loss enters the loss with the port's weight, 0.01 (K2
  publishes none; DeepSeek-V3 used 1e-4);
* the vocabulary is a slice (``vocab_size``), its embedding the
  clients' and its head, untied as published, the server's
  (``reference``'s default leaves);
* weights are random, float32, from the run's seed.

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

from reference.model import linear_leaf, rmsnorm, swiglu, swiglu_leaves

TINY = {"moe": dict(d_model=32, num_heads=4, d_ff=64, vocab_size=128,
                    q_lora_rank=24, kv_lora_rank=16, qk_nope_head_dim=8,
                    qk_rope_head_dim=8, v_head_dim=12,
                    moe=dict(num_experts=16, top_k=4, d_ff_expert=16,
                             experts_held=4))}
MAX_TOKENS = 65536
AUX_WEIGHT = 0.01


def held(m: dict):
    """(first expert held, experts held)."""
    return m.get("expert_offset", 0), m.get("experts_held") or \
        m["num_experts"]


def shared_width(m: dict) -> int:
    return m.get("d_ff_shared") or m["d_ff_expert"] * m["num_shared_experts"]


def bias_std(m: dict) -> float:
    """The correction bias's std: the expected gap between neighbouring
    sorted scores at the top_k-th place of num_experts at the seeded
    start. There the router's input is RMS-normed (scale 1) and its
    weights are normal of std d^-1/2, so each logit is N(0, 1); among E
    of them the order statistics near the k-th largest lie 1 / (E
    phi(z)) apart, z the normal's 1 - k / E quantile, and the sigmoid
    scales that by s (1 - s), s = sigmoid(z): 0.0053 at E 384 and k 8."""
    E, k = m["num_experts"], m["top_k"]
    z = float(torch.special.ndtri(torch.tensor(1.0 - k / E,
                                               dtype=torch.float64)))
    s = 1.0 / (1.0 + math.exp(-z))
    return s * (1.0 - s) / (E * math.exp(-z * z / 2) / math.sqrt(2 * math.pi))


def is_moe(model: dict, i: int) -> bool:
    return i >= model["moe"]["first_k_dense"]


def mla_leaves(pre: str, model: dict) -> list:
    d, H = model["d_model"], model["num_heads"]
    nope, rope = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    qr, kvr = model["q_lora_rank"], model["kv_lora_rank"]
    return [linear_leaf(pre + "q_a.w", d, qr),
            (pre + "q_a_norm.scale", (qr,), "ones", 0.0),
            linear_leaf(pre + "q_b.w", qr, H * (nope + rope)),
            linear_leaf(pre + "kv_a.w", d, kvr + rope),
            (pre + "kv_a_norm.scale", (kvr,), "ones", 0.0),
            linear_leaf(pre + "kv_b.w", kvr, H * (nope + model["v_head_dim"])),
            linear_leaf(pre + "wo.w", H * model["v_head_dim"], d)]


def layer_leaves(model: dict, i: int) -> list:
    d, p = model["d_model"], f"layer{i}."
    out = [(p + "norm1.scale", (d,), "ones", 0.0)]
    out += mla_leaves(p + "attn.", model)
    out.append((p + "norm2.scale", (d,), "ones", 0.0))
    if not is_moe(model, i):
        return out + swiglu_leaves(p + "mlp.", d, model["d_ff"])
    m = model["moe"]
    n, f = held(m)[1], m["d_ff_expert"]
    out += [linear_leaf(p + "moe.router.w", d, m["num_experts"]),
            (p + "moe.correction_bias", (m["num_experts"],), "normal",
             bias_std(m)),
            (p + "moe.w_gate", (n, d, f), "normal", 1.0 / math.sqrt(d)),
            (p + "moe.w_up", (n, d, f), "normal", 1.0 / math.sqrt(d)),
            (p + "moe.w_down", (n, f, d), "normal", 1.0 / math.sqrt(f))]
    return out + swiglu_leaves(p + "moe.shared.", d, shared_width(m))


def yarn_correction_range(model: dict):
    """(low, high) frequency indices of YaRN's ramp."""
    R, theta = model["qk_rope_head_dim"], model["rope_theta"]
    orig = model["yarn_original_max_position"]

    def dim(rotations):
        return R * math.log(orig / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))

    return (max(math.floor(dim(model["yarn_beta_fast"])), 0),
            min(math.ceil(dim(model["yarn_beta_slow"])), R - 1))


def inv_freq(model: dict, device) -> torch.Tensor:
    """The R / 2 rope frequencies, YaRN's where ``yarn_factor`` > 1."""
    R, theta = model["qk_rope_head_dim"], model["rope_theta"]
    i = torch.arange(R // 2, dtype=torch.float64, device=device)
    base = theta ** (-2.0 * i / R)
    factor = model.get("yarn_factor", 1.0)
    if factor == 1.0:
        return base.float()
    low, high = yarn_correction_range(model)
    ramp = ((i - low) / max(high - low, 0.001)).clamp(0.0, 1.0)
    return (base * (1.0 - ramp) + base / factor * ramp).float()


def softmax_scale(model: dict) -> float:
    scale = (model["qk_nope_head_dim"] + model["qk_rope_head_dim"]) ** -0.5
    factor = model.get("yarn_factor", 1.0)
    if factor > 1.0 and model.get("yarn_mscale_all_dim"):
        m = 0.1 * model["yarn_mscale_all_dim"] * math.log(factor) + 1.0
        scale *= m * m
    return scale


def rope_pairs(x, freqs):
    """x (B, S, H, R): pairs (2i, 2i+1) rotated by position x freqs[i],
    left interleaved."""
    S = x.shape[1]
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       dim=-1).flatten(-2)


def mla(p, pre, x, model):
    B, S, _ = x.shape
    H, eps = model["num_heads"], model["norm_eps"]
    nope, rope = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    kvr, dv = model["kv_lora_rank"], model["v_head_dim"]
    q = (rmsnorm(x @ p[pre + "q_a.w"], p[pre + "q_a_norm.scale"], eps)
         @ p[pre + "q_b.w"]).view(B, S, H, nope + rope)
    ckv = x @ p[pre + "kv_a.w"]
    kv = (rmsnorm(ckv[..., :kvr], p[pre + "kv_a_norm.scale"], eps)
          @ p[pre + "kv_b.w"]).view(B, S, H, nope + dv)
    freqs = inv_freq(model, x.device)
    q_rope = rope_pairs(q[..., nope:], freqs)                  # (B, S, H, R)
    k_rope = rope_pairs(ckv[..., kvr:].view(B, S, 1, rope), freqs)[:, :, 0]
    scores = torch.einsum("bshd,bthd->bhst", q[..., :nope], kv[..., :nope]) \
        + torch.einsum("bshr,btr->bhst", q_rope, k_rope)
    scores = scores * softmax_scale(model)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhst,bthd->bshd", w, kv[..., nope:]).reshape(B, S,
                                                                   H * dv)
    return o @ p[pre + "wo.w"]


def sequence_balance_loss(s, idx, B: int, S: int, E: int, k: int):
    """DeepSeek-V3's sequence-wise balance loss of the (B S, E) scores and
    the (B S, k) choices, averaged over the B sequences."""
    share = (s / s.sum(-1, keepdim=True)).view(B, S, E).mean(1)
    counts = torch.stack([torch.bincount(row, minlength=E) for row in
                          idx.reshape(B, S * k)]).float()
    return ((counts * (E / (k * S))) * share).sum(-1).mean()


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
        h = xt[rows]
        out = (F.silu(h @ p[pre + "w_gate"][j]) * (h @ p[pre + "w_up"][j])) \
            @ p[pre + "w_down"][j]
        y = y.index_add(0, rows, out * gates[rows, choice, None])
    y = y + swiglu(p, pre + "shared.", xt)
    return y.reshape(B, S, d), aux


def _layer(p, i, x, model):
    pre, eps = f"layer{i}.", model["norm_eps"]
    x = x + mla(p, pre + "attn.", rmsnorm(x, p[pre + "norm1.scale"], eps),
                model)
    h = rmsnorm(x, p[pre + "norm2.scale"], eps)
    if not is_moe(model, i):
        return x + swiglu(p, pre + "mlp.", h)
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
