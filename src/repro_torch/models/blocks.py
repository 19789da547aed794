"""Core building blocks: norms, linears, embeddings, RoPE, MLPs.

Port of ``repro.models.blocks``. Params are plain dicts of tensors with
the reference's names and layouts: a ``linear``'s ``w`` is
``(d_in, d_out)`` and is applied as ``x @ w`` (``kernels.ops.matmul``:
on the card a float32 product goes to the 3xTF32 kernel G1), so weights
carried over from the reference need no transpose. ``init_*`` draws on
an explicit device from an explicit ``torch.Generator``: the same
distributions as the reference, not the same bits (jax's threefry is not
torch's RNG). A ``linear`` with a ``"lora"`` entry adds the factored
LoRA term ``((x A) B) * s``; ``init_lora`` and ``merge_lora`` make and
fold such adapters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import is_dtensor, reduce_partial
from repro_torch.kernels import ops


def _normal(shape, gen, device, std, dtype):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=gen)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    """Statistics in f32, result in x's dtype."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * params["scale"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Linear / Embedding
# ---------------------------------------------------------------------------

def init_linear(gen, d_in: int, d_out: int, bias: bool = False,
                dtype=torch.float32, device="cpu", scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal((d_in, d_out), gen, device, scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(params, x):
    y = ops.matmul(x, params["w"].to(x.dtype))
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    if "lora" in params:
        # factored LoRA: y += ((x A) B) * s with s = alpha / rank. The
        # scale rides the adapter tree as a leaf (it crosses the wire and
        # the checkpoint) but is a constant: detached, its gradient is
        # zero and optimizer moments never move it
        lo = params["lora"]
        s = lo["s"].detach().to(x.dtype)
        y = y + ((x @ lo["a"].to(x.dtype)) @ lo["b"].to(x.dtype)) * s
    return y


def init_lora(gen, d_in: int, d_out: int, rank: int, alpha: float,
              dtype=torch.float32, device="cpu"):
    """One LoRA adapter for a ``linear``: ``{"a", "b", "s"}`` with B
    zero-initialised (a new adapter is an exact no-op) and s = alpha /
    rank, a float32 scalar."""
    a = torch.empty((d_in, rank), dtype=torch.float32, device=device)
    a.normal_(0.0, 1.0, generator=gen)
    return {"a": (a / math.sqrt(d_in)).to(dtype),
            "b": torch.zeros((rank, d_out), dtype=dtype, device=device),
            "s": torch.tensor(alpha / rank, dtype=torch.float32,
                              device=device)}


def merge_lora(base, adapter):
    """Fold an adapter into its base linear: w' = w + s * (A @ B), in f32
    (leading axes broadcast)."""
    a32 = adapter["a"].float()
    b32 = adapter["b"].float()
    s = adapter["s"].float()[..., None, None]
    delta = torch.einsum("...ir,...ro->...io", a32, b32) * s
    w = base["w"]
    out = dict(base)
    out["w"] = (w.float() + delta).to(w.dtype)
    return out


def init_embedding(gen, vocab: int, dim: int, dtype=torch.float32,
                   device="cpu"):
    return {"table": _normal((vocab, dim), gen, device, 0.02, dtype)}


def embed(params, ids, dtype):
    table = params["table"].to(dtype)
    if is_dtensor(table, through_vmap=True):
        # over DTensors (the dry run) a vocab-sharded lookup has a rule
        # for the embedding op, and none for a tensor index's backward;
        # its masked partial rows are summed at once (an all-reduce)
        return reduce_partial(F.embedding(ids, table))
    return table[ids]


def unembed(params, x):
    """Tied unembedding: logits = x @ table^T."""
    return x @ params["table"].to(x.dtype).T


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """1 / theta ** (i / half) in f32, in the reference's op order."""
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device)
                  ** expo)


def yarn_range(head_dim: int, theta: float, original: int,
               beta_fast: float, beta_slow: float):
    """(low, high): YaRN's correction range over the head_dim // 2
    frequencies, in DeepSeek-V3's ``yarn_find_correction_range`` form: the
    frequency index at which a frequency turns ``beta`` times over the
    original length, floored for beta_fast and ceiled for beta_slow."""
    def index(turns):
        return head_dim * math.log(original / (turns * 2 * math.pi)) \
            / (2 * math.log(theta))

    return (max(math.floor(index(beta_fast)), 0),
            min(math.ceil(index(beta_slow)), head_dim - 1))


def yarn_freqs(head_dim: int, theta: float, yarn, device="cpu"):
    """YaRN's frequencies (``cfg.yarn``: factor, original length,
    beta_fast, beta_slow): below the correction range RoPE's own, above
    it divided by the factor, a linear ramp between."""
    factor, original, beta_fast, beta_slow = yarn
    low, high = yarn_range(head_dim, theta, original, beta_fast, beta_slow)
    base = rope_freqs(head_dim, theta, device)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device)
             - low) / ((high - low) or 0.001)).clamp(0.0, 1.0)
    return base / factor * ramp + base * (1.0 - ramp)


def rope_sin_cos(positions: torch.Tensor, head_dim: int, theta: float,
                 mrope_sections=(), yarn=None):
    """sin/cos of shape (B, S, head_dim//2); YaRN's frequencies where
    ``yarn`` (``cfg.yarn``) is given.

    ``positions``: (B, S) int -- or (3, B, S) for M-RoPE (Qwen2-VL §3.1),
    whose planes are the temporal, height and width position ids; section
    ``i`` of the frequency axis takes its angles from plane ``i``."""
    freqs = rope_freqs(head_dim, theta, positions.device) if yarn is None \
        else yarn_freqs(head_dim, theta, yarn, positions.device)
    if mrope_sections:
        if positions.dim() != 3 or positions.shape[0] != 3:
            raise ValueError(f"M-RoPE needs (3, B, S) positions, got "
                             f"{tuple(positions.shape)}")
        half = head_dim // 2
        if sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE sections {tuple(mrope_sections)} do "
                             f"not sum to head_dim / 2 = {half}")
        plane = torch.cat([torch.full((s,), i, dtype=torch.long,
                                      device=positions.device)
                           for i, s in enumerate(mrope_sections)])
        pos = positions.to(torch.float32)[plane]  # (half, B, S)
        ang = pos.permute(1, 2, 0) * freqs
    else:
        ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D). sin/cos: (B, S, D//2). Rotate-half convention."""
    d = x.shape[-1]
    x1f = x[..., : d // 2].to(torch.float32)
    x2f = x[..., d // 2:].to(torch.float32)
    sin = sin[:, :, None, :].to(torch.float32)
    cos = cos[:, :, None, :].to(torch.float32)
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope_interleaved(x: torch.Tensor, sin: torch.Tensor,
                           cos: torch.Tensor) -> torch.Tensor:
    """RoPE with dimensions (2i, 2i+1) rotating together at frequency i
    (the pairing of DeepSeek-V3's and Kimi K2's code). As their code
    does, the pairs are laid out as rotate-half's halves (evens, then
    odds) and rotated there: the result keeps that layout, which leaves
    a product of two such tensors as the interleaved pairing gives it."""
    return apply_rope(torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1),
                      sin, cos)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, act: str = "swiglu",
             bias: bool = False, dtype=torch.float32, device="cpu"):
    names = ("gate", "up", "down") if act == "swiglu" else ("up", "down")
    dims = {"gate": (d_model, d_ff), "up": (d_model, d_ff),
            "down": (d_ff, d_model)}
    return {n: init_linear(gen, *dims[n], bias, dtype, device) for n in names}


def mlp(params, x, act: str = "swiglu"):
    if act == "swiglu":
        return linear(params["down"],
                      F.silu(linear(params["gate"], x)) * linear(params["up"], x))
    if act == "relu2":  # Nemotron-H's, ungated: relu(x up)^2
        return linear(params["down"], F.relu(linear(params["up"], x)).square())
    # jax.nn.gelu defaults to the tanh approximation
    return linear(params["down"],
                  F.gelu(linear(params["up"], x), approximate="tanh"))


def mlp_flops_per_token(d_model: int, d_ff: int, act: str = "swiglu") -> int:
    n_mats = 3 if act == "swiglu" else 2
    return 2 * n_mats * d_model * d_ff
