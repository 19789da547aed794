"""Mamba-2 block (state-space duality, arXiv:2405.21060).

Port of ``repro.models.ssm``. ``ssd_chunked`` is the plain PyTorch form
of the chunked SSD algorithm (intra-chunk dual/quadratic form +
inter-chunk state recurrence); ``kernels.ops.ssd`` runs the intra-chunk
term through the hand-written Hopper kernel (B5) and is held against it.

Decode is O(1) per token: a single recurrent state update. The
depthwise causal convolution is a sum of ``conv_dim`` shifted products
rather than ``conv1d``, so that on the card it stays in full float32
(cuDNN convolutions default to TF32).

The port's own ``SSMConfig`` fields (Nemotron-H's): ``num_heads`` sets
the inner width to num_heads x head_dim in place of expand x d_model,
and ``norm_per_group`` takes the gated RMSNorm over each of the
``n_groups`` groups of d_inner / n_groups channels. B and C are (b, s,
n_groups, N) throughout, each group shared by heads / n_groups
consecutive heads.

The train forward opens the ``obs`` span ``mamba`` (projections, the
convolution, the gated norm) and, inside it, every SSD call opens
``ssd`` (the chunked scan); under remat both open again in the
backward's recompute.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import (init_linear, init_rmsnorm, linear,
                                       rmsnorm)


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, k-1, conv_channels) last raw inputs
    state: torch.Tensor  # (B, H, P, N) float32
    length: int          # tokens seen


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., q) -> (..., q, q): out[i, j] = sum_{j < m <= i} x[m]; -inf
    above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, -math.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int,
                initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n).

    Returns (y (b,s,h,p), final_state (b,h,p,n)). All math in fp32.

    Contracted per group: the heads are viewed as (g, r), r = h / g, and
    every product is batched over (batch, chunk, group), with a group's r
    heads in its rows or columns. So B and C are never repeated to the
    heads, C B^T is formed once a group, and the one per-head (l, s)
    tensor, L * C B^T, is built in the layout its product reads.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    c = s // chunk
    r = h // g
    dtf = dt.float()
    xdt = (x.float() * dtf[..., None]).reshape(b, c, chunk, g, r, p)
    Bc = B.float().reshape(b, c, chunk, g, n).transpose(2, 3)  # (b,c,g,q,n)
    Cc = C.float().reshape(b, c, chunk, g, n).transpose(2, 3)
    Ac = (dtf * A.float()).reshape(b, c, chunk, g, r).permute(0, 1, 3, 4, 2)
    A_cs = torch.cumsum(Ac, dim=-1)  # (b,c,g,r,q) log-decay

    # 1) intra-chunk (dual quadratic form): (L * C B^T) @ x
    CB = Cc @ Bc.transpose(-1, -2)  # (b,c,g,l,s)
    M = torch.exp(segsum(Ac)) * CB[:, :, :, None]  # (b,c,g,r,l,s)
    y_diag = M @ xdt.permute(0, 1, 3, 4, 2, 5)  # (b,c,g,r,l,p)

    # 2) chunk-final states: the decay folded into x, rows (r p) a group
    decay = torch.exp(A_cs[..., -1:] - A_cs).permute(0, 1, 4, 2, 3)
    xd = (xdt * decay[..., None]).transpose(2, 3).reshape(b, c, g, chunk,
                                                           r * p)
    states = (xd.transpose(-1, -2) @ Bc).reshape(b, c, h, p, n)

    # 3) inter-chunk recurrence via the chunk-level decay matrix
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=torch.float32,
                                    device=x.device)
    states = torch.cat([initial_state[:, None].float(), states], dim=1)
    A_last = A_cs[..., -1].reshape(b, c, h).transpose(1, 2)  # (b,h,c)
    chunk_decay = torch.exp(segsum(F.pad(A_last, (1, 0))))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4) inter-chunk contribution to outputs: C against the previous
    # states, columns (r p) a group, then each head's decay
    y_off = Cc @ prev_states.reshape(b, c, g, r * p, n).transpose(-1, -2)
    y_off = (y_off.reshape(b, c, g, chunk, r, p)
             * torch.exp(A_cs).transpose(-1, -2)[..., None])

    y = y_off.transpose(2, 3) + y_diag.permute(0, 1, 4, 2, 3, 5)
    return y.reshape(b, s, h, p).to(x.dtype), final_state


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """Single recurrent step. state:(b,h,p,n) x_t:(b,h,p) dt_t:(b,h)
    B_t,C_t:(b,g,n)."""
    rep = x_t.shape[1] // B_t.shape[1]
    Bf = B_t.float().repeat_interleave(rep, dim=1)  # (b,h,n)
    Cf = C_t.float().repeat_interleave(rep, dim=1)
    dtf = dt_t.float()
    dA = torch.exp(dtf * A.float())  # (b,h)
    upd = torch.einsum("bhp,bhn->bhpn", x_t.float() * dtf[..., None], Bf)
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cf)
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# Full Mamba-2 mixer block
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner, H = s.inner(cfg.d_model)
    conv_ch = d_inner + 2 * s.n_groups * s.state_dim
    return d_inner, H, conv_ch


def init_mamba2(gen, cfg: ModelConfig, dtype=torch.float32, device="cpu"):
    """The reference's distributions from a ``torch.Generator``."""
    s = cfg.ssm
    d_inner, H, conv_ch = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.state_dim + H
    in_proj = init_linear(gen, cfg.d_model, d_in_proj, False, dtype, device)
    conv_w = torch.empty((s.conv_dim, conv_ch), dtype=torch.float32,
                         device=device).normal_(generator=gen)
    u = torch.empty((H,), dtype=torch.float32,
                    device=device).uniform_(generator=gen)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w / math.sqrt(s.conv_dim)).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": dt_bias,
        "norm": init_rmsnorm(d_inner, dtype, device),
        "out_proj": init_linear(gen, d_inner, cfg.d_model, False, dtype,
                                device),
    }


def _split_in_proj(cfg: ModelConfig, zxbcdt):
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    gn = s.n_groups * s.state_dim
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, H], dim=-1)


def _causal_conv(w, b, x):
    """Depthwise causal conv. x: (B, S, CH); w: (k, CH). out[t] =
    sum_m w[m] x[t + m - (k - 1)], zero before the sequence start."""
    k, S = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    wf = w.float()
    out = xp[:, 0:S] * wf[0]
    for m in range(1, k):
        out = out + xp[:, m:m + S] * wf[m]
    return (out + b.float()).to(x.dtype)


def _ssm_inner(cfg, params, xBC_conv, dt_raw, use_kernel: bool,
               prev_state=None):
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    gn = s.n_groups * s.state_dim
    B_sz, S = xBC_conv.shape[:2]
    xs, Bm, Cm = torch.split(xBC_conv, [d_inner, gn, gn], dim=-1)
    x = xs.reshape(B_sz, S, H, s.head_dim)
    Bmat = Bm.reshape(B_sz, S, s.n_groups, s.state_dim)
    Cmat = Cm.reshape(B_sz, S, s.n_groups, s.state_dim)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    with obs.span("ssd"):
        y, final_state = _ssd_any_length(x, dt, A, Bmat, Cmat, s.chunk_size,
                                         prev_state, use_kernel)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * x
    return y.reshape(B_sz, S, d_inner), final_state


def _ssd_tail_sequential(x, dt, A, B, C, state):
    """O(S) recurrent sweep (``ssd_step`` token by token) -- the ragged
    tail of ``_ssd_any_length``. The same recurrence the decode path
    runs, so a prefill at any length hands decode the exact state it
    would have reached itself."""
    b, S, h, p = x.shape
    if state is None:
        state = torch.zeros((b, h, p, B.shape[-1]), dtype=torch.float32,
                            device=x.device)
    state = state.float()
    ys = []
    for t in range(S):
        y, state = ssd_step(state, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state


def _ssd_any_length(x, dt, A, B, C, chunk: int, prev_state,
                    use_kernel: bool):
    """SSD over an arbitrary sequence length: the chunk-aligned head runs
    the chunked form (``kernels.ops.ssd`` with ``use_kernel``: kernel B5
    on the card, its plain version on the CPU; else ``ssd_chunked``), the
    remainder runs the sequential recurrence seeded with the head's final
    state."""
    S = x.shape[1]
    s0 = (S // chunk) * chunk
    if s0 == S:
        if use_kernel:
            from repro_torch.kernels import ops as kops
            return kops.ssd(x, dt, A, B, C, chunk=chunk,
                            initial_state=prev_state)
        return ssd_chunked(x, dt, A, B, C, chunk=chunk,
                           initial_state=prev_state)
    state = prev_state
    if s0:
        y_head, state = _ssd_any_length(x[:, :s0], dt[:, :s0], A, B[:, :s0],
                                        C[:, :s0], chunk, state, use_kernel)
    y_tail, state = _ssd_tail_sequential(x[:, s0:], dt[:, s0:], A, B[:, s0:],
                                         C[:, s0:], state)
    if s0:
        y_tail = torch.cat([y_head, y_tail.to(y_head.dtype)], dim=1)
    return y_tail.to(x.dtype), state


def _gated_norm(params, cfg: ModelConfig, y, z):
    """rmsnorm(y * silu(z)) over the inner width, or with
    ``ssm.norm_per_group`` over each group of d_inner / n_groups
    channels."""
    h = y * F.silu(z)
    s = cfg.ssm
    if not s.norm_per_group:
        return rmsnorm(params["norm"], h, cfg.norm_eps)
    scale = {"scale": params["norm"]["scale"].unflatten(-1, (s.n_groups, -1))}
    return rmsnorm(scale, h.unflatten(-1, (s.n_groups, -1)),
                   cfg.norm_eps).flatten(-2)


def mamba2_train(params, cfg: ModelConfig, x, use_kernel: bool = False):
    """x: (B, S, d_model) -> (B, S, d_model), inside the span ``mamba``."""
    with obs.span("mamba"):
        zxbcdt = linear(params["in_proj"], x)
        z, xBC, dt_raw = _split_in_proj(cfg, zxbcdt)
        xBC = F.silu(_causal_conv(params["conv_w"], params["conv_b"], xBC))
        y, _ = _ssm_inner(cfg, params, xBC, dt_raw, use_kernel)
        return linear(params["out_proj"], _gated_norm(params, cfg, y, z))


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cpu") -> SSMCache:
    s = cfg.ssm
    d_inner, H, conv_ch = _dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, s.conv_dim - 1, conv_ch), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, H, s.head_dim, s.state_dim),
                          dtype=torch.float32, device=device),
        length=0,
    )


def mamba2_prefill(params, cfg: ModelConfig, x):
    """x: (B, S, d_model). Returns (y, SSMCache of the last conv inputs
    and the final state). The chunk-aligned head runs ``kernels.ops.ssd``
    (kernel B5 on the card), as the reference's serve engine asks of its
    prefill."""
    s = cfg.ssm
    zxbcdt = linear(params["in_proj"], x)
    z, xBC_raw, dt_raw = _split_in_proj(cfg, zxbcdt)
    xBC = F.silu(_causal_conv(params["conv_w"], params["conv_b"], xBC_raw))
    y, final_state = _ssm_inner(cfg, params, xBC, dt_raw, use_kernel=True)
    y = _gated_norm(params, cfg, y, z)
    # the last k-1 raw inputs, zero-padded in front for prompts shorter
    # than that (the reference's slice would be shorter and break decode)
    hist = F.pad(xBC_raw, (0, 0, max(0, s.conv_dim - 1 - x.shape[1]), 0))
    cache = SSMCache(conv=hist[:, -(s.conv_dim - 1):, :], state=final_state,
                     length=x.shape[1])
    return linear(params["out_proj"], y), cache


def mamba2_decode(params, cfg: ModelConfig, x, cache: SSMCache):
    """x: (B, 1, d_model). One recurrent step."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    gn = s.n_groups * s.state_dim
    zxbcdt = linear(params["in_proj"], x[:, 0, :])  # (B, ...)
    z, xBC_t, dt_raw = _split_in_proj(cfg, zxbcdt)
    # conv step over the last conv_dim inputs
    hist = torch.cat([cache.conv, xBC_t[:, None, :]], dim=1)  # (B, k, CH)
    xBC = (hist.float() * params["conv_w"].float()).sum(dim=1)
    xBC = F.silu(xBC + params["conv_b"].float()).to(x.dtype)
    xs, Bm, Cm = torch.split(xBC, [d_inner, gn, gn], dim=-1)
    x_t = xs.reshape(-1, H, s.head_dim)
    B_t = Bm.reshape(-1, s.n_groups, s.state_dim)
    C_t = Cm.reshape(-1, s.n_groups, s.state_dim)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y_t, new_state = ssd_step(cache.state, x_t, dt, A, B_t, C_t)
    y_t = y_t + params["D"].to(y_t.dtype)[None, :, None] * x_t
    y = y_t.reshape(-1, 1, d_inner)
    y = _gated_norm(params, cfg, y, z[:, None, :])
    new_cache = SSMCache(conv=hist[:, 1:, :], state=new_state,
                         length=cache.length + 1)
    return linear(params["out_proj"], y), new_cache


def ssm_flops_per_token(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d_inner, H, conv_ch = _dims(cfg)
    gn = s.n_groups * s.state_dim
    f = 2 * cfg.d_model * (2 * d_inner + 2 * gn + H)  # in_proj
    f += 2 * conv_ch * s.conv_dim  # conv
    f += 2 * d_inner * s.state_dim * 2  # state update + output (amortized)
    f += 2 * d_inner * s.chunk_size * 2  # intra-chunk dual form (amortized)
    f += 2 * d_inner * cfg.d_model  # out_proj
    return f
