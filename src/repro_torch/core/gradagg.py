"""The paper's core op: aggregated smashed-data gradient broadcast (eq. 5).

Port of ``repro.core.gradagg``. ``gradagg(x, rho)`` is the SFL-GA
boundary operator:

* forward: identity on the smashed data (N, ...);
* backward: each client's cotangent s^n is replaced by the aggregate
  s = sum_n rho^n s^n (``kernels.ops.grad_agg``, kernel B1 on the card),
  broadcast to every client as an expanded view -- the N copies are never
  materialized.

``make_gradagg_compressed`` adds the lossy transport on both directions
of the cut; ``client_param_average`` is the client-side model
aggregation of traditional SFL, which SFL-GA removes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compress import broadcast_channel, get_codec, uplink_channel
from repro_torch.kernels import ops
from repro_torch.tree import tree_map


def _aggregate_broadcast(g, rho, codec=None, seed=0):
    agg = ops.grad_agg(g.float(), rho.float())
    if codec is not None:
        agg = broadcast_channel(codec, agg, seed)
    return agg.to(g.dtype).unsqueeze(0).expand(g.shape)


class _GradAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rho):
        ctx.save_for_backward(rho)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (rho,) = ctx.saved_tensors
        return _aggregate_broadcast(g, rho), torch.zeros_like(rho)


def gradagg(x: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """x: (N, ...) per-client smashed data; rho: (N,) aggregation weights."""
    return _GradAgg.apply(x, rho)


class _GradAggCompressed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rho, up, down, seed):
        ctx.save_for_backward(rho)
        ctx.down, ctx.seed = down, seed
        y = uplink_channel(up, x, seed)
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        (rho,) = ctx.saved_tensors
        gb = _aggregate_broadcast(g, rho, ctx.down, ctx.seed)
        return gb, torch.zeros_like(rho), None, None, None


def make_gradagg_compressed(uplink=None, downlink=None):
    """Codec-aware ``gradagg``: forward sends each client's smashed data
    through the ``uplink`` channel (the server computes against the
    reconstruction); backward sends the rho-aggregate through the
    ``downlink`` codec ONCE and broadcasts it. Returns ``f(x, rho,
    seed=0)``; pass a fresh uint32 seed each round. With both codecs
    passthrough this is ``gradagg``, bit for bit."""
    up = get_codec(uplink)
    down = get_codec(downlink)

    def gradagg_c(x, rho, seed=0):
        return _GradAggCompressed.apply(x, rho, up, down, int(seed))

    return gradagg_c


def uniform_rho(n: int, device="cpu") -> torch.Tensor:
    return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)


def client_param_average(params, rho: Optional[torch.Tensor] = None):
    """Traditional-SFL client-side model aggregation: rho-weighted mean
    over the leading client axis of every leaf, broadcast back (a new
    tensor per leaf). ``params`` is any tree of tensors with a leading
    client axis."""

    def avg(p):
        n = p.shape[0]
        w = (uniform_rho(n, p.device) if rho is None else rho).reshape(
            (n,) + (1,) * (p.ndim - 1))
        m = torch.sum(p.float() * w, dim=0, keepdim=True)
        return m.expand(p.shape).to(p.dtype).clone()

    return tree_map(avg, params)
