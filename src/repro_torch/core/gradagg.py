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

import math
from typing import Optional

import torch

from repro_torch import is_dtensor, obs, placed_like, reduce_partial
from repro_torch.compress import broadcast_channel, get_codec, uplink_channel
from repro_torch.kernels import ops
from repro_torch.tree import tree_map


def _grad_agg(g, rho):
    """eq. 5 (``ops.grad_agg``). On a DTensor ``g`` whose client dim 0 is
    sharded over mesh axes (the dry run's, ``launch.specs``), each rank
    aggregates its own clients' rows of the local shard, and one
    all-reduce over those axes makes the aggregate whole: indexing the
    sharded client dim would make DTensor gather every client's rows to
    every rank. The other axes' placements carry over."""
    if not is_dtensor(g):
        return ops.grad_agg(g, rho)
    from torch.distributed.tensor import DTensor, Partial, Shard

    mesh = g.device_mesh
    caxes = [i for i, p in enumerate(g.placements)
             if p.is_shard() and p.dim == 0]
    if any(type(g.placements[i]) is not Shard for i in caxes):
        raise ValueError(f"client dim of g sharded as {g.placements}")
    if is_dtensor(rho):
        rho = rho.full_tensor()
    local = g.to_local()
    rows = local.shape[0]
    # this rank's first client: its coordinate on the client axes,
    # row-major in mesh order
    coord = mesh.get_coordinate()
    block = 0
    for i in caxes:
        block = block * mesh.size(i) + coord[i]
    part = ops.grad_agg(local, rho[block * rows:(block + 1) * rows])
    shape = tuple(g.shape[1:])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return reduce_partial(DTensor.from_local(
        part, mesh, [Partial() if i in caxes
                     else Shard(p.dim - 1) if p.is_shard() else p
                     for i, p in enumerate(g.placements)],
        run_check=False, shape=shape, stride=stride))


def _aggregate_broadcast(g, rho, codec=None, seed=0):
    """The downlink: eq. 5's aggregate, its codec, the broadcast (the
    ``downlink`` span, run by autograd's engine inside ``backward``)."""
    with obs.span("downlink"):
        agg = _grad_agg(g.float(), rho.float())
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
        # over DTensors (the dry run) the sum is one all-reduce over the
        # client axes, and each rank keeps its own rows of the broadcast
        m = reduce_partial(torch.sum(p.float() * w, dim=0, keepdim=True))
        return placed_like(m.expand(p.shape), p).to(p.dtype).clone()

    return tree_map(avg, params)
