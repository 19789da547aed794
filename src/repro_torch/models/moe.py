"""Mixture-of-Experts layer: top-k router + capacity-bounded scatter
dispatch.

Port of ``repro.models.moe``. Dispatch is a scatter-add into an (E * C +
1, d) buffer and a gather back (not the GShard one-hot einsum), so the
expert products do only the useful work. Tokens beyond an expert's
capacity C are dropped (Switch/GShard semantics, ``capacity_factor``
configurable): they land in the slack row ``E * C``, which is discarded.

The position-in-expert count (``kernels/ops.py`` ``moe_positions``) runs
on the card as M2 (``kernels/moe_count.py``): one launch reads each
pair's expert id once and writes its position once, where the plain
expression scans a (T k, E) one-hot. Elsewhere it is that expression op
for op; both give the same integers.

The combine (``kernels/ops.py`` ``moe_combine``) runs on the card as M1
(``kernels/moe_combine.py``): one launch over every routing group reads
each kept pair's row of the expert products' output where it lies, with
no zero row appended, and its backward writes each row once, with no
sort and no atomics. Elsewhere (the CPU, other dtypes, the dry run's
DTensors, dispatch modes) it is the gather and ``einsum`` over a zero
row appended for the slack, op for op as before M1.

Expert weights have shape (E, d, f) and (E, f, d); the expert FFN is
SwiGLU (``w_gate``, ``w_up``, ``w_down``), or with ``cfg.mlp_act``
"relu2" (Nemotron-H's) the ungated down(relu(x up)^2) of ``w_up`` and
``w_down``, the shared expert likewise; batched over experts through ``kernels/ops.py`` ``matmul``: on
G1 where each expert holds a tile of rows (capacity >= ``gemm.BM``) and
its rule holds, under ``vmap`` with the clients x experts as the
kernel's batch; elsewhere (the CPU, smaller capacities, the dry run's
DTensors, dispatch modes) ``torch.bmm`` as before. The reference pins the
dispatched tokens to an expert mesh axis (``cfg.expert_axis``); on one
device that constraint is the identity. Over DTensors (the dry run) the
port pins them likewise (``_expert_pinned``), makes the routing groups
whole on every rank before its loop over them (``_whole_groups``), and
keeps the token views in the input's layout (``_tokens``).

Three choices keep the port on the reference's numbers:

* top-k breaks ties to the lower expert index, as ``jax.lax.top_k``
  does (``torch.topk`` does not promise an order among equal values), so
  the k largest probabilities are taken from a stable descending sort;
* the position-in-expert count compares indices with ``arange(E)``
  instead of ``F.one_hot`` (which ``torch.func.vmap`` cannot batch: the
  train step runs the client forward under vmap, so routing and capacity
  are per client, as under the reference's ``jax.vmap``);
* above ``MOE_GLOBAL_CHUNK`` tokens the sequence is cut into chunks with
  the reference's zero padding, one Python iteration a chunk where the
  reference runs ``lax.scan``; capacity is per chunk, as there (and a
  sequence-wise balance loss takes the chunk's slices as its
  sequences).

A layer may hold a share of the experts (``MoEConfig.experts_held`` from
``expert_offset``; the port's own, all of them by default): expert
parallelism's layer, without its exchange. It routes over all
``num_experts`` (the balance loss too), puts its capacity on the whole
count, and dispatches, computes and combines only the (token, choice)
pairs routed to its own experts, whose weights are (held, d, f); what
the other experts would add is left out, and the shared expert is added
once. At the default every tensor and launch is the unshared layer's.

The router is the reference's (a softmax, its top-k renormalised, the
Switch balance loss) at ``MoEConfig``'s default. The port's own
``router="sigmoid"`` (DeepSeek-V3's, Kimi K2's) takes sigmoid scores,
chooses the top-k on the scores plus the per-expert ``correction_bias``
leaf, which takes no gradient (the step's ``autograd.grad`` gives it
none, so sgd leaves it as it is), gates with the chosen experts'
unbiased scores renormalised and times ``routed_scaling``, and gives the
sequence-wise balance loss: per sequence of S tokens, sum_i f_i P_i with
f_i = E / (k S) times the sequence's pairs routed to i and P_i the
sequence's mean of s_i / sum_j s_j, averaged over the sequences.

Each forward opens the ``obs`` span ``moe`` (router, dispatch, combine,
shared expert) and inside it ``moe_experts`` (the held experts' products
and their activation); under remat both open again in the backward's
recompute. Where the active recorder keeps counters
(``obs.takes_counters``) a forward outside ``vmap`` (the server's
layers; a client's, under the train step's ``vmap``, would hand the
recorder a batched tensor) adds ``moe_expert_rows``, the rows the
expert products compute (held x C, a host int), and ``moe_pairs_kept``,
the pairs routed here that fit (a device tensor: no host sync).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import is_dtensor, obs, relaid
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels import ops
from repro_torch.models.blocks import _normal, init_linear, init_mlp, \
    linear, mlp


def init_moe(gen, cfg: ModelConfig, dtype=torch.float32, device="cpu"):
    m = cfg.moe
    d, f, E, n = cfg.d_model, m.d_ff_expert, m.num_experts, m.held
    names = ("w_gate", "w_up") if cfg.mlp_act == "swiglu" else ("w_up",)
    p = {"router": init_linear(gen, d, E, False, dtype, device)}
    for name in names:
        p[name] = _normal((n, d, f), gen, device, 1.0 / math.sqrt(d), dtype)
    p["w_down"] = _normal((n, f, d), gen, device, 1.0 / math.sqrt(f), dtype)
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, d, m.shared_width, cfg.mlp_act, False,
                               dtype, device)
    if m.router == "sigmoid":
        p["correction_bias"] = torch.zeros((E,), dtype=dtype, device=device)
    return p


def _capacity(m: MoEConfig, num_tokens: int) -> int:
    return max(1, int(math.ceil(m.top_k * num_tokens * m.capacity_factor
                                / m.num_experts)))


def route(params, m: MoEConfig, x2d, seq: int = 0) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (expert_idx (T, k) int64, gates (T, k), aux_loss ()).
    ``seq`` is the length of the sequences x2d's rows run in, which the
    sequence-wise balance loss reads."""
    logits = linear(params["router"], x2d).float()  # (T, E)
    sigmoid = m.router == "sigmoid"
    probs = torch.sigmoid(logits) if sigmoid else torch.softmax(logits, -1)
    key = probs
    if sigmoid:  # the bias chooses; it neither gates nor trains
        key = probs.detach() + params["correction_bias"].detach().float()
    # jax.lax.top_k's order: larger first, ties to the lower index
    srt, order = torch.sort(key, dim=-1, descending=True, stable=True)
    gates, idx = srt[:, :m.top_k], order[:, :m.top_k]
    if sigmoid:
        gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    if m.routed_scaling != 1.0:
        gates = gates * m.routed_scaling
    if sigmoid:
        return idx, gates.to(x2d.dtype), _sequence_loss(m, probs, idx, seq)
    # Switch-style load-balance auxiliary loss: me carries the gradient,
    # ce (the routed share of each expert) is a count and has none
    me = probs.mean(0)
    hits = idx.reshape(-1)[:, None] == torch.arange(
        m.num_experts, device=idx.device)
    ce = (hits.float() * (1.0 / idx.numel())).sum(0)
    aux = m.num_experts * torch.sum(me * ce)
    return idx, gates.to(x2d.dtype), aux


def _sequence_loss(m: MoEConfig, probs, idx, seq: int):
    """DeepSeek-V3's sequence-wise balance loss over the (T / seq, seq)
    sequences of the rows, averaged over them: P carries the gradient, f
    is a count and has none."""
    T, E = probs.shape
    if seq < 1 or T % seq:
        raise ValueError(f"the sequence-wise balance loss needs whole "
                         f"sequences: {T} rows in sequences of {seq}")
    p = (probs / probs.sum(-1, keepdim=True)).reshape(T // seq, seq, E)
    hits = idx.reshape(T // seq, seq * m.top_k, 1) == torch.arange(
        E, device=idx.device)
    f = hits.sum(1).float() * (E / (m.top_k * seq))
    return torch.sum(f * p.mean(1), dim=-1).mean()


# Tokens are processed in chunks of at most this many (global) tokens, as
# in the reference: the dispatch buffers and the position-in-expert count
# stay O(chunk * E). Chunking runs along the sequence axis.
MOE_GLOBAL_CHUNK = 65536


def _dispatch(params, m: MoEConfig, x2d, C: int, seq: int = 0):
    """One routing group: route, count each (token, choice)'s position in
    its expert, and scatter the kept ones routed to the held experts into
    the (held, C, d) buffer. Returns (buffer, slot (T, k), gates (T, k),
    keep (T, k), aux)."""
    T, d = x2d.shape
    E, k, n = m.num_experts, m.top_k, m.held
    idx, gates, aux = route(params, m, x2d, seq)
    pos = ops.moe_positions(idx, E)
    keep = pos < C
    if n < E:  # a share: the pairs routed to the experts held here
        off = m.expert_offset
        keep = keep & (idx >= off) & (idx < off + n)
        idx = idx - off
    slot = torch.where(keep, idx * C + pos, n * C)
    # each kept slot is unique (add == set); the slack row takes the drops
    xk = x2d[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf = torch.zeros((n * C + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf = buf.index_add(0, slot.reshape(-1), xk)
    return buf[:n * C].reshape(n, C, d), slot, gates, keep, aux


def _whole_groups(t):
    """The (G, Tg, d) routing groups, whole on every rank where the model
    runs over DTensors (the dry run): DTensor unbinds no sharded dim, and
    the groups are split over the rows' shards. The identity on a plain
    tensor."""
    if not is_dtensor(t) or not any(p.is_shard() and p.dim == 0
                                    for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate

    return relaid(t, lambda p, _: Replicate() if p.is_shard() and p.dim == 0
                  else p)


def _expert_pinned(t, axis):
    """The reference's expert-parallel constraint (``with_sharding_
    constraint(t, P(expert_axis, None, "model"))``) on the (E, C, d)
    dispatched tokens, where the model runs over DTensors and
    ``cfg.expert_axis`` is set; the identity otherwise."""
    if axis is None or not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    return relaid(t, lambda _, n: Shard(0) if n == axis
                  else Shard(2) if n == "model" else Replicate())


def _moe_chunk(params, cfg: ModelConfig, x2d, seq: int = 0):
    """Dispatch + expert compute + combine for one token chunk of
    sequences of ``seq`` rows. Routing, positions and capacity are per
    group (``cfg.routing_groups`` when it divides T, else one group, the
    global GShard capacity)."""
    m = cfg.moe
    T, d = x2d.shape
    n = m.held
    G = cfg.routing_groups if (cfg.routing_groups > 1
                               and T % cfg.routing_groups == 0) else 1
    Tg = T // G
    Cg = _capacity(m, Tg)
    groups = [_dispatch(params, m, xg, Cg, seq)
              for xg in _whole_groups(x2d.reshape(G, Tg, d)).unbind(0)]
    counting = obs.takes_counters() and \
        not torch._C._functorch.is_batchedtensor(x2d)
    if counting:
        obs.counter("moe_expert_rows", n * G * Cg)
        obs.counter("moe_pairs_kept",
                    torch.stack([g[3].sum() for g in groups]).sum())
    # group-major -> expert-major (on many devices, the all-to-all)
    xe = torch.stack([g[0] for g in groups], 1).reshape(n, G * Cg, d)
    xe = _expert_pinned(xe, cfg.expert_axis)

    # expert FFN (SwiGLU or relu^2), batched over experts
    with obs.span("moe_experts"):
        if cfg.mlp_act == "swiglu":
            h = ops.matmul(xe, params["w_gate"].to(x2d.dtype))
            u = ops.matmul(xe, params["w_up"].to(x2d.dtype))
            h = F.silu(h) * u
        else:
            h = F.relu(ops.matmul(xe, params["w_up"].to(x2d.dtype))).square()
        ye = ops.matmul(h, params["w_down"].to(x2d.dtype))
    ye = _expert_pinned(ye, cfg.expert_axis)

    # combine: each (token, choice)'s row, weighted and summed
    y = ops.moe_combine(ye, [g[1] for g in groups], [g[2] for g in groups],
                        [g[3] for g in groups])

    if m.num_shared_experts:
        y = y + mlp(params["shared"], x2d, cfg.mlp_act)
    aux = torch.stack([g[4] for g in groups]).mean()
    return y, aux


def _tokens(t, x):
    """``t``, a (tokens, d) view of ``x``'s (B, S, d) rows, laid out as
    ``x`` is where the model runs over DTensors (the dry run): B's shards
    become the rows', d's stay d's, anything else is replicated. The
    dispatch leaves its tokens, and their gradient, sharded over every
    mesh axis, which DTensor cannot view back into (B, S, d) rows when B
    is the smaller. The identity on a plain tensor."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    last = x.dim() - 1
    return relaid(t, lambda p, _: Shard(0) if p.is_shard() and p.dim == 0
                  else Shard(1) if p.is_shard() and p.dim == last
                  else Replicate(), like=x)


def moe_apply(params, cfg: ModelConfig, x) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss), inside the span ``moe``."""
    with obs.span("moe"):
        return _moe_apply(params, cfg, x)


def _moe_apply(params, cfg: ModelConfig, x):
    B, S, d = x.shape
    T = B * S
    if T <= MOE_GLOBAL_CHUNK:
        y, aux = _moe_chunk(params, cfg, _tokens(x.reshape(T, d), x), S)
        return _tokens(y, x).reshape(B, S, d), aux
    seq_chunk = max(1, MOE_GLOBAL_CHUNK // B)
    n_chunks = -(-S // seq_chunk)
    pad = n_chunks * seq_chunk - S
    xp = F.pad(x, (0, 0, 0, pad))
    ys, auxs = [], []
    for c in range(n_chunks):
        xi = xp[:, c * seq_chunk:(c + 1) * seq_chunk]
        y, aux = _moe_chunk(params, cfg,
                            _tokens(xi.reshape(B * seq_chunk, d), x),
                            seq_chunk)
        ys.append(_tokens(y, x).reshape(B, seq_chunk, d))
        auxs.append(aux)
    y = torch.cat(ys, 1)[:, :S]
    return y, torch.stack(auxs).mean()


def moe_flops_per_token(cfg: ModelConfig) -> int:
    """Useful (active-parameter) FLOPs per token, excluding dropped-token
    slack; of a share of the experts, the expected top_k x held /
    num_experts choices a token that it computes."""
    m = cfg.moe
    nm = 3 if cfg.mlp_act == "swiglu" else 2  # weight matrices an expert
    f = 2 * nm * cfg.d_model * m.d_ff_expert * m.top_k * m.held \
        // m.num_experts
    f += 2 * cfg.d_model * m.num_experts  # router
    if m.num_shared_experts:
        f += 2 * nm * cfg.d_model * m.shared_width
    return f
