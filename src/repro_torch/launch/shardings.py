"""Sharding rules, the bank and batch half (port of
``repro.launch.shardings``): client banks, training and serving batches
and KV / SSM caches laid over a ``launch.mesh`` mesh.

Each rule returns a :class:`Sharding`: the mesh and one DTensor placement
per mesh dimension (``Shard(d)`` or ``Replicate()``), what
``DTensor.from_local`` / ``distribute_tensor`` take. A tensor dimension
split over several mesh axes carries ``Shard(d)`` on each of them, in
mesh order, which is pod-major as jax's ``P(("pod", "data"))`` is.
``Sharding.spec()`` reads the placements back per tensor dimension in
``PartitionSpec``'s terms (None, an axis name, or a tuple of names).

Activations: batch/client dims over ("pod", "data"); KV caches batch over
("pod", "data"), kv-heads over "model" when divisible. Dims are sharded
only when divisible by the axis size, otherwise replicated (e.g. MQA kv=1
heads).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

from repro_torch.launch.mesh import (client_axes, mesh_shape,
                                     model_axis_size, n_client_shards)
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class Sharding:
    """A mesh and one DTensor placement per mesh dimension, for a tensor
    of ``ndim`` dimensions (jax's ``NamedSharding``)."""
    mesh: Any
    placements: Tuple[Any, ...]
    ndim: int

    def spec(self) -> Tuple:
        """Per tensor dimension: None, the mesh axis that splits it, or
        the tuple of axes (mesh order) -- a ``PartitionSpec``'s entries."""
        from torch.distributed.tensor import Shard

        out = []
        for d in range(self.ndim):
            axes = tuple(a for a, p in zip(self.mesh.mesh_dim_names,
                                           self.placements)
                         if isinstance(p, Shard) and p.dim == d)
            out.append(None if not axes else axes[0] if len(axes) == 1
                       else axes)
        return tuple(out)


def _named(mesh, spec: Sequence) -> Sharding:
    """``spec`` (one entry per tensor dim, as a PartitionSpec's) as DTensor
    placements on ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    def dim_of(axis: str) -> Optional[int]:
        for d, s in enumerate(spec):
            if s == axis or (isinstance(s, tuple) and axis in s):
                return d
        return None

    placements = []
    for axis in mesh.mesh_dim_names:
        d = dim_of(axis)
        placements.append(Replicate() if d is None else Shard(d))
    return Sharding(mesh, tuple(placements), len(spec))


def _client_spec(mesh):
    caxes = client_axes(mesh)
    return caxes if len(caxes) > 1 else caxes[0]


def _divisible(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def bank_sharding(mesh, ndim: int) -> Sharding:
    """(N, ...) client-bank leaves (``core.bank`` sharded backend): the
    leading client axis over the mesh's client axes, everything else
    replicated -- bank entries are whole per-client copies, so the only
    parallelism that helps is across clients."""
    return _named(mesh, [_client_spec(mesh)] + [None] * (ndim - 1))


def _client_size(mesh) -> int:
    return n_client_shards(mesh)


def batch_sharding(mesh, ndim: int, policy: str = "tp") -> Sharding:
    """(N, b, S[, d]) batches: client axis over ("pod", "data"); under
    "fsdp2d" the per-client batch additionally shards over "model"."""
    spec = [_client_spec(mesh)] + [None] * (ndim - 1)
    if policy == "fsdp2d" and ndim >= 2:
        spec[1] = "model"
    return _named(mesh, spec)


def serve_batch_sharding(mesh, ndim: int,
                         batch: Optional[int] = None) -> Sharding:
    """(B, ...) serving batches: batch over ("pod", "data") when divisible,
    replicated otherwise (long_500k decodes a single stream)."""
    if batch is not None and batch % _client_size(mesh) != 0:
        return _named(mesh, [None] * ndim)
    return batch_sharding(mesh, ndim)


def cache_shardings(cache_tree, mesh):
    """KV caches (repeat, B, cap, Hkv, hd) / SSM states: batch over client
    axes when divisible; else sequence-parallel KV (cap dim over "data" --
    how a single 524k-token stream fits); kv-heads over model when
    divisible (MQA kv=1 stays replicated). Leaves need only ``.shape``
    (meta tensors will do)."""
    cax = _client_spec(mesh)
    msize = model_axis_size(mesh)
    csize = _client_size(mesh)
    dsize = mesh_shape(mesh).get("data", 1)

    def spec(leaf):
        shape = tuple(leaf.shape)
        if len(shape) <= 1:  # stacked length scalars
            return _named(mesh, [None] * len(shape))
        s = [None] * len(shape)
        # leading dim is the scan-stack (repeat); batch is dim 1
        if _divisible(shape[1], csize):
            s[1] = cax
        elif len(shape) == 5 and _divisible(shape[2], dsize) \
                and shape[2] > 1024:
            s[2] = "data"  # sequence-parallel KV cache
        if len(shape) == 5 and _divisible(shape[3], msize):
            s[3] = "model"
        return _named(mesh, s)

    return tree_map(spec, cache_tree)
