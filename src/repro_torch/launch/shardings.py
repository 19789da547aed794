"""Sharding rules (port of ``repro.launch.shardings``): parameters,
client banks, training and serving batches and KV / SSM caches laid over
a ``launch.mesh`` mesh.

Each rule returns a :class:`Sharding`: the mesh and one DTensor placement
per mesh dimension (``Shard(d)`` or ``Replicate()``), what
``DTensor.from_local`` / ``distribute_tensor`` take. A tensor dimension
split over several mesh axes carries ``Shard(d)`` on each of them, in
mesh order, which is pod-major as jax's ``P(("pod", "data"))`` is.
``Sharding.spec()`` reads the placements back per tensor dimension in
``PartitionSpec``'s terms (None, an axis name, or a tuple of names).

Parameters (the reference's policy, hillclimbed in EXPERIMENTS.md §Perf):

* client-side params: leading client axis over ("pod", "data"); within a
  client copy, tensor-parallel dims over "model";
* server-side params: tensor-parallel over "model"; with ``fsdp=True`` an
  additional large dim over "data" (ZeRO-3: all-gather per layer);
* MoE experts: expert dim over "data" when ``fsdp`` or
  ``expert_parallel``, else replicated across data with d_ff over
  "model";
* ``policy="fsdp2d"``: no tensor parallelism; every >= 2-D server weight
  flat-sharded over ("data", "model") on its largest dim.

The reference stacks each layer group's leaves along a leading
``repeat`` axis (``(repeat,) + shape``; client side ``(N, repeat) +
shape``) and its rules see the stacked leaf. The port keeps one leaf a
layer (``models.transformer``: a group is a list of ``repeat`` layers,
each a tuple of sublayers), and two rules answer differently on an
unstacked leaf. So a layer leaf's placement is the reference's spec for
its stacked group leaf with the repeat entry removed, e.g. on the (16,
16) mesh:

* a column-parallel bias: stacked ``(4, 512)`` gives ``P(None, None)``,
  so the layer's ``(512,)`` takes ``(None,)`` (evaluated alone it would
  take ``('model',)``); client-side ``(16, 4, 512)`` gives ``P('data',
  None, None)``, so ``(16, 512)`` takes ``('data', None)``;
* under ``fsdp2d`` a norm scale: stacked ``(32, 4096)`` gives ``P(None,
  ('data', 'model'))``, so the layer's ``(4096,)`` takes ``(('data',
  'model'),)`` (alone it would stay replicated). ``fsdp2d`` ranks the
  repeat axis among its candidate dims: where it picks that axis, the
  layer leaf is replicated.

Leaves outside layer groups (embedding, head, final norm, whisper's
per-layer lists, which the reference does not stack either) are
evaluated as they are. KV / SSM caches follow the same mapping
(``cache_shardings``). Dims are sharded only when divisible by the axis
size, otherwise replicated (e.g. MQA kv=1 heads).

Activations: batch/client dims over ("pod", "data"); KV caches batch over
("pod", "data"), kv-heads over "model" when divisible.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

from repro_torch.launch.mesh import (client_axes, mesh_shape,
                                     model_axis_size, n_client_shards)


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


def replicated(mesh, ndim: int) -> Sharding:
    """Every dim of an ``ndim``-dim tensor replicated on ``mesh``."""
    return _named(mesh, [None] * ndim)


def _client_spec(mesh):
    caxes = client_axes(mesh)
    return caxes if len(caxes) > 1 else caxes[0]


def _divisible(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


# ---------------------------------------------------------------------------
# Tree walking with paths and layer-group repeats
# ---------------------------------------------------------------------------

def _is_group(node) -> bool:
    """A layer group of the port's trees: a list of layers, each a plain
    tuple of sublayers (``[group][layer][sublayer]``). Whisper's layer
    lists hold dicts, and its caches NamedTuples: neither is a group."""
    return (isinstance(node, list) and len(node) > 0
            and all(type(x) is tuple for x in node))


def _children(node):
    """(path name, child) pairs: dict keys (sorted, jax's order), list and
    tuple indices as ``[i]``, NamedTuple fields by name."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    return [(f"[{i}]", c) for i, c in enumerate(node)]


def _rebuild(node, kids):
    if isinstance(node, dict):
        got = dict(zip(sorted(node), kids))
        return {k: got[k] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*kids)
    return type(node)(kids)


def map_with_path(fn, tree, path=(), repeat=None):
    """``fn(path, leaf, repeat)`` over every leaf of ``tree`` (dicts,
    lists, tuples, NamedTuples), in ``tree``'s structure. ``path`` holds
    the names of ``_children``; ``repeat`` is the layer count of the
    enclosing layer group (None outside one). Non-tensor leaves (a
    cache's Python ``length``) reach ``fn`` too."""
    if isinstance(tree, (dict, list, tuple)):
        rep = len(tree) if _is_group(tree) else repeat
        kids = [map_with_path(fn, c, path + (name,), rep)
                for name, c in _children(tree)]
        return _rebuild(tree, kids)
    return fn(path, tree, repeat)


def _stacked(shape, repeat, at):
    """``shape`` with the group's repeat axis inserted at ``at``."""
    return shape[:at] + (repeat,) + shape[at:]


def _unstacked(spec, at):
    return tuple(spec[:at]) + tuple(spec[at + 1:])


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

# param names whose -1 dim is tensor-parallel (column parallel)
_COL = {"wq", "wk", "wv", "gate", "up", "in_proj", "head"}
# param names whose -2 dim is tensor-parallel (row parallel)
_ROW = {"wo", "down", "out_proj"}
_EXPERT_COL = {"w_gate", "w_up"}  # (E, d, f): f over model
_EXPERT_ROW = {"w_down"}  # (E, f, d): f over model (dim -2)


def _path_names(path) -> Tuple[str, ...]:
    """A path as names: dict keys and NamedTuple fields as they are, list
    and tuple indices as ``[i]`` (what ``map_with_path`` gives)."""
    return tuple(str(p) for p in path)


def _fsdp2d_spec(names, shape, *, mesh, client: bool) -> list:
    ndim = len(shape)
    spec = [None] * ndim
    off = 0
    ms = mesh_shape(mesh)
    if client:
        spec[0] = _client_spec(mesh)
        off = 1
    if ndim - off < 2:
        return spec
    total = ms["model"] * ms.get("data", 1)
    # largest shardable dim (prefer the last dims, ties -> later dim)
    cand = sorted(range(off, ndim), key=lambda i: (shape[i], i))
    for i in reversed(cand):
        if client and _divisible(shape[i], ms["model"]):
            spec[i] = "model"  # client copies shard within their own devices
            return spec
        if not client and _divisible(shape[i], total):
            spec[i] = ("data", "model")
            return spec
        if not client and _divisible(shape[i], ms["model"]):
            spec[i] = "model"
            return spec
    return spec


def _tp_spec(names, shape, *, mesh, client: bool, fsdp: bool,
             expert_parallel: bool) -> list:
    msize = model_axis_size(mesh)
    dsize = mesh_shape(mesh).get("data", 1)
    ndim = len(shape)
    spec = [None] * ndim
    off = 0
    if client:
        spec[0] = _client_spec(mesh)
        off = 1

    owner = None  # param name that decides the policy
    for n in reversed(names):
        if n in _COL | _ROW | _EXPERT_COL | _EXPERT_ROW | {
                "table", "router", "conv_w", "conv_b"}:
            owner = n
            break
    leafname = names[-1] if names else ""

    def try_set(axis_idx: int, mesh_axis: str, size: int):
        ai = axis_idx if axis_idx >= 0 else ndim + axis_idx
        if ai >= off and spec[ai] is None and _divisible(shape[ai], size):
            spec[ai] = mesh_axis
            return True
        return False

    if leafname == "b" or ndim <= 1 + off:
        # biases / norms / scalars: shard long vectors over model when they
        # follow a column-parallel weight; otherwise replicate.
        if owner in _COL and ndim - off == 1:
            try_set(-1, "model", msize)
        return spec

    if owner == "table":  # embedding (vocab, d): vocab over model
        try_set(-2, "model", msize)
        if fsdp and not client:
            try_set(-1, "data", dsize)
    elif owner == "router":
        pass  # small; replicate
    elif owner in _EXPERT_COL:
        if expert_parallel:
            # expert parallelism: activations stay d-sharded through the
            # dispatch, so contract d locally (d over "model", f unsharded)
            try_set(-2, "model", msize)  # d
        else:
            try_set(-1, "model", msize)  # f
        if (expert_parallel or fsdp) and not client:
            try_set(-3, "data", dsize)  # E (client axis already owns "data")
    elif owner in _EXPERT_ROW:
        if expert_parallel:
            try_set(-1, "model", msize)  # d (output stays d-sharded)
        else:
            try_set(-2, "model", msize)  # f
        if (expert_parallel or fsdp) and not client:
            try_set(-3, "data", dsize)  # E
    elif owner in _COL:
        try_set(-1, "model", msize)
        if fsdp and not client:
            try_set(-2, "data", dsize)
    elif owner in _ROW:
        try_set(-2, "model", msize)
        if fsdp and not client:
            try_set(-1, "data", dsize)
    elif owner == "conv_w":
        try_set(-1, "model", msize)  # depthwise channels
    # everything else (norm scales, A_log, D, dt_bias): replicate
    return spec


def _layer_rule(rule, path, leaf, client: bool, repeat: Optional[int]):
    """``rule(names, shape)`` on the leaf as the reference stores it: a
    layer leaf (``repeat`` set) is evaluated on its stacked group shape
    and loses the repeat entry."""
    names = _path_names(path)
    shape = tuple(leaf.shape)
    if repeat is None:
        return rule(names, shape)
    at = 1 if client else 0
    return _unstacked(rule(names, _stacked(shape, repeat, at)), at)


def param_spec_fsdp2d(path, leaf, *, mesh, client: bool,
                      repeat: Optional[int] = None) -> Sharding:
    """"fsdp2d" policy: no tensor parallelism -- every >=2D server weight
    is flat-sharded over ("data", "model") on its largest dim and the
    batch is sharded over BOTH axes. Eliminates the per-layer Megatron
    activation all-reduces in exchange for per-layer param all-gathers;
    wins whenever layer params < activations (EXPERIMENTS.md §Perf).
    ``repeat``: the layer group's length for a layer leaf (module
    docstring)."""
    def rule(names, shape):
        return _fsdp2d_spec(names, shape, mesh=mesh, client=client)

    return _named(mesh, _layer_rule(rule, path, leaf, client, repeat))


def param_spec(path, leaf, *, mesh, client: bool, fsdp: bool = False,
               expert_parallel: bool = False, policy: str = "tp",
               repeat: Optional[int] = None) -> Sharding:
    """The placement of one parameter leaf (``path`` as
    ``map_with_path`` gives it; ``leaf`` needs only ``.shape``)."""
    if policy == "fsdp2d":
        return param_spec_fsdp2d(path, leaf, mesh=mesh, client=client,
                                 repeat=repeat)

    def rule(names, shape):
        return _tp_spec(names, shape, mesh=mesh, client=client, fsdp=fsdp,
                        expert_parallel=expert_parallel)

    return _named(mesh, _layer_rule(rule, path, leaf, client, repeat))


def param_shardings(tree, *, mesh, client: bool, fsdp: bool = False,
                    expert_parallel: bool = False, policy: str = "tp"):
    """A :class:`Sharding` for every leaf of ``tree`` (tensors, fake or
    meta tensors: only shapes are read), in ``tree``'s structure."""
    return map_with_path(
        lambda path, leaf, repeat: param_spec(
            path, leaf, mesh=mesh, client=client, fsdp=fsdp,
            expert_parallel=expert_parallel, policy=policy, repeat=repeat),
        tree)


def split_param_shardings(split_tree, *, mesh, fsdp: bool = False,
                          expert_parallel: bool = False, policy: str = "tp"):
    """Shardings for the {client, server} split layout of
    ``core.algorithms``."""
    return {
        "client": param_shardings(split_tree["client"], mesh=mesh,
                                  client=True,
                                  expert_parallel=expert_parallel,
                                  policy=policy),
        "server": param_shardings(split_tree["server"], mesh=mesh,
                                  client=False, fsdp=fsdp,
                                  expert_parallel=expert_parallel,
                                  policy=policy),
    }


# ---------------------------------------------------------------------------
# Banks, batches, caches
# ---------------------------------------------------------------------------

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
    (meta tensors will do). A layer group's per-layer cache leaves take
    their stacked leaf's placement without the repeat entry (module
    docstring); a cache's Python ``length`` takes None."""
    cax = _client_spec(mesh)
    msize = model_axis_size(mesh)
    csize = _client_size(mesh)
    dsize = mesh_shape(mesh).get("data", 1)

    def rule(shape):
        if len(shape) <= 1:  # stacked length scalars
            return [None] * len(shape)
        s = [None] * len(shape)
        # leading dim is the scan-stack (repeat); batch is dim 1
        if _divisible(shape[1], csize):
            s[1] = cax
        elif len(shape) == 5 and _divisible(shape[2], dsize) \
                and shape[2] > 1024:
            s[2] = "data"  # sequence-parallel KV cache
        if len(shape) == 5 and _divisible(shape[3], msize):
            s[3] = "model"
        return s

    def spec(path, leaf, repeat):
        if not hasattr(leaf, "shape"):
            return None
        shape = tuple(leaf.shape)
        if repeat is None:
            return _named(mesh, rule(shape))
        return _named(mesh, _unstacked(rule((repeat,) + shape), 0))

    return map_with_path(spec, cache_tree)
