"""Dry-run case construction (port of ``repro.launch.specs``): (step fn,
fake-tensor args, shardings) for every (architecture x input-shape x
mesh) cell.

No storage is ever allocated here: params, optimizer state, caches and
inputs are fake tensors (``torch._subclasses.FakeTensorMode``) on the
CPU, in the reference's dtype (bf16, ints int32), each with the global
shape the reference's ``ShapeDtypeStruct`` has. Where the reference
stacks a layer group along a leading ``repeat`` axis the port has one
leaf a layer (``models.transformer``), and its shardings are the stacked
leaf's without the repeat entry (``launch.shardings``).

The reference lowers a case with ``jax.jit(fn, in_shardings=...)``. Its
counterpart here is :meth:`DryRunCase.run`: each arg becomes a DTensor
of its rank-local shard on the case's mesh (``DTensor.from_local``, no
collective) and ``fn`` runs once over them, eagerly, under the case's
fake mode, with plain tensors made inside the model taken as replicated
(``implicit_replication``). Outputs that hold a pending reduction
(``Partial``) are reduced, as a compiled step's outputs are.

A train case's step rematerializes each layer when ``remat`` is set (the
default, as in the reference; ``TrainConfig.remat``), so the recompute's
FLOPs and collectives are counted and its peak live storage is remat's.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import reduce_partial
from repro_torch.analysis.roofline import around_sharding_propagation
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig, TrainConfig
from repro_torch.core import algorithms as alg
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import client_axes, mesh_shape, n_client_shards
from repro_torch.models import encdec, lm
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_map

# archs whose server params must be FSDP-sharded over "data" (too big for
# model-axis-only sharding on 16 GB chips)
FSDP_ARCHS = {"command-r-35b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
              "granite-20b", "kimi-k2-1t-a32b"}

# long_500k policy (DESIGN.md §5): native for ssm/hybrid/sliding-window;
# sliding-window serving variant for other decoder-only archs; whisper skips.
LONG_SKIP = {"whisper-tiny"}
SLIDING_FOR_LONG = 4096

_DT = torch.bfloat16
_INT = torch.int32


@dataclass
class DryRunCase:
    arch: str
    shape: str
    kind: str  # train | prefill | decode
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    meta: Dict[str, Any] = field(default_factory=dict)
    # the FakeTensorMode that made ``args``; ``run`` computes under it
    mode: Any = None

    def distribute(self):
        """``args`` as DTensors: each fake leaf's rank-local shard under
        its ``Sharding``'s placements, with the global shape and strides
        (``DTensor.from_local``; no data moves). Leaves without a
        sharding (a cache's Python ``length``) pass through."""
        return tuple(_distribute(a, s) for a, s in zip(self.args,
                                                       self.in_shardings))

    def run(self, *modes, args=None):
        """Run ``fn`` once over the distributed args (``args``, or
        ``distribute()``'s), under the case's fake mode and then
        ``modes`` (a counting mode, a tracker), the last innermost.
        Returns the outputs, Partial placements reduced."""
        with self.mode, _dtensor_under_fake(), \
                contextlib.ExitStack() as stack:
            dargs = self.distribute() if args is None else args
            for m in modes:
                stack.enter_context(m)
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                out = self.fn(*dargs)
                return tree_map(reduce_partial, out)


@contextlib.contextmanager
def _dtensor_under_fake():
    """How DTensor runs a case:

    * its sharding propagation, and the shard arithmetic of a strided
      shard (a merged dim of which an inner part is sharded), make small
      index tensors of their own and read them back; under the case's
      fake mode they would be fake, and unreadable, so both run with the
      fake mode unset (propagation's shape inference makes a fake mode of
      its own);
    * ``view`` (what ``reshape`` becomes under autograd) may split a dim
      whose shards do not divide the new sizes (8 kv heads over a
      "model" axis of 16). DTensor refuses that for ``view``; XLA, and
      DTensor's own ``reshape`` rule, regather the dim first. The case
      runs ``view`` and ``_unsafe_view`` under the ``reshape`` rule;
    * that rule may put more shards on an unflattened dim than its size
      holds (a (N b, ...) gradient sharded over every axis, viewed back
      as (N, b, ...) with N below the rank count), giving wrong local
      shapes. Where an output dim's shards do not divide it, the input
      is first regathered over the mesh axes past those that do
      (``_view_placements_that_fit``).

    Everything is restored on exit, and the propagation cache cleared."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._ops import _view_ops
    from torch.distributed.tensor.placement_types import _StridedShard

    name = "local_shard_size_and_offset"
    orig = _StridedShard.__dict__.get(name)
    if orig is not None:
        def outside_fake(*args, **kwargs):
            with unset_fake_temporarily():
                return orig(*args, **kwargs)

        setattr(_StridedShard, name, outside_fake)
    prop = DTensor._op_dispatcher.sharding_propagator
    aten = torch.ops.aten
    views = (aten.view.default, aten._unsafe_view.default)
    saved = {op: prop.op_strategy_funcs[op] for op in views}
    for op in views:
        _view_ops.register_op_strategy_map(
            op, torch.Tensor.view,
            schema_info=prop.op_to_schema_info.get(op))
    orig_view = _view_ops.propagate_shape_and_sharding
    _view_ops.propagate_shape_and_sharding = \
        _view_placements_that_fit(orig_view)
    prop.propagate_op_sharding.cache_clear()
    try:
        with around_sharding_propagation(unset_fake_temporarily):
            yield
    finally:
        _view_ops.propagate_shape_and_sharding = orig_view
        prop.op_strategy_funcs.update(saved)
        prop.propagate_op_sharding.cache_clear()
        if orig is not None:
            setattr(_StridedShard, name, orig)


def _view_placements_that_fit(propagate):
    """DTensor's view propagation (``_view_ops``' ``propagate_shape_and_
    sharding``), re-run with the input replicated over every mesh axis
    whose shard of an output dim that dim's size does not hold."""
    import math

    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._ops import _view_ops as vo

    def size(spec, shape):
        if isinstance(spec, vo.InputDim):
            return shape[spec.input_dim]
        if isinstance(spec, vo.Split):
            return spec.group_shape[spec.split_id]
        if isinstance(spec, vo.Flatten):
            return math.prod(size(d, shape) for d in spec.input_dims)
        if isinstance(spec, vo.Broadcast):
            return spec.dim_size
        if isinstance(spec, vo.NewDim):
            return spec.size
        if isinstance(spec, vo.Repeat):
            return size(spec.input_dim, shape) * spec.times
        return 1  # Singleton

    def unfit(out_placements, out_shape, mesh_sizes):
        """The mesh axes past those whose shards the dim holds."""
        bad = set()
        for d, n in enumerate(out_shape):
            shards = 1
            for i, p in enumerate(out_placements):
                if p.is_shard() and p.dim == d:
                    if n % (shards * mesh_sizes[i]):
                        bad.add(i)
                    else:
                        shards *= mesh_sizes[i]
        return bad

    def fitted(src, shape, rule, mesh_sizes, strict_view=False):
        out_shape = [size(r, shape) for r in rule]
        src = list(src)
        while True:
            tgt, out = propagate(src, shape, rule, mesh_sizes, strict_view)
            bad = unfit(out, out_shape, mesh_sizes)
            if not bad or all(not src[i].is_shard() for i in bad):
                return tgt, out
            for i in bad:
                src[i] = Replicate()

    return fitted


def _local_shape(shape, sharding):
    from torch.distributed.tensor import Shard

    ms = mesh_shape(sharding.mesh)
    local = list(shape)
    for axis, p in zip(sharding.mesh.mesh_dim_names, sharding.placements):
        if isinstance(p, Shard):
            if local[p.dim] % ms[axis]:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide over {axis!r} ({ms[axis]})")
            local[p.dim] //= ms[axis]
    return tuple(local)


def _distribute(node, sharding):
    if isinstance(node, torch.Tensor):
        from torch.distributed.tensor import DTensor

        local = torch.empty(_local_shape(node.shape, sharding),
                            dtype=node.dtype, device=node.device)
        return DTensor.from_local(local, sharding.mesh, sharding.placements,
                                  run_check=False, shape=node.shape,
                                  stride=node.stride())
    if isinstance(node, dict):
        return {k: _distribute(v, sharding[k]) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_distribute(v, s)
                            for v, s in zip(node, sharding)))
    if isinstance(node, (list, tuple)):
        return type(node)(_distribute(v, s) for v, s in zip(node, sharding))
    return node


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    # plain tensors that DTensor makes outside the fake mode (index sets
    # of a strided shard) meet the fake shards: let them in as fakes
    return FakeTensorMode(allow_non_fake_inputs=True)


def _struct(shape, dtype):
    """A fake (B, ...) input; call under the case's fake mode."""
    return torch.empty(shape, dtype=dtype, device="cpu")


def _client_ax(mesh):
    ca = client_axes(mesh)
    return ca if len(ca) > 1 else ca[0]


def default_cut(cfg: ModelConfig) -> int:
    """v default for dry-runs: small client side (paper Thm 2 favours small
    φ(v)) but at least one layer."""
    return max(1, min(2, cfg.num_layers - 1))


def serve_config(cfg: ModelConfig, shape: InputShape) -> Optional[ModelConfig]:
    """Adjust the config for a serving shape; None => skip (documented)."""
    if shape.name == "long_500k":
        if cfg.name in LONG_SKIP:
            return None
        if cfg.arch_type in ("ssm", "hybrid") or cfg.sliding_window:
            return cfg  # natively sub-quadratic decode
        return cfg.with_overrides(sliding_window=SLIDING_FOR_LONG)
    return cfg


def build_case(arch: str, shape_name: str, mesh, *, algo: str = "sfl_ga",
               cut: Optional[int] = None, fsdp: Optional[bool] = None,
               expert_parallel: bool = False, remat: bool = True,
               policy: str = "tp",
               extra_overrides: Optional[dict] = None) -> Optional[DryRunCase]:
    """The (arch x shape) case on ``mesh`` (a ``launch.mesh`` mesh), or
    None where the reference skips. ``remat`` checkpoints each layer of
    a train case's step (module docstring)."""
    cfg = get_config(arch)
    if extra_overrides:
        cfg = cfg.with_overrides(**extra_overrides)
    if expert_parallel and cfg.moe is not None:
        cfg = cfg.with_overrides(expert_axis="data",
                                 routing_groups=mesh_shape(mesh).get("data",
                                                                     1))
    shape = INPUT_SHAPES[shape_name]
    fsdp = (arch in FSDP_ARCHS) if fsdp is None else fsdp
    if shape.kind == "train":
        return _build_train_case(cfg, arch, shape, mesh, algo=algo,
                                 cut=cut or default_cut(cfg), fsdp=fsdp,
                                 expert_parallel=expert_parallel,
                                 remat=remat, policy=policy)
    scfg = serve_config(cfg, shape)
    if scfg is None:
        return None
    if shape.kind == "prefill":
        return _build_prefill_case(scfg, arch, shape, mesh, fsdp=fsdp,
                                   expert_parallel=expert_parallel)
    return _build_decode_case(scfg, arch, shape, mesh, fsdp=fsdp,
                              expert_parallel=expert_parallel)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def _build_train_case(cfg, arch, shape, mesh, *, algo, cut, fsdp,
                      expert_parallel, remat, policy="tp") -> DryRunCase:
    N = n_client_shards(mesh)
    assert shape.global_batch % N == 0
    b = shape.global_batch // N
    S = shape.seq_len
    tcfg = TrainConfig(model=cfg, algo=algo, cut_layer=cut, remat=remat,
                       fsdp=fsdp, expert_parallel=expert_parallel)
    opt = make_optimizer("sgd", 1e-3)
    mode = _fake_mode()

    with mode:
        if cfg.arch_type == "audio":
            params = _whisper_split_stacked(cfg, cut, N, _DT)
            step = alg.make_whisper_train_step(cfg, tcfg, opt, N)
            F = cfg.encoder.num_frames
            batch = {
                "frame_embeds": _struct((N, b, F, cfg.d_model), _DT),
                "tokens": _struct((N, b, S), _INT),
                "labels": _struct((N, b, S), _INT),
            }
            batch_shd = {
                "frame_embeds": shd.batch_sharding(mesh, 4),
                "tokens": shd.batch_sharding(mesh, 3),
                "labels": shd.batch_sharding(mesh, 3),
            }
        else:
            plan = lm.build_plan(cfg, cut)
            params = alg.split_lm_params(
                lm.init_lm(0, plan, _DT, device="cpu"), N)
            step = alg.make_train_step(plan, tcfg, opt, N)
            if cfg.arch_type == "vlm":
                # stubbed ViT frontend: precomputed merged embeddings
                tokens = _struct((N, b, S, cfg.d_model), _DT)
                tok_shd = shd.batch_sharding(mesh, 4, policy)
            else:
                tokens = _struct((N, b, S), _INT)
                tok_shd = shd.batch_sharding(mesh, 3, policy)
            batch = {"tokens": tokens, "labels": _struct((N, b, S), _INT)}
            batch_shd = {"tokens": tok_shd,
                         "labels": shd.batch_sharding(mesh, 3, policy)}
        opt_state = opt.init(params)

    param_shd = shd.split_param_shardings(params, mesh=mesh, fsdp=fsdp,
                                          expert_parallel=expert_parallel,
                                          policy=policy)
    # optimizer state replicated, as the reference's
    opt_shd = tree_map(lambda x: shd.replicated(mesh, x.dim()), opt_state)
    return DryRunCase(
        arch=arch, shape=shape.name, kind="train", fn=step,
        args=(params, opt_state, batch),
        in_shardings=(param_shd, opt_shd, batch_shd),
        meta={"cut": cut, "algo": algo, "fsdp": fsdp, "n_clients": N,
              "tokens": shape.global_batch * S, "context": S},
        mode=mode)


def _whisper_split_stacked(cfg, cut, N, dtype=torch.float32, *, seed=0,
                           device="cpu"):
    """Whisper's split drawn from ``seed`` (``encdec.split_whisper_params``)
    in the train step's layout: the client side materialized once per
    client along a new leading axis N (every client starts from the same
    model), the server side shared."""
    p = encdec.split_whisper_params(seed, cfg, cut, dtype, device=device)
    client = tree_map(
        lambda x: x.unsqueeze(0).expand((N,) + tuple(x.shape)).contiguous(),
        p["client"])
    return {"client": client, "server": p["server"]}


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def _serve_params(cfg):
    """Serve params under the caller's fake mode: whisper's tree, or
    (plan, init_lm tree) of the unsplit LM."""
    if cfg.arch_type == "audio":
        return encdec.init_whisper(0, cfg, _DT, device="cpu")
    plan = lm.build_plan(cfg, 0)
    return plan, lm.init_lm(0, plan, _DT, device="cpu")


def _build_prefill_case(cfg, arch, shape, mesh, *, fsdp, expert_parallel):
    B, S = shape.global_batch, shape.seq_len
    mode = _fake_mode()

    with mode:
        if cfg.arch_type == "audio":
            params = _serve_params(cfg)
            F = cfg.encoder.num_frames

            def fn(params, frame_embeds, tokens):
                return encdec.whisper_prefill(params, cfg, frame_embeds,
                                              tokens, max_len=S, dtype=_DT)

            args = (params, _struct((B, F, cfg.d_model), _DT),
                    _struct((B, S), _INT))
            in_shd = [shd.serve_batch_sharding(mesh, 3, B),
                      shd.serve_batch_sharding(mesh, 2, B)]
        else:
            plan, params = _serve_params(cfg)
            if cfg.arch_type == "vlm":
                inp = _struct((B, S, cfg.d_model), _DT)
                inp_shd = shd.serve_batch_sharding(mesh, 3, B)

                def fn(params, embeds):
                    return lm.prefill(params, plan, inputs_embeds=embeds,
                                      max_len=S, dtype=_DT)
            else:
                inp = _struct((B, S), _INT)
                inp_shd = shd.serve_batch_sharding(mesh, 2, B)

                def fn(params, tokens):
                    return lm.prefill(params, plan, tokens=tokens,
                                      max_len=S, dtype=_DT)

            args = (params, inp)
            in_shd = [inp_shd]
    param_shd = shd.param_shardings(params, mesh=mesh, client=False,
                                    fsdp=fsdp,
                                    expert_parallel=expert_parallel)
    return DryRunCase(arch=arch, shape=shape.name, kind="prefill", fn=fn,
                      args=args, in_shardings=(param_shd, *in_shd),
                      meta={"tokens": B * S, "context": S, "fsdp": fsdp},
                      mode=mode)


def _whisper_caches(cfg, B, S, dtype):
    """Each decoder layer's dense self-attention cache of S rows and its
    projected encoder KV (``encdec.DecLayerCache``), lengths 0 and F."""
    from repro_torch.models.attention import KVCache

    hd = cfg.resolved_head_dim
    F = cfg.encoder.num_frames
    caches = []
    for _ in range(cfg.num_layers):
        self_kv = KVCache(_struct((B, S, cfg.num_kv_heads, hd), dtype),
                          _struct((B, S, cfg.num_kv_heads, hd), dtype), 0)
        cross = KVCache(_struct((B, F, cfg.num_kv_heads, hd), dtype),
                        _struct((B, F, cfg.num_kv_heads, hd), dtype), F)
        caches.append(encdec.DecLayerCache(self_kv, cross))
    return caches


def _whisper_cache_shd(caches, mesh):
    cax = _client_ax(mesh)

    def spec(path, leaf, repeat):
        if not isinstance(leaf, torch.Tensor):
            return None
        if leaf.dim() == 4:
            return shd._named(mesh, [cax, None, None, None])
        return shd.replicated(mesh, leaf.dim())

    return shd.map_with_path(spec, caches)


def _build_decode_case(cfg, arch, shape, mesh, *, fsdp, expert_parallel):
    B, S = shape.global_batch, shape.seq_len
    mode = _fake_mode()

    with mode:
        if cfg.arch_type == "audio":
            params = _serve_params(cfg)
            caches = _whisper_caches(cfg, B, S, _DT)
            cache_shd = _whisper_cache_shd(caches, mesh)

            def fn(params, token, caches):
                return encdec.whisper_decode_step(params, cfg, token, caches,
                                                  dtype=_DT)
        else:
            plan, params = _serve_params(cfg)
            caches = lm.init_caches(plan, B, S, _DT, device="cpu")
            cache_shd = shd.cache_shardings(caches, mesh)
            fn = alg.make_decode_step(plan, _DT)
        args = (params, _struct((B, 1), _INT), caches)
    param_shd = shd.param_shardings(params, mesh=mesh, client=False,
                                    fsdp=fsdp,
                                    expert_parallel=expert_parallel)
    in_shd = (param_shd, shd.serve_batch_sharding(mesh, 2, B), cache_shd)
    return DryRunCase(arch=arch, shape=shape.name, kind="decode", fn=fn,
                      args=args, in_shardings=in_shd,
                      meta={"tokens": B, "context": S, "fsdp": fsdp,
                            "window": cfg.sliding_window},
                      mode=mode)
