"""Three-term roofline of a step, counted from the ops it dispatches
(port of ``repro.analysis.roofline``).

    compute    = FLOPs       / peak FLOP/s of the case's dtype
    memory     = bytes       / HBM rate
    collective = coll_bytes  / link rate

The reference parses the optimized HLO of a compiled SPMD program. The
port has no HLO: it runs the step once, eagerly, over DTensors (the dry
run, ``launch.dryrun``) or plain tensors (a card step), and
:class:`OpCounter`, a ``TorchDispatchMode``, counts what rank 0
dispatches. Ops on DTensors are handed on to DTensor (the mode returns
``NotImplemented`` for them, as ``torch.distributed._tools.mem_tracker``
does), so the mode sees the rank-local ops they become, on local
shards, and the ``_c10d_functional`` collectives of every redistribute.
The global ops that DTensor's sharding propagation runs only to learn
output shapes are not counted. What :class:`OpStats` holds:

* ``flops``: matmul, attention and convolution FLOPs on the local
  shards (``torch.utils.flop_counter``'s formulas). Work replicated over
  a mesh axis is done, and counted, on every rank;
* ``dot_bytes``: the operands and results of those ops;
* ``bytes``: what every op reads and writes (inputs and outputs at their
  logical sizes; views, factories without data and collectives
  excluded). This is close to the HBM traffic of an eager, unfused
  program: no fusion, and every intermediate written and read back;
* ``coll_bytes_by_kind`` / ``coll_count_by_kind``: each collective's
  bytes, max(operand, result) as in the reference, under its kind names
  ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
  "collective-permute"); ``coll_bytes_by_axes`` splits them by the mesh
  axis the collective runs over, as ``"all-reduce@data"`` (the counter
  reads the axis from the group's name on the mesh it was given; a group
  of no mesh axis is ``"?"``);
* ``global_flops``: the same FLOP formulas on the DTensor-level ops, at
  their global shapes: what ``FlopCounterMode`` reports around the step;
* ``peak_bytes``: the most bytes of live storage on the rank during the
  run (the args' local shards included), tracked per storage as
  ``mem_tracker`` tracks it.

The reference's ``coll_bytes_tpu`` (bf16 bytes for f32 collectives that
XLA's CPU backend hoists above a convert) has no counterpart: the port
dispatches the collectives it runs in the dtype they run in, so there is
no projection to make.

Peaks come from the device the roofline names (:data:`PEAKS`, one table
keyed by ``torch.cuda.get_device_name()``); an unknown name raises. The
compute peak follows the case's dtype.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclass(frozen=True)
class DevicePeaks:
    """One card's data-sheet rates (dense, no sparsity)."""
    name: str
    hbm_bytes_per_s: float
    f32_flop_per_s: float    # float32 outside the tensor cores
    tf32_flop_per_s: float   # TF32 on the tensor cores
    bf16_flop_per_s: float   # bf16 / fp16 on the tensor cores
    link_bytes_per_s: float  # a mesh axis that spans nodes, per GPU
    nvlink_bytes_per_s: float  # a mesh axis within one node, a direction
    source: str

    def flop_per_s(self, dtype: str) -> float:
        """The compute peak for ``dtype``: "bfloat16"/"float16", "tf32" or
        "float32"."""
        rates = {"bfloat16": self.bf16_flop_per_s,
                 "float16": self.bf16_flop_per_s,
                 "tf32": self.tf32_flop_per_s,
                 "float32": self.f32_flop_per_s}
        if dtype not in rates:
            raise ValueError(f"no compute peak for dtype {dtype!r}; known: "
                             f"{sorted(rates)}")
        return rates[dtype]


# NVIDIA's data sheets. Every axis of the (16, 16) and (2, 16, 16) meshes
# spans more than one 8-GPU node, so a collective's rate is the node's
# network: NDR InfiniBand at 400 Gb/s with one NIC a GPU, 50 GB/s. An
# axis within one node would ride NVLink 4 at 450 GB/s a direction.
PEAKS: Dict[str, DevicePeaks] = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        name="NVIDIA H100 80GB HBM3", hbm_bytes_per_s=3.35e12,
        f32_flop_per_s=67e12, tf32_flop_per_s=495e12,
        bf16_flop_per_s=989e12, link_bytes_per_s=50e9,
        nvlink_bytes_per_s=450e9,
        source="NVIDIA H100 data sheet (SXM5, 700 W): HBM3 3.35 TB/s, "
               "FP32 67 TFLOP/s, TF32 495 and BF16 989 TFLOP/s dense; "
               "NVLink 4 900 GB/s both ways; NDR InfiniBand 400 Gb/s "
               "(ConnectX-7) a GPU"),
}

# the dry run's cases are priced on this card (they run on the CPU)
DEFAULT_DEVICE = "NVIDIA H100 80GB HBM3"


def device_peaks(name: str) -> DevicePeaks:
    """The peaks of the card ``name`` (``torch.cuda.get_device_name()``);
    raises ``KeyError`` for a card the table does not hold."""
    if name not in PEAKS:
        raise KeyError(f"no peaks for device {name!r}; the table holds "
                       f"{sorted(PEAKS)}")
    return PEAKS[name]


# _c10d_functional op name -> the reference's collective kind
_COLL_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that move no data: factories without a fill, metadata
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_local_scalar_dense", "wait_tensor", "set_", "resize_"}


@dataclass
class OpStats:
    flops: float = 0.0
    dot_bytes: float = 0.0
    bytes: float = 0.0
    coll_bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    coll_count_by_kind: Dict[str, int] = field(default_factory=dict)
    coll_bytes_by_axes: Dict[str, int] = field(default_factory=dict)
    global_flops: float = 0.0
    peak_bytes: int = 0

    @property
    def coll_bytes(self) -> int:
        return sum(self.coll_bytes_by_kind.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _storages(t: torch.Tensor):
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t._local_tensor
    try:
        return [t.untyped_storage()]
    except (NotImplementedError, RuntimeError):  # e.g. a sparse tensor
        return []


_MISSING = object()


@contextlib.contextmanager
def around_sharding_propagation(make_context):
    """Enter ``make_context()`` around each of DTensor's sharding
    propagations: the strategy search (the propagator's
    ``propagate_op_sharding`` and its uncached form) and the shape
    inference that runs the global op on fake tensors
    (``_propagate_tensor_meta_non_cached``). Restores all three on
    exit."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def wrap(fn):
        def inner(*args, **kwargs):
            with make_context():
                return fn(*args, **kwargs)
        return inner

    prop = DTensor._op_dispatcher.sharding_propagator
    names = ("propagate_op_sharding", "propagate_op_sharding_non_cached")
    saved = {n: prop.__dict__.get(n, _MISSING) for n in names}
    meta = "_propagate_tensor_meta_non_cached"
    orig_meta = ShardingPropagator.__dict__[meta]
    for n in names:
        setattr(prop, n, wrap(getattr(prop, n)))
    setattr(ShardingPropagator, meta, wrap(orig_meta))
    try:
        yield
    finally:
        setattr(ShardingPropagator, meta, orig_meta)
        for n, v in saved.items():
            if v is _MISSING:
                delattr(prop, n)
            else:
                setattr(prop, n, v)


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live storage of what runs
    under it into ``self.stats`` (module docstring). Enter it innermost
    (after a ``FakeTensorMode``, when there is one). ``track(tree)``
    counts tensors that exist before the run (the args) as live.
    ``mesh``: the DeviceMesh whose axes name the collectives' groups."""

    def __init__(self, mesh=None):
        super().__init__()
        self.stats = OpStats()
        self._axes = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._axes[mesh.get_group(i).group_name] = name
        self._in_propagation = 0
        self._live: Dict[int, int] = {}
        self._refs = {}
        self._cur = 0
        self._stack = None

    # -- live storage ------------------------------------------------------
    def _free(self, key):
        self._cur -= self._live.pop(key, 0)
        self._refs.pop(key, None)

    def _track_tensor(self, t: torch.Tensor) -> None:
        for st in _storages(t):
            key = id(st)
            if key in self._live:
                continue
            self._live[key] = int(st.nbytes())
            self._cur += self._live[key]
            self._refs[key] = weakref.ref(
                st, lambda _, k=key: self._free(k))
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._cur)

    def track(self, tree) -> None:
        for t in _tensors(tree):
            self._track_tensor(t)

    @contextlib.contextmanager
    def _propagating(self):
        self._in_propagation += 1
        try:
            yield
        finally:
            self._in_propagation -= 1

    # -- the mode ----------------------------------------------------------
    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(
            around_sharding_propagation(self._propagating))
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._stack.close()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        packet = func._overloadpacket
        if any(issubclass(t, DTensor) for t in types):
            # the global op; DTensor turns it into local ops, which come
            # back here
            if not self._in_propagation and packet in flop_registry:
                self.stats.global_flops += flop_registry[packet](
                    *args, **kwargs, out_val=None)
            return NotImplemented
        name = packet.__name__
        ns = func.namespace
        if (ns == "_c10d_functional" and name == "wait_tensor"
                and torch._guards.detect_fake_mode() is not None):
            # the fake kernel of wait_tensor returns a new tensor; eagerly
            # it is its argument (mem_tracker makes the same substitution)
            return args[0]
        out = func(*args, **kwargs)
        if self._in_propagation:
            return out
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if ns == "_c10d_functional" and name in _COLL_KIND:
            kind = _COLL_KIND[name]
            size = max(sum(map(_nbytes, ins)), sum(map(_nbytes, outs)))
            s = self.stats
            s.coll_bytes_by_kind[kind] = s.coll_bytes_by_kind.get(kind, 0) \
                + size
            s.coll_count_by_kind[kind] = s.coll_count_by_kind.get(kind, 0) \
                + 1
            group = [a for a in args if isinstance(a, str)][-1]
            key = f"{kind}@{self._axes.get(group, '?')}"
            s.coll_bytes_by_axes[key] = s.coll_bytes_by_axes.get(key, 0) \
                + size
        elif packet in flop_registry:
            self.stats.flops += flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
            b = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.stats.dot_bytes += b
            self.stats.bytes += b
        elif not (func.is_view or name in _NO_BYTES or ns == "prim"
                  or ns == "_c10d_functional"):
            if func._schema.is_mutable:  # in place: read the inputs, write
                self.stats.bytes += sum(map(_nbytes, ins))
            else:
                self.stats.bytes += sum(map(_nbytes, ins)) \
                    + sum(map(_nbytes, outs))
        for t in outs:
            self._track_tensor(t)
        return out


@dataclass
class Roofline:
    """A dry-run row's roofline. Reference names, port meanings:

    * ``hlo_flops`` (``hlo_flops_per_dev``): :class:`OpStats` ``flops``,
      rank 0's local matmul/attention FLOPs;
    * ``hlo_bytes`` (``hlo_bytes_per_dev``): ``bytes``, what rank 0's
      ops read and write, eager and unfused;
    * ``coll_bytes`` (``coll_bytes_per_dev``) and ``coll_detail``: rank
      0's collective bytes, in total and by kind and mesh axis
      (``"all-reduce@data"``; the reference's keys are the kinds alone);
    * ``xla_flops``: ``global_flops``, the step's FLOPs at the DTensor
      level, unsharded (XLA's ``cost_analysis`` has no counterpart);
    * ``per_device_mem`` (``per_device_mem_bytes``): the run's peak live
      storage on rank 0;
    * ``device``: the card whose peaks price the three terms, and
      ``dtype`` the compute type that picks the FLOP peak.
    """
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float
    coll_detail: Dict[str, int]
    xla_flops: float = 0.0
    per_device_mem: Optional[float] = None
    device: str = DEFAULT_DEVICE
    dtype: str = "bfloat16"

    @property
    def peaks(self) -> DevicePeaks:
        return device_peaks(self.device)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.peaks.flop_per_s(self.dtype)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.peaks.hbm_bytes_per_s

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.peaks.link_bytes_per_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs x chips) -- 1.0 means no waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "model_flops": self.model_flops, "xla_flops": self.xla_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "coll_detail": self.coll_detail,
            "per_device_mem_bytes": self.per_device_mem,
            "device": self.device,
        }


def analyze(stats: OpStats, *, arch: str, shape: str, mesh_tag: str,
            chips: int, model_flops: float, device: str = DEFAULT_DEVICE,
            dtype: str = "bfloat16") -> Roofline:
    """The roofline of a counted run on ``device``'s peaks."""
    device_peaks(device)  # an unknown card raises here
    return Roofline(arch=arch, shape=shape, mesh=mesh_tag, chips=chips,
                    hlo_flops=stats.flops, hlo_bytes=stats.bytes,
                    coll_bytes=float(stats.coll_bytes),
                    model_flops=model_flops,
                    coll_detail=dict(stats.coll_bytes_by_axes),
                    xla_flops=stats.global_flops,
                    per_device_mem=float(stats.peak_bytes), device=device,
                    dtype=dtype)
