"""Production meshes (port of ``repro.launch.mesh``), as
``torch.distributed.device_mesh.DeviceMesh``es.

Single pod: (16, 16) = 256 ranks, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model") -- the
"pod" axis crosses hosts; the client (federated) axis spans pod x data.

A mesh is laid over the default process group, rank-major in the mesh's
C order, as ``init_device_mesh`` lays it. The production meshes need a
group of their size to exist already (``torchrun``, or a fake group in a
test). The bank and host meshes make a one-rank group when none exists:
over a ``torch.distributed.HashStore``, so no TCP, no environment
variables and no network; its backend follows the device the caller
gave (nccl for cuda, gloo for cpu). A group that exists is used as it
is, backend and world.

Functions, not module constants: importing this module touches no
process-group state.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import require_device

# the process-group backend for each device type; nothing picks one from
# what the machine has
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _select_card(dev: torch.device) -> None:
    """Make ``dev`` (the current card when it names no index) this
    process's card before nccl or a mesh binds to one; DeviceMesh
    otherwise guesses ``rank % cards``."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())


def ensure_process_group(device="cuda") -> None:
    """The default process group: the existing one, or else a new
    one-rank group over a ``HashStore`` with ``device``'s backend."""
    dev = require_device(device)
    if dist.is_initialized():
        return
    _select_card(dev)
    dist.init_process_group(BACKENDS[dev.type], store=dist.HashStore(),
                            rank=0, world_size=1)


def _mesh(device, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    dev = require_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {math.prod(shape)} "
            "ranks (torchrun, or torch.distributed.init_process_group); "
            "none is initialized")
    world, size = dist.get_world_size(), math.prod(shape)
    if size != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {size} ranks; "
                         f"the process group has {world}")
    _select_card(dev)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_host_mesh(device="cuda"):
    """One-rank mesh for smoke runs (same axis names)."""
    ensure_process_group(device)
    return _mesh(device, (1, 1), ("data", "model"))


def make_bank_mesh(device="cuda"):
    """Mesh for the sharded client bank (``core.bank``): every rank of
    the default group on the client ("data") axis -- bank leaves are
    per-client CNN blocks with no tensor-parallel dim to feed "model".
    Standard axis names, so ``client_axes``/``bank_sharding`` work on
    this mesh and on the production meshes alike."""
    ensure_process_group(device)
    return _mesh(device, (dist.get_world_size(), 1), ("data", "model"))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order (jax's ``mesh.shape``). Readable
    under a ``FakeTensorMode`` (the dry run's): the mesh's rank tensor is
    a real one."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        sizes = tuple(int(s) for s in mesh.mesh.shape)
    return dict(zip(mesh.mesh_dim_names, sizes))


def client_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that jointly form the federated-client axis."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def n_client_shards(mesh) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in client_axes(mesh))


def model_axis_size(mesh) -> int:
    return mesh_shape(mesh)["model"]
