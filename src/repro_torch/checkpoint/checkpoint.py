"""Checkpointing: msgpack-framed tree snapshots, in the reference's file
format (port of ``repro.checkpoint.checkpoint``).

Format: one file with a msgpack header ``{treedef, shapes, dtypes, meta,
version}`` followed by the leaves' raw little-endian C-order payloads,
in leaf order. ``treedef`` is the string that ``str(jax.tree.flatten(
tree)[1])`` gives for the same structure (dict keys sorted, lists and
tuples in order, ``None`` an empty node), built here without jax, so a
file written by either package loads in the other and the same state
and meta give the same bytes.

Trees are nested dicts, lists and tuples whose leaves are torch tensors
(any device; CUDA leaves are copied to the host one slice at a time),
numpy arrays or ``StackedLeaf`` views (the LM's per-layer lists in the
reference's stacked layout, ``convert.lm_state_to_jax``). ``load_checkpoint`` validates the file against a ``like``
tree: treedef string, per-leaf shape and dtype, and payload length (a
truncated file fails loudly instead of yielding a short garbage leaf).
Restored leaves are writable CPU tensors (a sharded bank re-shards them
as it ingests them).

A tree with DTensor leaves (the sharded client bank) is saved by every
rank of the process group together: each DTensor leaf is made whole
with ``full_tensor()`` (a collective, so every rank walks the leaves in
the same order), rank 0 writes the file, and the other ranks wait at a
barrier until it is in place. The bytes are those of the same tree
saved whole.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional, Tuple

import msgpack
import numpy as np
import torch
import torch.distributed as dist

from repro_torch import is_dtensor
from repro_torch.tree import tree_flatten, tree_unflatten  # noqa: F401

# writer streams each leaf in slices of at most this many bytes, so a
# save never materializes a full (N,)-stacked bank copy on host at once
SAVE_CHUNK_BYTES = 64 << 20

# the file's dtype names (numpy's) and torch's dtypes; bfloat16 has no
# numpy dtype, so its payload moves through int16 views
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


class StackedLeaf:
    """A leaf in the reference's stacked layout that is never
    materialized: equal-shaped ``parts`` (one per layer) stacked along
    ``axis`` (0, or 1 behind a leading client axis). The writer streams
    its payload part by part in the stacked tensor's C order, so an LM
    state saves in the reference's format without a second copy of its
    weights on the device or the host."""

    def __init__(self, parts, axis: int = 0):
        self.parts = list(parts)
        self.axis = int(axis)
        shape = list(self.parts[0].shape)
        shape.insert(self.axis, len(self.parts))
        self.shape = tuple(shape)
        self.dtype = self.parts[0].dtype

    def chunks(self, itemsize: int):
        if self.axis == 0:
            for p in self.parts:
                yield from _leaf_chunks(p, tuple(p.shape), itemsize)
            return
        for n in range(self.shape[0]):  # (N, R, ...): row n of each part
            for p in self.parts:
                yield from _leaf_chunks(p[n], tuple(p.shape[1:]), itemsize)

    def numpy(self) -> np.ndarray:
        return np.stack([np.frombuffer(_host_bytes(p), dtype=np.dtype(
            _NAMES[p.dtype])).reshape(p.shape) for p in self.parts],
            axis=self.axis)


def _leaf_info(leaf) -> Tuple[Tuple[int, ...], str]:
    """Shape and the file's dtype name, from metadata only."""
    if isinstance(leaf, (torch.Tensor, StackedLeaf)):
        if leaf.dtype not in _NAMES:
            raise TypeError(f"checkpoint: unsupported dtype {leaf.dtype}")
        return tuple(int(d) for d in leaf.shape), _NAMES[leaf.dtype]
    a = np.asarray(leaf)
    return a.shape, str(a.dtype)


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=_DTYPES[name]).element_size() \
        if name in _DTYPES else np.dtype(name).itemsize


def _host_bytes(part) -> bytes:
    if isinstance(part, torch.Tensor):
        part = part.detach().contiguous().cpu()
        if part.dtype == torch.bfloat16:
            part = part.view(torch.int16)
        return part.numpy().tobytes(order="C")
    return np.asarray(part).tobytes(order="C")


def _leaf_chunks(leaf, shape: Tuple[int, ...], itemsize: int):
    """A leaf's payload as C-order byte chunks, slicing the leading axis
    so at most ~SAVE_CHUNK_BYTES are staged a step. Host leaves slice as
    views (zero device traffic: the host bank's save path); CUDA leaves
    copy to the host one slice at a time."""
    nbytes = int(np.prod(shape)) * itemsize if shape else itemsize
    if not shape or nbytes <= SAVE_CHUNK_BYTES:
        yield _host_bytes(leaf)
        return
    row = max(1, nbytes // max(shape[0], 1))
    step = max(1, SAVE_CHUNK_BYTES // row)
    for s in range(0, shape[0], step):
        yield _host_bytes(leaf[s:s + step])


def _dtensor_mesh(leaves):
    """The device mesh of the first DTensor leaf, or None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    for leaf in leaves:
        if is_dtensor(leaf):
            return leaf.device_mesh
    return None


def save_checkpoint(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    leaves, treedef = tree_flatten(tree)
    infos = [_leaf_info(l) for l in leaves]
    header = {
        "treedef": treedef,
        "shapes": [list(shape) for shape, _ in infos],
        "dtypes": [name for _, name in infos],
        "meta": meta or {},
        "version": 1,
    }
    mesh = _dtensor_mesh(leaves)
    writer = mesh is None or dist.get_rank() == 0
    tmp = path + ".tmp"
    if writer:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") if writer else contextlib.nullcontext() as f:
        if writer:
            f.write(msgpack.packb(header, use_bin_type=True))
        for leaf, (shape, name) in zip(leaves, infos):
            if mesh is not None and is_dtensor(leaf):
                leaf = leaf.full_tensor()  # every rank: a collective
            if not writer:
                continue
            chunks = leaf.chunks(_itemsize(name)) \
                if isinstance(leaf, StackedLeaf) \
                else _leaf_chunks(leaf, shape, _itemsize(name))
            for buf in chunks:
                f.write(buf)
    if writer:
        os.replace(tmp, path)
    if mesh is not None:
        _barrier(mesh)


def _barrier(mesh) -> None:
    """Every rank waits until rank 0's file is in place (nccl's barrier
    is told the rank's device, so it does not guess one)."""
    if mesh.device_type == "cuda":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _read_header(f) -> Tuple[Dict, int]:
    unpacker = msgpack.Unpacker(f, raw=False)
    header = unpacker.unpack()
    return header, unpacker.tell()


def load_checkpoint_meta(path: str) -> Dict:
    """Read just the ``meta`` dict (cheap: header only, no payloads)."""
    with open(path, "rb") as f:
        header, _ = _read_header(f)
    return header["meta"]


def _read_leaf(f, name: str, shape, i: int) -> torch.Tensor:
    """The next leaf's payload, read straight into a new CPU tensor (no
    intermediate bytes object, so a large leaf costs its own size once)."""
    dt = _DTYPES.get(name)
    if dt is None:
        raise ValueError(f"checkpoint: unsupported dtype {name!r}")
    out = torch.empty(shape, dtype=dt)
    n = out.numel() * out.element_size()
    if n:
        got = f.readinto(out.reshape(-1).view(torch.uint8).numpy())
        if got != n:
            raise ValueError(f"truncated checkpoint: leaf {i} needs {n} "
                             f"bytes, file had {got}")
    return out


def load_checkpoint(path: str, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (treedef, shapes and dtypes
    validated). Leaves come back as writable CPU tensors."""
    leaves, treedef = tree_flatten(like)
    with open(path, "rb") as f:
        header, offset = _read_header(f)
        if header["treedef"] != treedef:
            raise ValueError(
                f"checkpoint treedef mismatch:\n  saved: {header['treedef']}"
                f"\n  model: {treedef}")
        if len(header["shapes"]) != len(leaves):
            raise ValueError(f"checkpoint has {len(header['shapes'])} leaves, "
                             f"model has {len(leaves)}")
        f.seek(offset)
        out = []
        for i, l in enumerate(leaves):
            shape = tuple(header["shapes"][i])
            name = header["dtypes"][i]
            want_shape, want_name = _leaf_info(l)
            if shape != want_shape:
                raise ValueError(f"leaf {i}: checkpoint shape {shape} != "
                                 f"model {want_shape}")
            if name != want_name:
                raise ValueError(f"leaf {i}: checkpoint dtype {name} != "
                                 f"model {want_name}")
            out.append(_read_leaf(f, name, shape, i))
    return tree_unflatten(like, out), header["meta"]
