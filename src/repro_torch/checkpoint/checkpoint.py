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
(any device; CUDA leaves are copied to the host one slice at a time) or
numpy arrays. ``load_checkpoint`` validates the file against a ``like``
tree: treedef string, per-leaf shape and dtype, and payload length (a
truncated file fails loudly instead of yielding a short garbage leaf).
Restored leaves are writable CPU tensors.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import msgpack
import numpy as np
import torch

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


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


def _children(node) -> List:
    if node is None:
        return []
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    return list(node)


def _treedef(node) -> str:
    if node is None:
        return "None"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(node[k])}"
                               for k in sorted(node)) + "}"
    if isinstance(node, (list, tuple)):
        inner = ", ".join(_treedef(c) for c in node)
        if isinstance(node, list):
            return f"[{inner}]"
        return f"({inner},)" if len(node) == 1 else f"({inner})"
    return "*"


def tree_flatten(tree) -> Tuple[List[Any], str]:
    """(leaves in jax's order, the treedef string jax prints)."""
    leaves: List[Any] = []

    def walk(node):
        if _is_node(node):
            for c in _children(node):
                walk(c)
        else:
            leaves.append(node)

    walk(tree)
    return leaves, f"PyTreeDef({_treedef(tree)})"


def tree_unflatten(like, leaves):
    """``like``'s structure with ``leaves`` (jax's leaf order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(like)


def _leaf_info(leaf) -> Tuple[Tuple[int, ...], str]:
    """Shape and the file's dtype name, from metadata only."""
    if isinstance(leaf, torch.Tensor):
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
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(header, use_bin_type=True))
        for leaf, (shape, name) in zip(leaves, infos):
            for buf in _leaf_chunks(leaf, shape, _itemsize(name)):
                f.write(buf)
    os.replace(tmp, path)


def _read_header(f) -> Tuple[Dict, int]:
    unpacker = msgpack.Unpacker(f, raw=False)
    header = unpacker.unpack()
    return header, unpacker.tell()


def load_checkpoint_meta(path: str) -> Dict:
    """Read just the ``meta`` dict (cheap: header only, no payloads)."""
    with open(path, "rb") as f:
        header, _ = _read_header(f)
    return header["meta"]


def _from_bytes(buf: bytes, name: str, shape) -> torch.Tensor:
    dt = _DTYPES.get(name)
    if dt is None:
        raise ValueError(f"checkpoint: unsupported dtype {name!r}")
    if not buf:  # frombuffer refuses an empty buffer
        return torch.empty(shape, dtype=dt)
    raw = torch.frombuffer(bytearray(buf), dtype=torch.int16
                           if dt == torch.bfloat16 else dt)
    if dt == torch.bfloat16:
        raw = raw.view(torch.bfloat16)
    return raw.reshape(shape)


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
            n = int(np.prod(shape)) * _itemsize(name)
            buf = f.read(n)
            if len(buf) != n:
                raise ValueError(f"truncated checkpoint: leaf {i} needs {n} "
                                 f"bytes, file had {len(buf)}")
            out.append(_from_bytes(buf, name, shape))
    return tree_unflatten(like, out), header["meta"]
