"""M2: the position-in-expert count of the mixture-of-experts layer's
dispatch, for ``models/moe.py``: the Hopper kernel's wrapper and its plain
PyTorch version.

Replaces no TPU kernel: on the TPU XLA's ``cumsum`` took it. On the card
PyTorch scanned a (P, E) int32 one-hot over its outer dim, one serial walk
down the P rows a column (~6.9 ms at the granite-4.0-h server's P 40,960,
E 72), ~10 % of a granite-4.0-h train step.

    pos[i] = #{j < i : ids[j] == ids[i]}

``ids`` int64 expert ids in the layer's flat order (token-major,
choice-minor), any shape; ``pos`` int32 of the same shape. The kernel
counts over all E experts, so every pair's position is the plain
version's, bit for bit. ``kernels.ops.moe_positions`` is the op that takes
them.

* :func:`moe_positions` is the wrapper. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel in ``csrc/moe_count.cu``
  (built at first use, see ``_build``) or raises: no fallback from the
  card. It takes contiguous int64 ids, 1 <= E <= :data:`MAX_E` and fewer
  than 2^31 pairs. ``moe_positions.launches`` counts kernel launches (one
  a call with any pair); ``moe_positions.passed`` counts the counts the
  op's rule left on the plain version on the card.
* :func:`moe_positions_ref` is the plain version: the layer's earlier
  expression (the one-hot ``hits``, ``cumsum`` over dim 0, minus 1, each
  pair's own column gathered), so the CPU path is the earlier one op for
  op.

Its bound on an H100 is bytes (12 a pair) over 3.35 TB/s; the launch and
one grid barrier set its time. The design is written at the top of the
CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_E = 1024  # kMaxE in csrc/moe_count.cu: a warp's counters in shared memory
TILE = 1024  # the fewest pairs a block takes: 4 a thread


def moe_positions_ref(ids, E: int):
    """Plain version of :func:`moe_positions`, the layer's earlier
    expression op for op."""
    flat = ids.reshape(-1)
    hits = (flat[:, None] == torch.arange(E, device=flat.device)).to(
        torch.int32)
    pos = torch.cumsum(hits, dim=0, dtype=torch.int32) - 1
    return torch.gather(pos, 1, flat[:, None]).reshape(ids.shape)


def _check(ids, E):
    if ids.device.type != "cuda":
        raise ValueError(f"moe_positions runs on cpu or cuda, got "
                         f"{ids.device}")
    if ids.dtype != torch.int64 or not ids.is_contiguous():
        raise ValueError(f"moe_positions takes contiguous int64 ids, got "
                         f"{ids.dtype} with strides {ids.stride()}")
    if not 1 <= E <= MAX_E:
        raise ValueError(f"moe_positions counts 1 to {MAX_E} experts, got "
                         f"{E}")
    if ids.numel() >= 2 ** 31:
        raise ValueError(f"moe_positions indexes pairs in 32 bits, got "
                         f"{ids.numel()}")


def _library():
    lib = _build.load("moe_count")
    if lib.m2_positions_launch.argtypes is None:
        lib.m2_positions_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2
            + [ctypes.c_void_p])
        lib.m2_positions_launch.restype = ctypes.c_int
    return lib


def moe_positions(ids, E: int):
    """pos (ids' shape, int32): each pair's position among the earlier
    pairs routed to the same expert (module docstring). On a CPU tensor
    this is the plain version; on a CUDA tensor it launches the Hopper
    kernel on the current stream (no synchronisation) and raises if the
    operands are not as the kernel reads them or the launch fails."""
    if ids.device.type == "cpu":
        return moe_positions_ref(ids, E)
    _check(ids, E)
    P = ids.numel()
    pos = torch.empty(ids.shape, dtype=torch.int32, device=ids.device)
    if P == 0:
        return pos
    # one block an SM at most: the grid barrier needs every block resident
    blocks = min(-(-P // TILE), _build.sm_count(ids.device.index))
    agg = torch.empty(blocks * E, dtype=torch.int32, device=ids.device)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        err = _library().m2_positions_launch(
            ids.data_ptr(), pos.data_ptr(), agg.data_ptr(), P, E, blocks,
            stream)
    if err != 0:
        raise RuntimeError(f"moe_positions launch failed with code {err} "
                           f"(ids {tuple(ids.shape)}, E {E}, {blocks} "
                           f"blocks)")
    moe_positions.launches += 1
    return pos


moe_positions.launches = 0
moe_positions.passed = 0
