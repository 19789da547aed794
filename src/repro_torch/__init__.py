"""PyTorch/CUDA port of the SFL-GA reproduction, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module paths and names, imports ``torch`` and numpy only, and carries its
own copies of what it needs from the reference (it imports nothing of
``repro``). Entry points run on the card unless the caller passes
``device="cpu"``; without a card they raise (:func:`require_device`).
Their device work runs in full f32 (:func:`full_f32`), whatever torch's
process-wide flags say outside it.
"""
from __future__ import annotations

import contextlib
import sys

import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it
    names CUDA and no CUDA device is available. The CPU is used only when
    the caller asks for it -- there is no silent fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' "
            "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev


@contextlib.contextmanager
def full_f32(deterministic: bool = False):
    """Run the enclosed device work in full f32, and reproducibly when
    ``deterministic``; restore the caller's flags on exit.

    The reference computes every matmul and convolution in full f32.
    TF32 (torch's default for cuDNN convolutions, and for matmuls where a
    caller turned it on) keeps about three decimal digits, so both TF32
    flags are off inside. With ``deterministic``, cuDNN takes
    deterministic algorithms too: its default backward algorithms
    accumulate in an order that varies from run to run, an int codec
    turns those last-bit differences into flipped codes, and training
    carries them to visibly different accuracies, where the reference is
    reproducible. The flags are torch's process-wide ones: they are set
    only for the enclosed work, so what runs outside it (the caller's own
    models, another engine) keeps the caller's settings. On the CPU the
    flags change nothing."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (cuda.allow_tf32, cudnn.allow_tf32, cudnn.deterministic)
    cuda.allow_tf32 = False
    cudnn.allow_tf32 = False
    if deterministic:
        cudnn.deterministic = True
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32, cudnn.deterministic = saved


# ---------------------------------------------------------------------------
# DTensors (the dry run runs the model over them, ``launch.specs``). Each
# helper is the identity on a plain tensor.
# ---------------------------------------------------------------------------

def is_dtensor(x, through_vmap: bool = False) -> bool:
    """Whether ``x`` is a DTensor; with ``through_vmap``, also a batched
    view of one under ``torch.func.vmap`` (the train step's client
    forward). Reads ``sys.modules``, so a process that never made one
    does not import ``torch.distributed.tensor``."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None or not isinstance(x, torch.Tensor):
        return False
    if through_vmap:
        from torch._C import _functorch as ft

        while ft.is_batchedtensor(x):
            x = ft.get_unwrapped(x)
    return isinstance(x, mod.DTensor)


def relaid(x, place, like=None):
    """``x`` redistributed over its mesh: each mesh dim takes
    ``place(p, name)``, with ``p`` the placement of ``like`` (default
    ``x``) on that dim and ``name`` the dim's name. The identity on a
    plain tensor."""
    if not is_dtensor(x):
        return x
    ref = x if like is None else like
    return x.redistribute(ref.device_mesh, [
        place(p, n) for p, n in zip(ref.placements,
                                    ref.device_mesh.mesh_dim_names)])


def _reduced(p, name):
    """A pending reduction done (Partial -> Replicate); any other
    placement as it is."""
    from torch.distributed.tensor import Replicate

    return Replicate() if p.is_partial() else p


def reduce_partial(x):
    """``x`` with every pending reduction (a ``Partial`` placement) done:
    an all-reduce to ``Replicate``. A plain tensor is returned as it is.
    Used where DTensor would pick a reduce-scatter that it cannot carry
    out (the vocab-parallel gather of a target logit)."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return relaid(x, _reduced)


def placed_like(x, ref):
    """``x`` redistributed to the placements of ``ref`` (the DTensor
    whose layout ``x`` should take: the batch a step's activations came
    from; a pending reduction in ``ref`` is no layout to take, so a
    Partial of ``ref`` becomes Replicate). The gradient flowing back
    through it is put in the same layout (a redistribute's backward),
    even where the forward is a no-op. The identity unless both are
    DTensors."""
    if not (is_dtensor(x) and is_dtensor(ref)):
        return x
    return relaid(x, _reduced, like=ref)
