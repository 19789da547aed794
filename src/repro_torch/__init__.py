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
