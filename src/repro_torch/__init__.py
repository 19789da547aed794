"""PyTorch/CUDA port of the SFL-GA reproduction, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module paths and names, imports ``torch`` and numpy only, and carries its
own copies of what it needs from the reference (it imports nothing of
``repro``). Entry points run on the card unless the caller passes
``device="cpu"``; without a card they raise (:func:`require_device`).
"""
from __future__ import annotations

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
