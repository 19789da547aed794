"""Learning-rate schedules as step -> lr callables (port of
``repro.optim.schedules``). ``step`` is the optimizer's int32 count
tensor; the lr comes back as a float32 tensor on its device."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clip(step.to(torch.float32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)

    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cd = cosine_decay(lr, max(1, total_steps - warmup), final_frac)

    def fn(step):
        s = step.to(torch.float32)
        w = torch.clip(s / max(warmup, 1), 0.0, 1.0)
        return torch.where(s < warmup, lr * w, cd(step - warmup))

    return fn
