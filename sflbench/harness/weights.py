"""Seeded initial weights, made on the device by the benchmark.

Both sides of the output check start from these: the program gets them
in its own layout (``harness.program``), and the reference makes them
again from the same seed after the window. Leaf names are the key paths
of the model's parameter tree (``layer3.attn.wq.w``, ``head.w``), one
unstacked copy of each: the split's client copies are the program's to
make.

The configuration's family (``reference.Family``) lists the leaves, each
with its shape and distribution: ``normal`` (times its std), ``ones``,
``zeros``, ``a_log`` (log(1..n)) and ``dt_bias`` (the inverse softplus of
a dt drawn log-uniformly in the model's ``ssm`` [dt_min, dt_max]). All
normal leaves come from one ``normal_`` call over one flat buffer and all
uniform ones from one ``uniform_`` call, on a ``torch.Generator`` of the
device seeded with ``--seed``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

import reference


def make(model: dict, seed: int, device,
         family: reference.Family) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, from ``seed``: the leaves of
    ``family``."""
    specs = family.leaves(model)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    n_norm = sum(math.prod(s) for _, s, k, _ in specs if k == "normal")
    n_unif = sum(math.prod(s) for _, s, k, _ in specs if k == "dt_bias")
    normal = torch.empty(n_norm, dtype=torch.float32, device=device)
    normal.normal_(0.0, 1.0, generator=gen)
    unif = torch.empty(n_unif, dtype=torch.float32, device=device)
    if n_unif:
        unif.uniform_(generator=gen)
    out: Dict[str, torch.Tensor] = {}
    on = ou = 0
    for name, shape, kind, std in specs:
        n = math.prod(shape)
        if kind == "normal":
            out[name] = normal[on:on + n].view(shape).mul_(std)
            on += n
        elif kind == "ones":
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif kind == "a_log":
            out[name] = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                               device=device))
        elif kind == "dt_bias":
            s = model["ssm"]
            u = unif[ou:ou + n]
            ou += n
            dt = torch.exp(u * (math.log(s["dt_max"]) - math.log(s["dt_min"]))
                           + math.log(s["dt_min"]))
            out[name] = dt + torch.log(-torch.expm1(-dt))
        else:
            raise ValueError(f"unknown init kind {kind!r}")
    return out


def layer_of(name: str) -> int:
    """The layer index of a ``layer<i>.`` leaf, or -1."""
    if not name.startswith("layer"):
        return -1
    return int(name[5:name.index(".")])

