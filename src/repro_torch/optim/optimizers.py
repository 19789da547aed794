"""Functional optimizers over trees of tensors (port of
``repro.optim.optimizers``).

The API is the reference's (optax's): ``opt.init(params) -> state`` and
``opt.update(grads, state, params) -> (updates, state)``, applied with
:func:`apply_updates`. Params, grads and states are nested dicts, lists
and tuples of tensors (``repro_torch.tree``), so a state has the layout
of the params it was built for and moves through the same bank, cohort
and cut-migration functions. Nothing updates in place.

The arithmetic follows the reference's float32 op order. AdamW's bias
corrections are ``1 - b ** count`` in float32 (where ``torch.optim``
works in float64) and its ``weight_decay`` defaults to 0.0 (torch's is
0.01), so a port run takes the reference's steps. The step count is an
int32 scalar tensor on the device of the params.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import placed_like
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def _count(params) -> torch.Tensor:
    leaves = [l for l in tree_leaves(params) if isinstance(l, torch.Tensor)]
    device = leaves[0].device if leaves else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _scale(updates, s):
    return tree_map(lambda g: -s * g, updates)


def sgd(lr) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params=None):
        s = lr_fn(state["count"])
        return _scale(grads, s), {"count": state["count"] + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"count": _count(params),
                "mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        mu = tree_map(lambda m, g: beta * m + g, state["mu"], grads)
        upd = tree_map(lambda m, g: beta * m + g, mu, grads) \
            if nesterov else mu
        s = lr_fn(state["count"])
        return _scale(upd, s), {"count": state["count"] + 1, "mu": mu}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def zeros32(p):
        return torch.zeros_like(p, dtype=torch.float32)

    def init(params):
        return {"count": _count(params), "m": tree_map(zeros32, params),
                "v": tree_map(zeros32, params)}

    def update(grads, state, params):
        c = state["count"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        # float32 bias corrections, as the reference computes them
        bc1 = 1 - b1 ** c.to(torch.float32)
        bc2 = 1 - b2 ** c.to(torch.float32)
        s = lr_fn(state["count"])

        def u(m_, v_, p):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (-s * upd).to(p.dtype)

        return tree_map(u, m, v, params), {"count": c, "m": m, "v": v}

    return Optimizer(init, update)


def masked(inner: Optimizer, mask) -> Optimizer:
    """The trainable/frozen partition at the optimizer level: ``mask`` is
    a params-shaped tree of bools (True = trainable). The inner state is
    built over the trainable leaves only (a list), so moments do not
    exist for frozen leaves; frozen leaves get exact-zero updates."""
    mask_leaves = [bool(m) for m in tree_leaves(mask)]

    def _flat(tree):
        leaves, _ = tree_flatten(tree)
        if len(leaves) != len(mask_leaves):
            raise ValueError("masked(): tree/mask structure mismatch")
        return leaves

    def _select(leaves):
        return [x for x, m in zip(leaves, mask_leaves) if m]

    def init(params):
        return inner.init(_select(_flat(params)))

    def update(grads, state, params=None):
        g_leaves = _flat(grads)
        p_sel = None if params is None else _select(_flat(params))
        upd_sel, state = inner.update(_select(g_leaves), state, p_sel)
        it = iter(upd_sel)
        out = [next(it) if m else torch.zeros_like(g)
               for g, m in zip(g_leaves, mask_leaves)]
        return tree_unflatten(grads, out), state

    return Optimizer(init, update)


def make_optimizer(name: str, lr, weight_decay: float = 0.0) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")


def apply_updates(params, updates):
    """``params + updates``, each leaf in its param's dtype and, over
    DTensors (the dry run), in its param's layout: the update's pending
    reductions are made to fit it."""
    return tree_map(lambda p, u: placed_like(p + u.to(p.dtype), p), params,
                    updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(updates, max_norm: float):
    n = global_norm(updates)
    s = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda u: u * s, updates)
