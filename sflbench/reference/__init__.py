"""Plain PyTorch reference of the benchmark's split training step. It
imports nothing of the program and no JAX.

A model family is a module of this package, ``reference/<stem>.py``,
that a configuration file names with ``"family_module": "<stem>"``
(``model`` when the key is absent: the dense and ssm layers). It gives

* ``layer_leaves(model, i)``: the ``(name, shape, kind, std)`` leaves of
  layer ``i``, named as the port's per-layer tree names them
  (``layer3.attn.wq.w``); ``kind`` is one of ``harness/weights.py``'s;
* ``layer(p, i, x, model)``: layer ``i`` on the residual stream, returning
  ``x`` or ``(x, aux)`` with ``aux`` a scalar added to the loss;
* ``TINY``: per ``arch_type``, the keys that shrink a model to CPU size
  (a nested dict updates the nested group);

and may give ``embed(p, tokens, model)``, ``logits(p, h, model)``,
``outer_leaves(model)`` (the leaves before and after the layers) and
``AUX_WEIGHT`` (the weight of the summed ``aux`` in the loss). :class:`Family`
supplies what a module leaves out: the table lookup, ``rmsnorm(h) @
head.w``, the embedding, final-norm and head leaves, and 0.01 (the port's
``lm_loss``).
"""
from __future__ import annotations

import math

from reference import model as _model


def embed(p, tokens, model):
    return p["embed.table"][tokens.long()]


def logits(p, h, model):
    return _model.rmsnorm(h, p["final_norm.scale"], model["norm_eps"]) \
        @ p["head.w"]


def outer_leaves(model):
    """(leaves before the layers, leaves after them): the embedding; the
    final norm and the head (untied: the split keeps the embedding with
    the clients and the head with the server)."""
    d, v = model["d_model"], model["vocab_size"]
    return ([("embed.table", (v, d), "normal", 0.02)],
            [("final_norm.scale", (d,), "ones", 0.0),
             ("head.w", (d, v), "normal", 1.0 / math.sqrt(d))])


class Family:
    """A family module with the defaults filled in."""

    def __init__(self, module):
        self.module = module
        self.layer_leaves = module.layer_leaves
        self.tiny = module.TINY
        self.embed = getattr(module, "embed", embed)
        self.logits = getattr(module, "logits", logits)
        self.outer_leaves = getattr(module, "outer_leaves", outer_leaves)
        self.aux_weight = getattr(module, "AUX_WEIGHT", 0.01)

    def leaves(self, model):
        """Every leaf in a fixed order: those before the layers, the
        layers', those after."""
        first, last = self.outer_leaves(model)
        out = list(first)
        for i in range(model["num_layers"]):
            out += self.layer_leaves(model, i)
        return out + list(last)

    def layer(self, p, i, x, model):
        """``(x, aux)``, aux None where the layer gives none."""
        out = self.module.layer(p, i, x, model)
        return out if isinstance(out, tuple) else (out, None)

