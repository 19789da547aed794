"""Carry the reference's weights over to the port.

:func:`cnn_params_from_jax` takes the paper CNN's params (the list of
``{"w", "b"}`` blocks that ``repro.models.cnn.init_cnn`` returns, as
numpy arrays) and changes no layout: conv weights stay HWIO and fc
weights (d_in, d_out), as the port's ``models.cnn`` applies them.

:func:`params_from_jax` turns the tree that ``repro.models.lm.init_lm``
builds, given as numpy arrays (``jax.tree.map(np.asarray, params)`` on
the caller's side; this module imports no jax), into the port's
parameters. Two layouts differ:

* the reference stacks each layer group's parameters along a leading
  ``repeat`` axis for ``lax.scan``; the port keeps one dict per layer
  (``params[side][group][layer][sublayer]``), so that axis is unstacked;
* everything else is kept as it is: a ``linear``'s ``w`` is
  ``(d_in, d_out)`` and applied as ``x @ w`` in both packages, so no
  weight is transposed. The untied ``head`` that ``init_lm`` adds when
  ``cut >= 1`` is kept.

:func:`qnet_params_from_jax` takes the CCC Q-network of
``repro.ccc.ddqn.init_qnet`` (``{"l1", "l2", "l3"}`` of ``{"w", "b"}``,
numpy arrays) and returns a state dict for the port's
``ccc.ddqn.QNet``: each ``w`` (d_in, d_out) becomes an ``nn.Linear``
weight (d_out, d_in), transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import ModelPlan


def _tensor(a, device, index=None):
    a = np.asarray(a)
    if index is not None:
        a = a[index]
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(node, device, index=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, index) for k, v in node.items()}
    return _tensor(node, device, index)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def _unstack_groups(np_groups, groups, side, device):
    if len(np_groups) != len(groups):
        raise ValueError(f"{side}: {len(np_groups)} param groups for a plan "
                         f"with {len(groups)}")
    out = []
    for gi, (g, gp) in enumerate(zip(groups, np_groups)):
        if len(gp) != len(g.period):
            raise ValueError(f"{side} group {gi}: {len(gp)} sublayers, the "
                             f"plan has {len(g.period)}")
        for leaf in (x for sub in gp for x in _leaves(sub)):
            if np.shape(leaf)[0] != g.repeat:
                raise ValueError(f"{side} group {gi}: leading axis "
                                 f"{np.shape(leaf)[0]} != repeat {g.repeat}")
        out.append([tuple(_tree(sub, device, i) for sub in gp)
                    for i in range(g.repeat)])
    return out


def params_from_jax(np_params, plan: ModelPlan, device="cpu"):
    """The reference's ``init_lm`` tree (numpy leaves) -> port params."""
    out = {
        "embed": _tree(np_params["embed"], device),
        "client": _unstack_groups(np_params["client"], plan.client_groups,
                                  "client", device),
        "server": _unstack_groups(np_params["server"], plan.server_groups,
                                  "server", device),
        "final_norm": _tree(np_params["final_norm"], device),
    }
    if "head" in np_params:
        out["head"] = _tree(np_params["head"], device)
    return out


def cnn_params_from_jax(np_params, device="cpu"):
    """The reference's paper-CNN params (a list of ``{"w", "b"}`` dicts
    of numpy arrays) -> the port's, on ``device``, layouts unchanged."""
    return [{k: _tensor(v, device) for k, v in blk.items()}
            for blk in np_params]


def qnet_params_from_jax(np_params, device="cpu"):
    """The reference's Q-network (numpy leaves) -> a ``QNet`` state dict
    on ``device``, each ``w`` transposed to ``nn.Linear``'s (out, in)."""
    out = {}
    for name in ("l1", "l2", "l3"):
        out[f"{name}.weight"] = _tensor(np.asarray(np_params[name]["w"]).T,
                                        device)
        out[f"{name}.bias"] = _tensor(np_params[name]["b"], device)
    return out
