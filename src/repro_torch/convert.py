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

:func:`loras_from_jax` does the same for ``init_lm_loras``'s adapters.
:func:`split_from_jax` and :func:`opt_state_from_jax` take the LM train
step's state (``core.algorithms``'s split trees: client leaves with a
leading N, so a client group's layer axis is axis 1; adapter trees under
PEFT, with the frozen base under ``"base"``; the optimizer's count and
params-shaped moments) and :func:`lm_state_from_jax` both at once. The
inverse, :func:`lm_state_to_jax` (and ``split_to_jax``,
``opt_state_to_jax``, ``params_to_jax``), restacks the per-layer lists
into the reference's group stacking as ``checkpoint.StackedLeaf`` views,
which the checkpoint writer streams: an LM checkpoint is the reference's
file, byte for byte.

:func:`whisper_from_jax` takes ``repro.models.encdec.init_whisper``'s
tree, and :func:`whisper_split_from_jax` the whisper train step's
``{"client", "server"}`` split (client leaves with or without a leading
N): nested dicts and lists of arrays with no layer grouping, so only
the leaves change type. Their inverses, :func:`whisper_to_jax` and
:func:`whisper_split_to_jax`, give the same trees as numpy arrays.

:func:`qnet_params_from_jax` takes the CCC Q-network of
``repro.ccc.ddqn.init_qnet`` (``{"l1", "l2", "l3"}`` of ``{"w", "b"}``,
numpy arrays) and returns a state dict for the port's
``ccc.ddqn.QNet``: each ``w`` (d_in, d_out) becomes an ``nn.Linear``
weight (d_out, d_in), transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import StackedLeaf
from repro_torch.models.lm import ModelPlan
from repro_torch.tree import tree_map

_MOMENTS = ("m", "v", "mu")


def _tensor(a, device, index=None):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
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


def _unstack_groups(np_groups, groups, side, device, axis=0):
    if len(np_groups) != len(groups):
        raise ValueError(f"{side}: {len(np_groups)} param groups for a plan "
                         f"with {len(groups)}")
    out = []
    for gi, (g, gp) in enumerate(zip(groups, np_groups)):
        if len(gp) != len(g.period):
            raise ValueError(f"{side} group {gi}: {len(gp)} sublayers, the "
                             f"plan has {len(g.period)}")
        for leaf in (x for sub in gp for x in _leaves(sub)):
            if tuple(leaf.shape)[axis] != g.repeat:
                raise ValueError(f"{side} group {gi}: layer axis "
                                 f"{tuple(leaf.shape)[axis]} != repeat "
                                 f"{g.repeat}")
        index = (lambda i: i) if axis == 0 else (lambda i: (slice(None), i))
        out.append([tuple(_tree(sub, device, index(i)) for sub in gp)
                    for i in range(g.repeat)])
    return out


def _stack_groups(groups_params, groups, axis=0):
    """Inverse of ``_unstack_groups``: each group as the reference's tuple
    (one entry a sublayer) of trees whose leaves stack the group's layers
    along ``axis``, as ``StackedLeaf`` views."""
    out = []
    for g, gp in zip(groups, groups_params):
        if len(gp) != g.repeat:
            raise ValueError(f"group of {len(gp)} layers, repeat {g.repeat}")
        out.append(tuple(
            tree_map(lambda *parts: StackedLeaf(parts, axis),
                     *[gp[r][i] for r in range(g.repeat)])
            for i in range(len(g.period))))
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


def loras_from_jax(np_loras, plan: ModelPlan, device="cpu"):
    """The reference's ``init_lm_loras`` tree (numpy leaves, groups stacked
    along axis 0) -> the port's adapter layer lists."""
    return {"client": _unstack_groups(np_loras["client"], plan.client_groups,
                                      "client", device),
            "server": _unstack_groups(np_loras["server"], plan.server_groups,
                                      "server", device)}


def params_to_jax(params, plan: ModelPlan):
    """Port params (``init_lm`` layout) -> the reference's layout, groups
    as ``StackedLeaf`` views."""
    return dict(params,
                client=_stack_groups(params["client"], plan.client_groups),
                server=_stack_groups(params["server"], plan.server_groups))


def _side_from_jax(np_side, groups, device, axis):
    return {k: _unstack_groups(v, groups, k, device, axis) if k == "groups"
            else _tree(v, device) for k, v in np_side.items()}


def _side_to_jax(side, groups, axis):
    return {k: _stack_groups(v, groups, axis) if k == "groups" else v
            for k, v in side.items()}


def split_from_jax(np_split, plan: ModelPlan, device="cpu"):
    """The reference's split tree (``split_lm_params`` or, under PEFT,
    ``split_lm_lora_params``; numpy or CPU-tensor leaves) -> the port's."""
    out = {"client": _side_from_jax(np_split["client"], plan.client_groups,
                                    device, 1),
           "server": _side_from_jax(np_split["server"], plan.server_groups,
                                    device, 0)}
    if "base" in np_split:
        out["base"] = params_from_jax(np_split["base"], plan, device)
    return out


def split_to_jax(split, plan: ModelPlan):
    """Inverse of ``split_from_jax`` (``StackedLeaf`` group leaves)."""
    out = {"client": _side_to_jax(split["client"], plan.client_groups, 1),
           "server": _side_to_jax(split["server"], plan.server_groups, 0)}
    if "base" in split:
        out["base"] = params_to_jax(split["base"], plan)
    return out


def opt_state_from_jax(np_state, plan: ModelPlan, device="cpu"):
    """The reference's optimizer state over a split tree -> the port's:
    params-shaped moments relayout, the count is kept."""
    return {k: split_from_jax(v, plan, device) if k in _MOMENTS
            else _tensor(v, device) for k, v in np_state.items()}


def opt_state_to_jax(state, plan: ModelPlan):
    return {k: split_to_jax(v, plan) if k in _MOMENTS else v
            for k, v in state.items()}


def lm_state_from_jax(state, plan: ModelPlan, device="cpu"):
    """``{"params", "opt"}`` of an LM run (the launcher's checkpoint
    payload) from the reference's layout."""
    return {"params": split_from_jax(state["params"], plan, device),
            "opt": opt_state_from_jax(state["opt"], plan, device)}


def lm_state_to_jax(state, plan: ModelPlan):
    return {"params": split_to_jax(state["params"], plan),
            "opt": opt_state_to_jax(state["opt"], plan)}


def _nested(node, fn):
    if isinstance(node, dict):
        return {k: _nested(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_nested(v, fn) for v in node)
    return fn(node)


def whisper_from_jax(np_params, device="cpu"):
    """The reference's ``init_whisper`` tree (numpy leaves) -> the port's
    on ``device``; the layout is the same."""
    return _nested(np_params, lambda a: _tensor(a, device))


def whisper_split_from_jax(np_split, device="cpu"):
    """The reference's whisper split (``split_whisper_params``, or its
    client side stacked to N) -> the port's on ``device``."""
    return {k: whisper_from_jax(np_split[k], device)
            for k in ("client", "server")}


def whisper_to_jax(params):
    """Port whisper params -> the reference's layout, numpy leaves."""
    return _nested(params, lambda t: t.detach().cpu().numpy())


def whisper_split_to_jax(split):
    return {k: whisper_to_jax(split[k]) for k in ("client", "server")}


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
