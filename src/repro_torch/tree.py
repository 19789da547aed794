"""Trees of tensors, in jax's leaf order.

The port's state is nested dicts, lists and tuples of tensors (the
reference's pytrees). Every module that walks such a tree -- the client
bank, the protocol's aggregations, the optimizers, the LM layout
functions and the checkpoint writer -- goes through these helpers, so
all of them see the leaves in one order: the order ``jax.tree.leaves``
gives (dict keys sorted, lists and tuples in order, ``None`` an empty
node). That order is what makes a checkpoint the reference's file and a
leaf-by-leaf reduction the reference's sum.

``tree_flatten`` also returns the treedef string that
``str(jax.tree.flatten(tree)[1])`` prints for the same structure, built
here without jax.
"""
from __future__ import annotations

from typing import Any, List, Tuple


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


def _children(node) -> List:
    if node is None:
        return []
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    return list(node)


def _treedef(node) -> str:
    if node is None:
        return "None"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(node[k])}"
                               for k in sorted(node)) + "}"
    if isinstance(node, (list, tuple)):
        inner = ", ".join(_treedef(c) for c in node)
        if isinstance(node, list):
            return f"[{inner}]"
        return f"({inner},)" if len(node) == 1 else f"({inner})"
    return "*"


def _walk(node, out: List[Any]) -> None:
    if _is_node(node):
        for c in _children(node):
            _walk(c, out)
    else:
        out.append(node)


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        out = {k: _build(node[k], it) for k in sorted(node)}
        return {k: out[k] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*[_build(c, it) for c in node])
    if isinstance(node, (list, tuple)):
        return type(node)([_build(c, it) for c in node])
    return next(it)


# The walkers are module functions, not closures: a recursive closure is
# a reference cycle, which would keep its leaf list (every tensor of the
# tree) alive until the garbage collector runs, and a train step's old
# params with it.

def tree_flatten(tree) -> Tuple[List[Any], str]:
    """(leaves in jax's order, the treedef string jax prints)."""
    leaves: List[Any] = []
    _walk(tree, leaves)
    return leaves, f"PyTreeDef({_treedef(tree)})"


def tree_unflatten(like, leaves):
    """``like``'s structure with ``leaves`` (jax's leaf order). Dicts keep
    ``like``'s key order."""
    return _build(like, iter(leaves))


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in ``tree``'s structure."""
    leaves = tree_leaves(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map: {len(leaves)} leaves against "
                             f"{len(o)}")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])
