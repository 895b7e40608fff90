"""Nested-dict parameter trees, flattened in JAX's leaf order.

The port keeps parameters, gradients and sync buffers as nested dicts of
tensors with the same structure as the JAX package's pytrees.  Leaves are
visited with dict keys sorted (what ``jax.tree.leaves`` does), so the flat
sync buffer packs leaves in the same order on both sides and the EF residual
of one converts to the other's without permutation.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def _children(tree: Tree):
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):                  # NamedTuple: field order
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    return None


def leaves_with_path(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr, leaf)]`` in JAX's flatten order; ``keystr`` matches
    ``jax.tree_util.keystr`` for dict keys (``['blocks']['pos0']...``)."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in kids:
        out.extend(leaves_with_path(sub, prefix + key))
    return out


def leaves(tree: Tree) -> List[Any]:
    return [x for _, x in leaves_with_path(tree)]


def unflatten(like: Tree, flat: List[Any]) -> Tree:
    """Rebuild ``like``'s structure from leaves in flatten order."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    others = [leaves(r) for r in rest]
    flat = [fn(x, *(o[i] for o in others))
            for i, x in enumerate(leaves(tree))]
    return unflatten(tree, flat)
