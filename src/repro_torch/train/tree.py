"""The port's parameter and state trees: nested dicts, lists and tuples
(NamedTuples included) with tensors at the leaves.

What ``jax.tree`` does for the reference.  A dict's children are taken in
sorted key order, so a tree flattens the same way whatever order its dicts
were filled in; a ``None`` is an empty subtree, as in jax.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> Tuple[list, Callable[[list], Any]]:
    """``(children, rebuild)`` of an inner node; ``None`` for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda c: dict(zip(keys, c))
    if isinstance(tree, list):
        return list(tree), list
    if isinstance(tree, tuple):
        if hasattr(tree, "_fields"):                  # a NamedTuple
            return list(tree), lambda c: type(tree)(*c)
        return list(tree), tuple
    return None, None


def leaves_with_paths(tree, path: tuple = ()) -> List[Tuple[tuple, Any]]:
    """Every leaf with its path of keys and indices, in flattening order."""
    if tree is None:
        return []
    kids, _ = _children(tree)
    if kids is None:
        return [(path, tree)]
    keys = sorted(tree) if isinstance(tree, dict) else range(len(kids))
    return [pair for k, kid in zip(keys, kids)
            for pair in leaves_with_paths(kid, path + (k,))]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, flat: list):
    """``like``'s structure with its leaves replaced by ``flat``, in
    order."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        kids, rebuild = _children(t)
        if kids is None:
            return next(it)
        return rebuild([build(k) for k in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
