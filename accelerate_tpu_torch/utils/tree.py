"""Minimal pytree helpers over the port's param trees (dicts, lists, tuples, NamedTuples).

Leaves are everything that is not a container; ``None`` is an empty subtree. Dict keys
are visited in sorted order, as ``jax.tree_util`` visits them, so sums over
``tree_leaves`` add up in the JAX package's order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["tree_leaves", "tree_map", "tree_unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    return [tree]


def _rebuild(tree, children):
    if _is_namedtuple(tree):
        return type(tree)(*children)
    return type(tree)(children)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, child, *(r[i] for r in rest))
                               for i, child in enumerate(tree)])
    return fn(tree, *rest)


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node, it: Iterator):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {key: build(node[key], it) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [build(child, it) for child in node])
        return next(it)

    return build(like, it)
