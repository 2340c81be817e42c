"""Minimal pytree helpers over the port's param trees (dicts, lists, tuples, NamedTuples).

Leaves are everything that is not a container; ``None`` is an empty subtree; a tuple
whose class sets ``_tree_leaf`` (the partition spec ``parallel.mesh.P``) is one leaf, so
a tree of specs maps like a tree of params. Dict keys
are visited in sorted order, as ``jax.tree_util`` visits them, so sums over
``tree_leaves`` add up in the JAX package's order.

``named_parameters`` / ``unflatten_to_nested_dict`` / ``listify_int_dicts`` are the
port's copies of ``accelerate_tpu/utils/modeling.py::named_parameters`` (with
``utils/serialization.py::flatten_pytree``), ``utils/serialization.py::
unflatten_to_nested_dict`` and ``big_modeling.py::_listify_int_dicts``: a tree flattens
to ``{"layers/0/wq": leaf}`` keys as in JAX, and back.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["tree_leaves", "tree_map", "tree_unflatten", "named_parameters",
           "unflatten_to_nested_dict", "listify_int_dicts"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_seq(x) -> bool:
    """A list or tuple container (not a tuple that declares itself a leaf)."""
    return isinstance(x, (list, tuple)) and not getattr(type(x), "_tree_leaf", False)


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if _is_seq(tree):
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
    if _is_seq(tree):
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
        if _is_seq(node):
            return _rebuild(node, [build(child, it) for child in node])
        return next(it)

    return build(like, it)


def named_parameters(tree, sep: str = "/") -> dict:
    """Flatten a tree to ``{"a/b/0/c": leaf}`` in :func:`tree_leaves` order (dict keys
    sorted, list and tuple entries by index)."""
    flat = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + [str(key)])
        elif _is_seq(node):
            for i, child in enumerate(node):
                walk(child, path + [str(i)])
        else:
            flat[sep.join(path)] = node

    walk(tree, [])
    return flat


def unflatten_to_nested_dict(flat: dict, sep: str = "/") -> dict:
    """Nested dicts from joined keys (list indices come back as ``"0"``, ``"1"``, ...
    keys: :func:`listify_int_dicts` turns those into lists)."""
    nested: dict = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = nested
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return nested


def listify_int_dicts(node):
    """``{"0": x, "1": y}`` dicts back into lists, all the way down."""
    if isinstance(node, dict):
        conv = {k: listify_int_dicts(v) for k, v in node.items()}
        if conv and all(k.isdigit() for k in conv):
            return [conv[str(i)] for i in range(len(conv))]
        return conv
    return node
