"""Nested-dict parameter trees, flattened in `jax.tree_util` order.

A tree is nested dicts, lists and tuples (named tuples included, in
field order); anything else (a tensor, None, a `MaskedLeaf`) is a leaf.
Dicts flatten in sorted key order and None leaves are counted, exactly
as `jax.tree_util.tree_flatten(tree, is_leaf=lambda x: x is None)` does
— the mask stream seeds are derived from these leaf indices, so the
port's order must equal the reference's.
"""
from __future__ import annotations

from typing import Any, Callable

_LEAF = object()


def _is_node(t) -> bool:
    return isinstance(t, (dict, list, tuple))


def _rebuild(t, values):
    """A list or tuple of `t`'s type holding `values`."""
    if hasattr(type(t), "_fields"):   # a named tuple
        return type(t)(*values)
    return type(t)(values)


def _flatten_into(t, leaves: list):
    if isinstance(t, dict):
        return {k: _flatten_into(t[k], leaves) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return _rebuild(t, [_flatten_into(v, leaves) for v in t])
    leaves.append(t)
    return _LEAF


def flatten(tree) -> tuple:
    """(leaves, treedef) with leaves in jax.tree_util order.  (Module-level
    recursion, not a self-referencing closure: a closure cycle would keep
    every leaf alive until the garbage collector runs.)"""
    leaves = []
    treedef = _flatten_into(tree, leaves)
    return leaves, treedef


def _unflatten_from(t, it):
    if isinstance(t, dict):
        return {k: _unflatten_from(v, it) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return _rebuild(t, [_unflatten_from(v, it) for v in t])
    return next(it)


def unflatten(treedef, leaves) -> Any:
    return _unflatten_from(treedef, iter(leaves))


def leaves(tree) -> list:
    return flatten(tree)[0]


def flatten_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] with '/'-joined keys, in flatten order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in flatten_with_paths(
            tree[k], f"{prefix}/{k}" if prefix else str(k))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in flatten_with_paths(
            v, f"{prefix}/{i}" if prefix else str(i))]
    return [(prefix, tree)]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Map `fn` over the leaves of `tree` (None leaves included) and the
    matching leaves of `rest`, which share its structure."""
    flat, tdef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(tdef, [fn(*xs) for xs in zip(flat, *others)])
