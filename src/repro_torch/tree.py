"""Nested-dict trees: the port's stand-in for ``jax.tree``.

Parameter, energy, MAC and cache trees are nested dicts of tensors.
``map_leaves`` maps over one or more trees of the same structure;
``leaves`` lists the leaves in ``jax.tree.leaves`` order (dict keys
sorted), so sums over leaves run in the reference's order.
"""
from __future__ import annotations

from typing import Any, List


def map_leaves(fn, tree, *rest, path=()):
    """Apply ``fn(path, leaf, *other_leaves)`` over a nested dict."""
    if isinstance(tree, dict):
        return {
            k: map_leaves(fn, v, *(r[k] for r in rest), path=path + (k,))
            for k, v in tree.items()
        }
    return fn(path, tree, *rest)


def leaves(tree) -> List[Any]:
    """The leaves of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]
