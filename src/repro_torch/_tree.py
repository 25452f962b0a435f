"""Nested dicts of tensors (the port's parameter trees) in ``jax.tree``
order: dict keys sorted, list and tuple items by index."""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree: Any) -> list:
    """Every leaf of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like: Any, flat) -> Any:
    """A tree shaped like ``like`` whose leaves are ``flat``, taken in
    :func:`leaves` order (the inverse of ``leaves``)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def map_(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``jax.tree.map(fn, tree, *rest)`` over trees of one structure."""
    flat = [fn(*xs) for xs in zip(leaves(tree), *(leaves(r) for r in rest), strict=True)]
    return unflatten(tree, flat)
