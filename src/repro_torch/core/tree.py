"""The port's stand-in for ``jax.tree`` over engine states: leaves listed in
the order ``jax.tree.leaves`` lists the JAX package's state of the same
engine (dataclass fields in declaration order, dict keys sorted, ``None``
an empty subtree, ``FlatLayout`` static), so checkpoint leaves line up
across the packages."""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.flat import FlatLayout

PyTree = Any


def _children(node) -> list | None:
    """The subtrees of a container node, or ``None`` for a leaf."""
    if node is None or isinstance(node, FlatLayout):
        return []
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [getattr(node, f.name) for f in dataclasses.fields(node)]
    return None


def tree_leaves(tree: PyTree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_replace_leaves(like: PyTree, leaves) -> PyTree:
    """``like`` with its leaves replaced, in ``tree_leaves`` order, by
    ``leaves``."""
    it = iter(leaves)

    def rebuild(node):
        if node is None or isinstance(node, FlatLayout):
            return node
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        if _children(node) is not None:
            return dataclasses.replace(node, **{
                f.name: rebuild(getattr(node, f.name)) for f in dataclasses.fields(node)
            })
        return next(it)

    out = rebuild(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of trees of one structure."""
    leaves = zip(tree_leaves(tree), *(tree_leaves(r) for r in rest))
    return tree_replace_leaves(tree, [fn(*xs) for xs in leaves])
