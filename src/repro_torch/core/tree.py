"""The port's stand-in for ``jax.tree`` over engine states: leaves listed in
the order ``jax.tree.leaves`` lists the JAX package's state of the same
engine (dataclass fields in declaration order, dict keys sorted, ``None``
an empty subtree, ``FlatLayout`` static), so checkpoint leaves line up
across the packages.  ``tree_flatten_with_path`` gives each leaf its path
of keys, as ``jax.tree_util``'s: a dict key (``.key``), a sequence index
(``.idx``), a dataclass field (``str`` is ``.name``)."""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.flat import FlatLayout

PyTree = Any


@dataclasses.dataclass(frozen=True)
class DictKey:
    key: Any


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    idx: int


@dataclasses.dataclass(frozen=True)
class GetAttrKey:
    name: str

    def __str__(self):
        return f".{self.name}"


def _keyed_children(node) -> list | None:
    """``(key, subtree)`` pairs of a container node in ``_children``'s
    order, or ``None`` for a leaf."""
    if node is None or isinstance(node, FlatLayout):
        return []
    if isinstance(node, dict):
        return [(DictKey(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(SequenceKey(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(GetAttrKey(f.name), getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def _children(node) -> list | None:
    """The subtrees of a container node, or ``None`` for a leaf."""
    kids = _keyed_children(node)
    return None if kids is None else [kid for _, kid in kids]


def tree_flatten_with_path(tree: PyTree, path: tuple = ()) -> list:
    """``(path, leaf)`` pairs in ``tree_leaves`` order; a path is a tuple
    of ``DictKey`` / ``SequenceKey`` / ``GetAttrKey``."""
    kids = _keyed_children(tree)
    if kids is None:
        return [(path, tree)]
    return [pair for key, kid in kids for pair in tree_flatten_with_path(kid, path + (key,))]


def tree_at(tree: PyTree, path: tuple):
    """The subtree of ``tree`` at ``path`` (keys as ``tree_flatten_with_path``
    gives them)."""
    for key in path:
        if isinstance(key, GetAttrKey):
            tree = getattr(tree, key.name)
        else:
            tree = tree[key.key if isinstance(key, DictKey) else key.idx]
    return tree


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
