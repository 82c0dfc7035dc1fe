"""Sharding rules: parameter / posterior / batch / cache partition specs
(port of ``repro.launch.sharding``), and the placement of a tensor's blocks
on a ``launch.mesh.Mesh``.

Policy (the reference's):
  * every >=2D weight shards its last two dims over ("data", "model") —
    FSDP on the penultimate dim, tensor parallelism on the last;
  * MoE expert stacks [.., E, D, F] shard E over "model" (expert
    parallelism) and D over "data";
  * dims that do not divide the axis size are replicated;
  * the leading agent axis (size n_pods) shards over "pod";
  * batch shards over ("pod" agent dim) x ("data");
  * 1D leaves (norm scales, biases, Lambda) replicate.

The posterior (mu, rho), Adam states, and gradients inherit the parameter
specs leaf-wise.  A tree is a parameter dict, a ``BayesTrainState`` or a
decode cache of tensors (any device; the ``meta`` device holds shapes
only); a leaf's path name is the reference's ``_path_str`` (a dataclass
field prints as ``.name``, so ``"moe" in name`` matches the same leaves).

``PartitionSpec``: a tuple of ``None``, an axis name, or a tuple of names,
one entry a dim (trailing dims absent = replicated), as
``jax.sharding.PartitionSpec``.  ``shard_blocks`` / ``join_blocks`` split
a tensor into the block each mesh position holds under a spec, on that
position's device, and join them back: the pod consensus and expert
parallelism place their blocks with them.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.core.tree import tree_flatten_with_path, tree_replace_leaves

PyTree = Any


class PartitionSpec(tuple):
    """Per-dim mesh axes: ``PartitionSpec("pod", None, ("data", "model"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class NamedSharding:
    """A ``PartitionSpec`` over a mesh (a leaf of the sharding trees)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and self.spec == other.spec)

    def __hash__(self):
        return hash((self.mesh, self.spec))

    def __repr__(self):
        return f"NamedSharding(mesh={self.mesh.shape}, spec={self.spec!r})"


def _divisible(dim: int, mesh, axis: str) -> bool:
    return axis in mesh.shape and dim % mesh.shape[axis] == 0 and dim > 0


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _tree_map_with_path(fn, tree: PyTree) -> PyTree:
    return tree_replace_leaves(tree, [fn(path, leaf)
                                      for path, leaf in tree_flatten_with_path(tree)])


def leaf_pspec(path, leaf, mesh, *, agent_leading: bool = False) -> PartitionSpec:
    """PartitionSpec for one parameter leaf (without the agent axis)."""
    name = _path_str(path)
    shape = tuple(leaf.shape)
    if len(shape) == 0:
        return P()  # scalars (step counters) replicate
    offset = 1 if agent_leading else 0  # leading agent dim handled by caller
    body = list(shape[offset:])
    spec: list = [None] * len(body)

    is_expert = ("w_gate" in name or "w_up" in name or "w_down" in name) and (
        "moe" in name and len(body) >= 3
    )
    if is_expert:
        # [..., E, D, F] (or [..., E, F, D]) — expert parallelism on E
        e_dim = len(body) - 3
        if _divisible(body[e_dim], mesh, "model"):
            spec[e_dim] = "model"
        if _divisible(body[e_dim + 1], mesh, "data"):
            spec[e_dim + 1] = "data"
    elif len(body) >= 2:
        d2, d1 = body[-2], body[-1]
        if _divisible(d2, mesh, "data"):
            spec[-2] = "data"
        if _divisible(d1, mesh, "model"):
            spec[-1] = "model"
        elif spec[-2] is None and _divisible(d1, mesh, "data"):
            # at least FSDP the big dim if TP doesn't divide
            spec[-1] = "data"
    # 1D leaves replicate
    full = ([("pod" if "pod" in mesh.shape else None)] if agent_leading else []) + spec
    return P(*full)


def param_shardings(params_shape: PyTree, mesh, *, agent_leading: bool = False) -> PyTree:
    """``NamedSharding`` tree matching ``params_shape`` (a tree of tensors,
    a ``BayesTrainState`` included)."""

    def one(path, leaf):
        return NamedSharding(mesh, leaf_pspec(path, leaf, mesh, agent_leading=agent_leading))

    return _tree_map_with_path(one, params_shape)


def batch_pspec(mesh, shape: tuple, *, agent_leading: bool = True) -> PartitionSpec:
    """Token batches [A, B, S, ...]: A over pod, B over data — each only
    when the dimension size divides the axis."""
    spec: list = [None] * len(shape)
    i = 0
    if agent_leading:
        if _divisible(shape[0], mesh, "pod"):
            spec[0] = "pod"
        i = 1
    if len(shape) > i and _divisible(shape[i], mesh, "data"):
        spec[i] = "data"
    return P(*spec)


# (scheme, leaf-name) -> [(dim-from-end, mesh-axis), ...]
_CACHE_DIMS = {
    ("kv", "k"): [(-4, "data"), (-2, "model")],
    ("kv", "v"): [(-4, "data"), (-2, "model")],
    ("kv", "pos"): [(-2, "data")],
    ("kv", "k_scale"): [(-3, "data"), (-1, "model")],
    ("kv", "v_scale"): [(-3, "data"), (-1, "model")],
    ("mlstm", "C"): [(-4, "data"), (-1, "model")],
    ("mlstm", "n"): [(-3, "data"), (-1, "model")],
    ("mlstm", "m"): [(-2, "data")],
    ("slstm", "c"): [(-2, "data"), (-1, "model")],
    ("slstm", "n"): [(-2, "data"), (-1, "model")],
    ("slstm", "h"): [(-2, "data"), (-1, "model")],
    ("slstm", "m"): [(-2, "data")],
    ("rglru", "h"): [(-2, "data"), (-1, "model")],
    ("rglru", "conv"): [(-3, "data"), (-1, "model")],
}


def cache_pspec(path, leaf, mesh, *, agent_leading: bool = True) -> PartitionSpec:
    """Decode caches: batch dim over data, kv-heads / feature dims over
    model, everything guarded by divisibility (B=1 long-context decode
    replicates)."""
    name = _path_str(path)
    parts = name.split("/")
    leaf_name = parts[-1]
    if "mlstm" in parts:
        scheme = "mlstm"
    elif "slstm" in parts:
        scheme = "slstm"
    elif leaf_name in ("k", "v", "pos", "k_scale", "v_scale"):
        scheme = "kv"
    elif leaf_name in ("h", "conv"):
        scheme = "rglru"
    else:
        scheme = None
    shape = tuple(leaf.shape)
    spec: list = [None] * len(shape)
    for dim, axis in _CACHE_DIMS.get((scheme, leaf_name), []):
        idx = len(shape) + dim
        if 0 <= idx < len(shape) and _divisible(shape[idx], mesh, axis):
            if spec[idx] is None:
                spec[idx] = axis
    if agent_leading and len(shape) >= 1 and spec[0] is None:
        if _divisible(shape[0], mesh, "pod"):
            spec[0] = "pod"
    return P(*spec)


def cache_shardings(cache_shape: PyTree, mesh, *, agent_leading: bool = True):
    def one(path, leaf):
        return NamedSharding(mesh, cache_pspec(path, leaf, mesh, agent_leading=agent_leading))

    return _tree_map_with_path(one, cache_shape)


def replicated(mesh):
    return NamedSharding(mesh, P())


def sharding_report(params_shape: PyTree, mesh, agent_leading: bool = False):
    """(n_params, bytes_total, bytes_max_per_device, n_replicated_leaves)."""
    n_params = 0
    total = 0
    per_dev = 0
    n_repl = 0
    for path, leaf in tree_flatten_with_path(params_shape):
        spec = leaf_pspec(path, leaf, mesh, agent_leading=agent_leading)
        size = math.prod(leaf.shape) if len(leaf.shape) else 1
        bts = size * leaf.dtype.itemsize
        shard_factor = 1
        for dim_spec in spec:
            if dim_spec is not None:
                shard_factor *= mesh.shape[dim_spec]
        if shard_factor == 1 and len(leaf.shape) >= 2:
            n_repl += 1
        n_params += size
        total += bts
        per_dev += bts // shard_factor
    return n_params, total, per_dev, n_repl


# ---------------------------------------------------------------------------
# placement: the block each mesh position holds
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def block_index(spec: PartitionSpec, mesh, position: dict) -> tuple:
    """Per dim of the spec, ``(block, blocks)``: which of the dim's equal
    blocks ``position`` holds (row-major over a tuple entry's axes)."""
    out = []
    for entry in spec:
        i, n = 0, 1
        for axis in _entry_axes(entry):
            i = i * mesh.shape[axis] + position[axis]
            n *= mesh.shape[axis]
        out.append((i, n))
    return tuple(out)


def _block(x, index):
    for dim, (i, n) in enumerate(index):
        if n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split in {n}")
            size = x.shape[dim] // n
            x = x.narrow(dim, i * size, size)
    return x


def shard_blocks(x, sharding: NamedSharding) -> list:
    """The block of ``x`` each position of ``sharding.mesh`` holds, in
    row-major position order, on that position's device (a view of ``x``
    where the device is ``x``'s; an abstract mesh keeps ``x``'s)."""
    mesh, spec = sharding.mesh, sharding.spec
    return [_block(x, block_index(spec, mesh, pos)).to(mesh.device_at(pos, x.device))
            for pos in mesh.positions()]


def join_blocks(blocks, sharding: NamedSharding, device=None):
    """The inverse of ``shard_blocks``: one tensor from the blocks (each
    distinct block taken from the first position holding it), on
    ``device`` (default the first block's)."""
    mesh, spec = sharding.mesh, sharding.spec
    first = blocks[0]
    device = first.device if device is None else device
    shape = list(first.shape)
    for dim, entry in enumerate(spec):
        for axis in _entry_axes(entry):
            shape[dim] *= mesh.shape[axis]
    out = first.new_empty(shape, device=device)
    seen = set()
    for pos, blk in zip(mesh.positions(), blocks):
        index = block_index(spec, mesh, pos)
        if index not in seen:
            seen.add(index)
            _block(out, index).copy_(blk)
    return out


__all__ = [
    "NamedSharding", "P", "PartitionSpec", "batch_pspec", "block_index", "cache_pspec",
    "cache_shardings", "join_blocks", "leaf_pspec", "param_shardings", "replicated",
    "shard_blocks", "sharding_report",
]
