"""Placed trees and collectives over a ``launch.mesh.Mesh``: the port's
counterpart of ``jax.device_put`` under a ``NamedSharding`` and of the
collectives GSPMD inserts into the reference's sharded steps.

One process drives every mesh position (single controller, as the
reference: one ``jit`` runs all devices).  A position's device may repeat
(virtual shards, which run one after another on that device) or be a card
of its own; nothing here needs ``torch.distributed``.

* ``Placed``: a tensor placed under a ``NamedSharding``: its global shape
  and dtype, and one block per mesh position (``launch.sharding
  .shard_blocks``), on that position's device.  Where a position's device
  is the source's, its block is a view of the source.  A position may hold
  no block (``None``): ``Placed.agent`` restricts an agent-leading leaf to
  one agent's pod.  ``Placed`` is a leaf of ``core.tree``'s trees.
* ``device_put(tree, shardings)`` / ``device_get(tree, device)``: place a
  tree of tensors leaf by leaf, and join a placed tree back (each distinct
  block taken from the first position holding it), as ``jax.device_put``
  and ``np.asarray``.
* ``all_gather`` / ``reduce_scatter`` / ``all_reduce`` over one mesh axis,
  on ``{position: tensor}`` dicts (the positions taking part; those that
  differ only along the axis form a group, in axis order).  Copies are
  ``Tensor.to`` and sums run in axis order, with no atomics, so two calls
  give the same bits; a sum of bf16 / f16 blocks accumulates in float32
  and rounds once.  Each is differentiable through autograd of its copies
  and sums.  Counted bytes are the schedule's: the blocks that cross from
  one position to another, whether or not the two share a device.
* ``gather`` / ``gather_rows``: one position assembles a region of a
  placed leaf (or a leaf's rows for a token list) from the blocks that
  store it, its own block in place and the rest copied from the first
  position holding each (counted as ``"gather"``).
* ``spmd_counts()``: calls and bytes of each collective since the last
  ``reset_spmd_counts()``, as ``expert_parallel.ep_counts()`` counts its
  traffic.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.sharding import NamedSharding, block_index, shard_blocks

KINDS = ("all_gather", "reduce_scatter", "all_reduce", "gather")
_counts = {k: 0 for k in KINDS} | {f"{k}_bytes": 0 for k in KINDS}
_gathered: dict[int, int] = {}  # position -> bytes its gathers copied in


def spmd_counts() -> dict:
    """Calls and cross-position bytes of each collective, ``bytes`` in
    all, and ``gather_by_position`` (``{position: bytes}``), since the last
    ``reset_spmd_counts``."""
    out: dict = dict(_counts)
    out["bytes"] = sum(_counts[f"{k}_bytes"] for k in KINDS)
    out["gather_by_position"] = dict(_gathered)
    return out


def reset_spmd_counts() -> None:
    for k in _counts:
        _counts[k] = 0
    _gathered.clear()


def record(kind: str, nbytes: int, position: int | None = None) -> None:
    """Count one ``kind`` call moving ``nbytes`` across positions (into
    ``position``, for a gather)."""
    _counts[kind] += 1
    _counts[f"{kind}_bytes"] += int(nbytes)
    if position is not None:
        _gathered[position] = _gathered.get(position, 0) + int(nbytes)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class Placed:
    """A tensor of ``shape`` and ``dtype`` as blocks on the positions of
    ``sharding.mesh`` (row-major; ``None`` where a position holds none)."""

    __slots__ = ("sharding", "blocks", "shape", "dtype", "_ids")

    def __init__(self, sharding: NamedSharding, blocks: list, shape, dtype):
        self.sharding = sharding
        self.blocks = list(blocks)
        self.shape = tuple(shape)
        self.dtype = dtype
        self._ids = None

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self):
        return (f"Placed(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec!r}, mesh={self.mesh.shape})")

    def grid(self) -> tuple:
        """Blocks along each dim."""
        spec = tuple(self.sharding.spec) + (None,) * (self.ndim - len(self.sharding.spec))
        pos0 = next(iter(self.mesh.positions()))
        return tuple(n for _, n in block_index(spec, self.mesh, pos0))

    def block_id(self, i: int) -> tuple:
        """The block index, per dim, position ``i`` holds."""
        if self._ids is None:
            spec = tuple(self.sharding.spec) + (None,) * (self.ndim - len(self.sharding.spec))
            self._ids = [tuple(b for b, _ in block_index(spec, self.mesh, pos))
                         for pos in self.mesh.positions()]
        return self._ids[i]

    def holder(self, i: int, bid: tuple) -> int:
        """``i`` if it holds block ``bid``, else the first position that does."""
        if self.blocks[i] is not None and self.block_id(i) == bid:
            return i
        for j, blk in enumerate(self.blocks):
            if blk is not None and self.block_id(j) == bid:
                return j
        raise ValueError(f"no position holds block {bid} of {self!r}")

    def first_holders(self) -> list[int]:
        """The positions that hold a distinct block first (row-major)."""
        seen, out = set(), []
        for j, blk in enumerate(self.blocks):
            if blk is not None and self.block_id(j) not in seen:
                seen.add(self.block_id(j))
                out.append(j)
        return out

    def agent(self, a: int) -> "Placed":
        """Agent ``a`` of an agent-leading leaf: each block's row for ``a``
        on the positions of the pod holding it (views), ``None`` elsewhere;
        the spec without its leading entry."""
        n = self.grid()[0]
        per = self.shape[0] // n
        blocks = [blk[a % per] if blk is not None and self.block_id(j)[0] == a // per else None
                  for j, blk in enumerate(self.blocks)]
        return Placed(NamedSharding(self.mesh, tuple(self.sharding.spec)[1:]), blocks,
                      self.shape[1:], self.dtype)

    def get(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first block's),
        each distinct block copied from the first position holding it."""
        first = next(b for b in self.blocks if b is not None)
        out = first.new_empty(self.shape, device=first.device if device is None else device)
        grid, seen = self.grid(), set()
        for j, blk in enumerate(self.blocks):
            if blk is None or self.block_id(j) in seen:
                continue
            seen.add(self.block_id(j))
            view = out
            for d, (b, n) in enumerate(zip(self.block_id(j), grid)):
                if n > 1:
                    view = view.narrow(d, b * blk.shape[d], blk.shape[d])
            view.copy_(blk)
        return out


def is_placed(tree) -> bool:
    return any(isinstance(leaf, Placed) for leaf in tree_leaves(tree))


def place(x: torch.Tensor, sharding: NamedSharding) -> Placed:
    return Placed(sharding, shard_blocks(x, sharding), x.shape, x.dtype)


def device_put(tree, shardings):
    """``tree`` with each tensor leaf placed under its ``NamedSharding``
    (``shardings`` a tree of the same structure, as
    ``launch.sharding.param_shardings`` / ``cache_shardings`` give)."""
    return tree_map(lambda x, sh: x if isinstance(x, Placed) else place(x, sh), tree,
                    shardings)


def device_get(tree, device=None):
    """A placed tree joined back into tensors on ``device``."""
    return tree_map(lambda x: x.get(device) if isinstance(x, Placed) else x, tree)


def blocks_at(tree, i: int):
    """Position ``i``'s blocks of a placed tree (other leaves as they are)."""
    return tree_map(lambda x: x.blocks[i] if isinstance(x, Placed) else x, tree)


def position_bytes(tree, i: int) -> int:
    """The bytes of the blocks position ``i`` holds."""
    return sum(_nbytes(x.blocks[i]) for x in tree_leaves(tree)
               if isinstance(x, Placed) and x.blocks[i] is not None)


# ---------------------------------------------------------------------------
# collectives over one mesh axis
# ---------------------------------------------------------------------------


def axis_groups(mesh, axis: str, members) -> list[list[int]]:
    """The positions of ``members`` grouped by every axis but ``axis``,
    each group in ``axis`` order."""
    groups: dict[tuple, list[int]] = {}
    for i, pos in enumerate(mesh.positions()):
        if i in members:
            groups.setdefault(tuple(v for a, v in pos.items() if a != axis), []).append(i)
    return list(groups.values())


def _sum(group, blocks, device):
    """The group's blocks summed in order on ``device``; bf16 / f16 in
    float32, rounded once to the blocks' dtype."""
    first = blocks[group[0]]
    wide = first.dtype in (torch.bfloat16, torch.float16)
    acc = first.to(device)
    acc = acc.float() if wide else acc
    for j in group[1:]:
        b = blocks[j].to(device)
        acc = acc + (b.float() if wide else b)
    return acc.to(first.dtype)


def all_reduce(blocks: dict, mesh, axis: str) -> dict:
    """Each position gets the sum of its group's blocks (computed once on
    the group's first position, then copied)."""
    out = {}
    for group in axis_groups(mesh, axis, blocks):
        if len(group) == 1:
            out[group[0]] = blocks[group[0]]
            continue
        root = blocks[group[0]].device
        total = _sum(group, blocks, root)
        for j in group:
            out[j] = total.to(blocks[j].device)
        record("all_reduce", 2 * (len(group) - 1) * _nbytes(blocks[group[0]]))
    return out


def all_gather(blocks: dict, mesh, axis: str, dim: int) -> dict:
    """Each position gets its group's blocks concatenated along ``dim`` in
    axis order (one concatenation for each device)."""
    out = {}
    for group in axis_groups(mesh, axis, blocks):
        if len(group) == 1:
            out[group[0]] = blocks[group[0]]
            continue
        made: dict = {}
        for j in group:
            dev = blocks[j].device
            if dev not in made:
                made[dev] = torch.cat([blocks[k].to(dev) for k in group], dim)
            out[j] = made[dev]
        k = len(group)
        record("all_gather", k * (k - 1) * _nbytes(blocks[group[0]]))
    return out


def reduce_scatter(blocks: dict, mesh, axis: str, dim: int) -> dict:
    """The group's sum, split along ``dim`` into equal chunks: the r-th
    position of a group gets chunk r."""
    out = {}
    for group in axis_groups(mesh, axis, blocks):
        k = len(group)
        if k == 1:
            out[group[0]] = blocks[group[0]]
            continue
        first = blocks[group[0]]
        if first.shape[dim] % k:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(first.shape)} does not "
                             f"split in {k}")
        total = _sum(group, blocks, first.device)
        for j, chunk in zip(group, total.chunk(k, dim)):
            out[j] = chunk.to(blocks[j].device)
        n = _nbytes(first)
        record("reduce_scatter", (k - 1) * n + (k - 1) * (n // k))
    return out


# ---------------------------------------------------------------------------
# one position's gathers of what it computes with
# ---------------------------------------------------------------------------


def gather(leaf: Placed, i: int, region=None) -> torch.Tensor:
    """Region ``region`` (per dim ``(start, stop)``, or ``None`` for the
    whole dim) of ``leaf``, assembled on position ``i``'s device from the
    blocks holding it: its own block's part as a view, the others copied
    from the first position holding each."""
    grid = leaf.grid()
    size = [s // n for s, n in zip(leaf.shape, grid)]
    region = [(0, s) if r is None else r
              for s, r in zip(leaf.shape, tuple(region or ()) + (None,) * leaf.ndim)]
    dev = leaf.blocks[i].device
    moved = 0

    def piece(bid):
        nonlocal moved
        j = leaf.holder(i, bid)
        x = leaf.blocks[j]
        for d, ((lo, hi), b) in enumerate(zip(region, bid)):
            start = max(lo, b * size[d])
            stop = min(hi, (b + 1) * size[d])
            if stop - start != x.shape[d]:
                x = x.narrow(d, start - b * size[d], stop - start)
        if j != i:
            moved += _nbytes(x)
        return x.to(dev)

    def assemble(d, bid):
        if d == leaf.ndim:
            return piece(bid)
        lo, hi = region[d]
        blocks = range(lo // size[d], (hi - 1) // size[d] + 1)
        parts = [assemble(d + 1, bid + (b,)) for b in blocks]
        return parts[0] if len(parts) == 1 else torch.cat(parts, d)

    out = assemble(0, ())
    # ``assemble`` refers to itself through its closure: a cycle that would
    # keep ``leaf``'s blocks alive until the next cyclic collection (GBs of
    # weights on the card after their last reference is dropped)
    del assemble
    if moved:
        record("gather", moved, i)
    return out


def gather_rows(leaf: Placed, i: int, index: torch.Tensor) -> torch.Tensor:
    """Rows ``index`` (any shape, on position ``i``'s device) of a 2-D
    leaf ``[R, C]``, ``index.shape + (C,)``, on position ``i``: each row
    block's holder looks up every index (clamped into its block) and the
    rows of the block they fall in are kept, in block order; column blocks
    are concatenated.  Counted: the looked-up rows of the blocks other
    positions hold."""
    n_r, n_c = leaf.grid()
    size_r = leaf.shape[0] // n_r
    dev = leaf.blocks[i].device
    moved = 0
    cols = []
    for c in range(n_c):
        out = None
        for r in range(n_r):
            j = leaf.holder(i, (r, c))
            blk = leaf.blocks[j]
            lo = r * size_r
            local = (index - lo).clamp(0, size_r - 1).to(blk.device)
            rows = blk[local].to(dev)
            if j != i:
                moved += _nbytes(rows)
            if out is None:
                out = rows
            else:
                inside = (index >= lo) & (index < lo + size_r)
                out = torch.where(inside[..., None], rows, out)
        cols.append(out)
    if moved:
        record("gather", moved, i)
    return cols[0] if n_c == 1 else torch.cat(cols, -1)


def mesh_sizes(mesh) -> tuple[int, int, int]:
    """(pod, data, model) sizes of ``mesh`` (1 for an absent axis)."""
    return tuple(mesh.shape.get(a, 1) for a in ("pod", "data", "model"))


def position_coords(mesh) -> list[tuple[int, int, int]]:
    """Each position's (pod, data, model) indices (0 for an absent axis)."""
    return [tuple(pos.get(a, 0) for a in ("pod", "data", "model")) for pos in mesh.positions()]


def shard_factor(sharding: NamedSharding) -> int:
    """The number of distinct blocks a sharding splits a tensor into."""
    return math.prod(sharding.mesh.shape[a] for entry in sharding.spec if entry is not None
                     for a in (entry if isinstance(entry, tuple) else (entry,)))


__all__ = [
    "KINDS", "Placed", "all_gather", "all_reduce", "axis_groups", "blocks_at", "device_get",
    "device_put", "gather", "gather_rows", "is_placed", "mesh_sizes", "place", "position_bytes",
    "position_coords", "record", "reduce_scatter", "reset_spmd_counts", "shard_factor",
    "spmd_counts",
]
