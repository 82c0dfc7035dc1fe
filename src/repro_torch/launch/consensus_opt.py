"""Sharded consensus over an agent mesh (port of ``repro.launch.consensus_opt``).

One process drives every shard (single controller, as the reference: its
``shard_map`` programs run all shards from one process).  A shard is an
entry of a ``launch.mesh.AgentMesh``, or an index of one axis of a
``launch.mesh.Mesh`` (its block on the device of the position with the
other axes at 0); shard s holds agents ``[s N/S, (s + 1) N/S)``.  The
state stays resident on its own device; each call moves the shards' blocks
to their devices (views where a shard's device is the state's) and its
results back.

* ``consensus_ppermute_window``: one gossip event window, sharded.  Each
  shard encodes its own rows into its ``[N, P]`` statistic buffers in the
  wire dtype (``kernels.consensus.consensus_shard_encode``); the window's
  edges give the set of fired cross-shard offsets (``window_shard_offsets``)
  and, per offset d, one rotation copies every shard's encoded block into
  the buffers of shard ``(s + d) mod S``; then each shard reduces its rows of
  W-tilde over its buffers (``kernels.consensus.consensus_fused_shard``).
  Rows of shards no rotation brought stay zero, and their W-tilde entries
  are zero.  Every active row is bitwise ``core.flat.consensus_flat_masked``'s
  at every wire dtype (the kernels on the card, the plain versions on the
  CPU).
* ``consensus_ppermute_ring_flat`` / ``consensus_ppermute_ring``: eq. (6) on
  a bidirectional ring of shards, each mixing itself with the blocks of
  shards ``s - 1`` and ``s + 1`` (plain PyTorch: the reference is XLA).
* ``consensus_ppermute_pod``: the same eq. (6) leaf by leaf over a pytree
  posterior on the LM mesh's ``pod`` axis, each leaf split into the blocks
  its sharding gives every mesh position (``launch.sharding.shard_blocks``);
  a position mixes its block with the wire-rounded blocks of the positions
  one pod before it (and one after, for more than two pods).  Its
  arithmetic is the ring's, term for term, so on the card it is bitwise
  ``consensus_ppermute_ring_flat`` on the same posterior flattened, for the
  same W and wire (on the CPU PyTorch's elementwise kernels take another
  path for a buffer's last lanes, so a leaf's tail may differ in the last
  bit).
* ``ring_blocks``: the one core of every ring form above and of their
  placed forms (``launch.spmd_steps.pod_ppermute``, on the blocks each
  mesh position holds): per holder the statistics, the rotations from its
  neighbours, and the mix, so a placed ring is bitwise its unplaced form.
* ``consensus_einsum`` / ``consensus_einsum_flat``: dense eq. (6) with the
  exchanged statistics and W rounded to the wire dtype and accumulated in
  float32 (plain PyTorch, the reference's einsum baseline).

The rotation primitive (``rotate``) is a ``Tensor.copy_`` of one shard's
wire-dtype block into another shard's buffer: a peer copy across cards, a
device-to-device copy on one card.  PyTorch orders a copy between two cards
on both cards' current streams with events (the copy waits for the encode
on the source's stream, and the reduce on the destination's stream waits
for the copy), so nothing here synchronises.  At bf16 and f16 a rotation
moves half the bytes of f32: ``rotation_counts()["bytes"]`` over a window
equals ``launch.costmodel.gossip_window_roofline(...)["ici_bytes"]
["window_ppermute"]``.

The reference blocks its contraction over columns (``_MAX_UNROLL``,
``XLA_BLOCK``) for XLA's bit identity; the port's eq. (6) is per lane, so
nothing here is blocked.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.flat import FlatPosterior
from repro_torch.core.numerics import canonical_wire_dtype, softplus, softplus_inv, wire_cast_pair
from repro_torch.core.posterior import GaussianPosterior
from repro_torch.core.tree import tree_at, tree_flatten_with_path, tree_replace_leaves
from repro_torch.kernels.consensus import consensus_fused_shard, consensus_shard_encode
from repro_torch.launch.mesh import AGENTS, AgentMesh
from repro_torch.launch.sharding import NamedSharding, join_blocks, shard_blocks

_moved = {"rotations": 0, "copies": 0, "bytes": 0}


def rotation_counts() -> dict[str, int]:
    """Rotations (one per fired offset of a window, one per direction of a
    ring's ``ring_blocks`` call), block copies and bytes copied since the
    last ``reset_rotation_counts``."""
    return dict(_moved)


def reset_rotation_counts() -> None:
    for k in _moved:
        _moved[k] = 0


def rotate(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy one shard's block into another shard's buffer (any devices)."""
    dst.copy_(src)
    _moved["copies"] += 1
    _moved["bytes"] += src.numel() * src.element_size()


def _shards(mesh: AgentMesh, axis: str, n: int) -> tuple[int, int]:
    """(shards, agents a shard) of ``n`` agents over ``mesh``'s ``axis``."""
    if isinstance(mesh, AgentMesh) and axis != mesh.axis:
        raise ValueError(f"mesh axis {mesh.axis!r}, asked for {axis!r}")
    if axis not in mesh.shape:
        raise ValueError(f"mesh axes {tuple(mesh.shape)}, asked for {axis!r}")
    n_shards = mesh.shape[axis]
    if n % n_shards:
        raise ValueError(
            f"agent axis ({n}) must divide evenly over the {n_shards}-shard mesh axis {axis!r}"
        )
    return n_shards, n // n_shards


def _axis_devices(mesh, axis: str, default) -> list:
    """The device of each shard of ``axis``: an ``AgentMesh``'s entries, or
    a ``Mesh``'s positions with the other axes at 0 (``default`` when it is
    abstract)."""
    if isinstance(mesh, AgentMesh):
        return list(mesh.devices)
    return [mesh.device_at({axis: i}, default) for i in range(mesh.shape[axis])]


# ---------------------------------------------------------------------------
# sharded gossip event windows
# ---------------------------------------------------------------------------


def window_shard_offsets(window, n_shards: int) -> tuple[int, ...]:
    """The static rotation schedule of one event window: the sorted set of
    nonzero shard offsets ``(dst_shard - src_shard) mod n_shards`` its fired
    edges cross (agent a lives on shard ``a // (N // n_shards)``).  One
    rotation per offset moves every cross-shard message of that offset;
    intra-shard edges need none, and an idle window none at all."""
    per = window.n_agents // n_shards
    ev = window.edges[: window.n_events]
    return tuple(sorted(
        {(int(d) // per - int(s) // per) % n_shards for d, s in ev} - {0}
    ))


def _float32(w, device) -> torch.Tensor:
    """A W (host float64, or a tensor) as float32 on ``device``."""
    return torch.as_tensor(np.asarray(w) if not isinstance(w, torch.Tensor) else w).to(
        device=device, dtype=torch.float32)


def consensus_ppermute_window(posts: FlatPosterior, window, mesh: AgentMesh, axis: str = AGENTS,
                              *, wire_dtype=None, w_eff=None, active=None) -> FlatPosterior:
    """Execute one gossip event window sharded over ``mesh``'s agent axis.

    N must divide evenly over the shards.  Per fired cross-shard offset
    (``window_shard_offsets``) one rotation of every shard's wire-dtype
    (prec, prec*mu) block; then each shard reduces its own rows of W-tilde.
    Bitwise ``core.flat.consensus_flat_masked`` on the same window and
    ``wire_dtype`` where every payload is finite (a non-finite payload of a
    shard no rotation brought reaches no row here).  Instant delivery only:
    delayed windows (``window.max_lag > 0``) run the history path.

    ``w_eff``/``active`` replace the window's W-tilde and activity mask
    without changing its rotation schedule: the quarantine guard's hook,
    which only removes weight from scheduled edges."""
    n = window.n_agents
    n_shards, per = _shards(mesh, axis, n)
    if window.max_lag > 0:
        raise ValueError(
            "consensus_ppermute_window implements instant delivery; delayed windows "
            "(max_lag > 0) run the history path (core.flat.consensus_flat_delayed)"
        )
    if posts.mean.shape[0] != n:
        raise ValueError(f"posterior of {posts.mean.shape[0]} agents, window of {n}")
    p = posts.mean.shape[1]
    wd = canonical_wire_dtype(wire_dtype)
    offsets = window_shard_offsets(window, n_shards)
    home = posts.mean.device
    W = _float32(window.w_eff if w_eff is None else w_eff, home)
    act = torch.as_tensor(np.asarray(window.active) if active is None else active, device=home)
    blocks = [slice(s * per, (s + 1) * per) for s in range(n_shards)]
    # each shard's [2, N, P] statistic planes; rows of shards no rotation
    # brings stay zero (every row is written when every offset fired)
    alloc = torch.empty if len(offsets) == n_shards - 1 else torch.zeros
    shards = []
    for s, dev in enumerate(mesh.devices):
        mean_s, rho_s = posts.mean[blocks[s]].to(dev), posts.rho[blocks[s]].to(dev)
        stats = alloc((2, n, p), dtype=wd, device=mean_s.device)
        consensus_shard_encode(mean_s, rho_s, stats[0], stats[1], row0=s * per)
        shards.append((mean_s, rho_s, stats))
    for d in offsets:
        _moved["rotations"] += 1
        for s in range(n_shards):
            src, dst = shards[s][2], shards[(s + d) % n_shards][2]
            for plane in range(2):
                rotate(src[plane, blocks[s]], dst[plane, blocks[s]])
    mean_out, rho_out = torch.empty_like(posts.mean), torch.empty_like(posts.rho)
    for s, (mean_s, rho_s, stats) in enumerate(shards):
        dev = mean_s.device
        here = dev == home
        out = (mean_out[blocks[s]], rho_out[blocks[s]]) if here else None
        got = consensus_fused_shard(W[blocks[s]].to(dev), act[blocks[s]].to(dev), stats[0],
                                    stats[1], mean_s, rho_s, row0=s * per, out=out)
        if not here:
            mean_out[blocks[s]].copy_(got[0])
            rho_out[blocks[s]].copy_(got[1])
    return dataclasses.replace(posts, mean=mean_out, rho=rho_out)


# ---------------------------------------------------------------------------
# ring and einsum forms
# ---------------------------------------------------------------------------


def ring_weights(n: int, self_weight: float = 1.0 / 3.0) -> tuple[float, float, float]:
    side = (1.0 - self_weight) / 2.0
    return self_weight, side, side


def _stats(m, r, wd):
    """A block's precision and its wire-dtype (prec, prec*mu) pair."""
    prec = 1.0 / torch.square(softplus(r))
    return prec, wire_cast_pair(prec, prec * m, wd)


def _receive(pair, device) -> list:
    """Rotate a wire pair onto ``device`` and decode it to float32."""
    out = []
    for x in pair:
        buf = torch.empty_like(x, device=device)
        rotate(x, buf)
        out.append(buf.to(torch.float32))
    return out


def _row_weights(W, i: int, n: int, device):
    """Row i's (self, prev, next) of ``W`` as 0-d float32 tensors; next is
    0 for two shards (both directions are one neighbour)."""
    w = _float32(W, device)
    nxt = w[i, (i + 1) % n] if n > 2 else torch.zeros((), device=device)
    return w[i, i], w[i, (i - 1) % n], nxt


def _mix(m, prec, prev, nxt, weights):
    """Eq. (6) of one block from its own precision and the decoded (prec,
    prec*mu) of its two neighbours, in the reference's order of terms."""
    (prev_p, prev_pm), (next_p, next_pm) = prev, nxt
    w_self, w_prev, w_next = weights
    new_prec = w_self * prec + w_prev * prev_p + w_next * next_p
    new_pm = w_self * (prec * m) + w_prev * prev_pm + w_next * next_pm
    return new_pm / new_prec, softplus_inv(torch.sqrt(1.0 / new_prec))


def ring_blocks(blocks: list, index, peer, n: int, wd, weights, both_ways: bool) -> list:
    """Eq. (6) on a ring of ``n``, one block a holder: ``blocks[k]`` holder
    k's (mean, rho) block on its device, ``index(k)`` its place on the ring,
    ``peer(k, d)`` the holder ``d`` steps along the ring from it,
    ``weights(i, device)`` the (self, prev, next) of ring place ``i``.  A
    holder mixes its block with the decoded wire pair of the holder before
    it and, for more than two places or ``both_ways``, of the one after (a
    missing one mixes as zeros).  Each direction is one rotation, every
    holder's pair copied by ``rotate``.  Returns each holder's (mean',
    rho').  Every form of the ring (flat and leaf-wise, placed or not)
    computes here, so they agree term for term."""
    local = [(m, *_stats(m, r, wd)) for m, r in blocks]
    shifts = (-1, 1) if n > 2 or both_ways else (-1,)
    _moved["rotations"] += len(shifts)
    out = []
    for k, (m, prec, _) in enumerate(local):
        zero = torch.zeros((), device=m.device)
        recv = {d: _receive(local[peer(k, d)][2], m.device) for d in shifts}
        out.append(_mix(m, prec, recv[-1], recv.get(1, (zero, zero)),
                        weights(index(k), m.device)))
    return out


def axis_peers(mesh, axis: str):
    """(index, peer) of ``ring_blocks`` for the positions of ``mesh``
    (row-major) around its ``axis``."""
    positions = list(mesh.positions())
    where = {tuple(sorted(pos.items())): k for k, pos in enumerate(positions)}
    n = mesh.shape[axis]

    def peer(k, d):
        pos = positions[k]
        return where[tuple(sorted({**pos, axis: (pos[axis] + d) % n}.items()))]

    return (lambda k: positions[k][axis]), peer


def row_weights(W, n: int):
    """``ring_blocks``' weights from an ``[n, n]`` W's rows."""
    return lambda i, dev: _row_weights(W, i, n, dev)


def _ring_eq6(mean, rho, mesh, axis, wd, weights):
    """Eq. (6) of ``[N, F]`` buffers on a bidirectional ring of shards:
    shard i mixes its block with the wire-dtype blocks of shards i - 1 and
    i + 1, rotated to it; ``weights(i)`` gives its (self, prev, next)."""
    n_shards, per = _shards(mesh, axis, mean.shape[0])
    blocks = [(mean[s * per:(s + 1) * per].to(dev), rho[s * per:(s + 1) * per].to(dev))
              for s, dev in enumerate(_axis_devices(mesh, axis, mean.device))]
    out = ring_blocks(blocks, lambda k: k, lambda k, d: (k + d) % n_shards, n_shards, wd,
                      weights, both_ways=True)
    return (torch.cat([m.to(mean.device) for m, _ in out]),
            torch.cat([r.to(rho.device) for _, r in out]))


def consensus_ppermute_ring_flat(posts: FlatPosterior, mesh: AgentMesh, axis: str = AGENTS,
                                 self_weight: float = 1.0 / 3.0, wire_dtype=torch.float32,
                                 W=None) -> FlatPosterior:
    """Bidirectional-ring eq. (6) on the flat buffers, one block per shard.
    ``W=None`` uses the uniform ring weights from ``self_weight``; an
    ``[S, S]`` ring ``W`` gives shard i its (self, prev, next) weights from
    row i (non-ring entries ignored; for 2 shards the two directions are
    one neighbour and only the forward one mixes)."""
    wd = canonical_wire_dtype(wire_dtype)
    n = mesh.shape[axis]
    if W is None:
        static = ring_weights(n, self_weight)

        def weights(i, dev):
            return static
    else:
        weights = row_weights(W, n)
    mean, rho = _ring_eq6(posts.mean, posts.rho, mesh, axis, wd, weights)
    return dataclasses.replace(posts, mean=mean, rho=rho)


def consensus_ppermute_pod(posts: GaussianPosterior, W, mesh, shardings,
                           wire_dtype=torch.bfloat16, axis: str = "pod") -> GaussianPosterior:
    """Eq. (6) over the pod axis, leaf by leaf, with explicit neighbour
    exchange of ONLY the sufficient statistics (prec, prec*mu) in
    ``wire_dtype``.

    ``posts``: every leaf leads with the agent axis (one agent a pod);
    ``shardings``: a ``GaussianPosterior``-shaped tree whose ``mean`` holds
    a ``NamedSharding`` (or a bare ``PartitionSpec``) for each leaf, e.g.
    ``launch.sharding.param_shardings(state, mesh, agent_leading=True)
    .posterior``.  Each leaf is split into the block every position of
    ``mesh`` holds (on its device); a position mixes its block with the
    decoded wire blocks of the position one pod before it, and of the one
    after when there are more than two pods (for two both directions are
    one neighbour, mixed once), weights from W's row of its pod
    (``W[i, i]``, ``W[i, i - 1]``, ``W[i, i + 1]``; other entries are
    ignored, as in the ring).  Each direction is one rotation a leaf, a
    ``rotate`` copy of every position's block, counted in
    ``rotation_counts()``."""
    wd = canonical_wire_dtype(wire_dtype)
    n = mesh.shape[axis]
    index, peer = axis_peers(mesh, axis)
    means, rhos = [], []
    for path, m in tree_flatten_with_path(posts.mean):
        r, s = tree_at(posts.rho, path), tree_at(shardings.mean, path)
        sh = s if isinstance(s, NamedSharding) else NamedSharding(mesh, s)
        out = ring_blocks(list(zip(shard_blocks(m, sh), shard_blocks(r, sh))), index, peer, n,
                          wd, row_weights(W, n), both_ways=False)
        means.append(join_blocks([x for x, _ in out], sh, device=m.device))
        rhos.append(join_blocks([x for _, x in out], sh, device=r.device))
    return GaussianPosterior(mean=tree_replace_leaves(posts.mean, means),
                             rho=tree_replace_leaves(posts.rho, rhos))


def consensus_ppermute_ring(posts: GaussianPosterior, mesh: AgentMesh, axis: str = AGENTS,
                            self_weight: float = 1.0 / 3.0,
                            wire_dtype=torch.float32) -> GaussianPosterior:
    """Eq. (6) on a bidirectional ring over a parameter dict whose leaves
    carry a leading agent dim of ``mesh.shape[axis]``: per leaf, the ring
    form of ``consensus_ppermute_ring_flat`` at the uniform weights."""
    wd = canonical_wire_dtype(wire_dtype)
    static = ring_weights(mesh.shape[axis], self_weight)

    def leaf(m, r):
        mo, ro = _ring_eq6(m.reshape(m.shape[0], -1), r.reshape(r.shape[0], -1), mesh, axis, wd,
                           lambda i, dev: static)
        return mo.reshape(m.shape), ro.reshape(r.shape)

    return _per_leaf(posts, leaf)


def _per_leaf(posts: GaussianPosterior, fn) -> GaussianPosterior:
    """``fn(mean_leaf, rho_leaf) -> (mean, rho)`` over the posterior's dict."""

    def walk(m, r):
        if isinstance(m, dict):
            return {k: walk(m[k], r[k]) for k in m}
        return fn(m, r)

    out = walk(posts.mean, posts.rho)

    def pick(node, i):
        return {k: pick(v, i) for k, v in node.items()} if isinstance(node, dict) else node[i]

    return GaussianPosterior(mean=pick(out, 0), rho=pick(out, 1))


def _einsum_eq6(W, mean, rho, wd):
    """``[N, ...]`` eq. (6) with the statistics and W in the wire dtype,
    products accumulated in float32 (a product of two wire values is exact
    in float32)."""
    shape = mean.shape
    prec = 1.0 / torch.square(softplus(rho))
    prec_w, pm = wire_cast_pair(prec, prec * mean, wd)
    w = _float32(W, mean.device).to(wd).to(torch.float32)
    new_prec = torch.matmul(w, prec_w.reshape(shape[0], -1).to(torch.float32))
    new_pm = torch.matmul(w, pm.reshape(shape[0], -1).to(torch.float32))
    return ((new_pm / new_prec).reshape(shape),
            softplus_inv(torch.sqrt(1.0 / new_prec)).reshape(shape))


def consensus_einsum(posts: GaussianPosterior, W, wire_dtype=torch.float32) -> GaussianPosterior:
    """Dense eq. (6) over a parameter dict with wire-dtype compression of
    the exchanged (prec, prec*mean) and of W, accumulated in float32."""
    wd = canonical_wire_dtype(wire_dtype)
    return _per_leaf(posts, lambda m, r: _einsum_eq6(W, m, r, wd))


def consensus_einsum_flat(posts: FlatPosterior, W, wire_dtype=torch.float32) -> FlatPosterior:
    """Dense eq. (6) on the flat [N, P] buffers in one contraction pair."""
    mean, rho = _einsum_eq6(W, posts.mean, posts.rho, canonical_wire_dtype(wire_dtype))
    return dataclasses.replace(posts, mean=mean, rho=rho)


__all__ = [
    "axis_peers", "consensus_einsum", "consensus_einsum_flat", "consensus_ppermute_pod",
    "consensus_ppermute_ring", "consensus_ppermute_ring_flat", "consensus_ppermute_window",
    "reset_rotation_counts", "ring_blocks", "ring_weights", "rotate", "rotation_counts",
    "row_weights", "window_shard_offsets",
]
