"""Flat-buffer posterior representation — the canonical runtime format (port
of the synchronous-round and gossip-window subset of ``repro.core.flat``).

A ``FlatPosterior`` stores the whole network's mean-field Gaussian posterior
as two contiguous fp32 buffers, ``mean`` and ``rho``, both ``[N_agents, P]``,
plus a ``FlatLayout`` that records, per model-parameter leaf, its key path,
shape, dtype and (offset, size) column span.  Parameter dicts appear only at
the model-apply boundary (``make_flat_nll``).

Leaf order: the JAX package orders leaves as ``jax.tree_util`` flattens a
pytree, which for a dict is SORTED key order (``b1, b2, b3, w1, w2, w3`` for
the MLP), not insertion order.  ``FlatLayout.for_pytree`` here walks dicts in
sorted key order too, so both packages give every leaf the same column span
and weights carried across land in the right columns.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

import numpy as np

from repro_torch.core import graphs
from repro_torch.core.numerics import COMPUTE_DTYPE, softplus, softplus_inv_py
from repro_torch.core.posterior import leaves_with_keys, set_path
from repro_torch.kernels.consensus import (
    consensus_fused_masked,
    consensus_fused_masked_sparse,
    consensus_fused_network,
    consensus_fused_segments,
    consensus_fused_sparse,
    consensus_masked_plain,
    consensus_network_plain,
    csr_tables,
    payload_validity_fused,
)
from repro_torch.kernels.launch_plan import ragged_terms

PyTree = Any  # a (possibly nested) dict of tensors

# An exchanged |prec| or |prec*mu| lane above this is garbage regardless of
# finiteness: a prec of 1e20 is a sigma of 1e-10.
QUARANTINE_BOUND = 1e20


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One model-parameter leaf's slot in the flat buffer."""

    path: str  # key-path string, as jax.tree_util.keystr writes it
    shape: tuple[int, ...]  # per-agent shape (leading agent axes stripped)
    dtype: str  # dtype name of the original leaf
    offset: int  # start column in the flat buffer
    size: int  # number of scalars = prod(shape)


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Leaf layout: offsets/shapes/dtypes plus each leaf's dict keys."""

    specs: tuple[LeafSpec, ...]
    keys: tuple[tuple[str, ...], ...]  # dict-key path of each leaf
    n_params: int  # P: total scalars per agent

    @classmethod
    def for_pytree(cls, tree: PyTree, leading_axes: int = 0) -> "FlatLayout":
        """Build the layout from an example parameter dict; ``leading_axes``
        axes are stripped off every leaf shape (1 for a network-stacked
        tree whose leaves are [N, ...])."""
        specs, keys, off = [], [], 0
        for leaf_keys, leaf in leaves_with_keys(tree):
            shape = tuple(int(s) for s in leaf.shape[leading_axes:])
            size = math.prod(shape)
            specs.append(LeafSpec(
                path="".join(f"[{k!r}]" for k in leaf_keys), shape=shape,
                dtype=str(leaf.dtype).removeprefix("torch."), offset=off, size=size,
            ))
            keys.append(leaf_keys)
            off += size
        return cls(specs=tuple(specs), keys=tuple(keys), n_params=off)

    def flatten(self, tree: PyTree) -> torch.Tensor:
        """Dict with leaves [*B, *spec.shape] -> fp32 buffer [*B, P]."""
        leaves = [leaf for _, leaf in leaves_with_keys(tree)]
        if len(leaves) != len(self.specs):
            raise ValueError(f"tree has {len(leaves)} leaves, layout {len(self.specs)}")
        flat, batch = [], None
        for spec, leaf in zip(self.specs, leaves):
            nb = leaf.ndim - len(spec.shape)
            b = tuple(leaf.shape[:nb])
            if tuple(leaf.shape[nb:]) != spec.shape or batch not in (None, b):
                raise ValueError(
                    f"leaf {spec.path}: shape {tuple(leaf.shape)} does not match "
                    f"layout {spec.shape} (batch {batch})"
                )
            batch = b
            flat.append(leaf.reshape(b + (spec.size,)).to(COMPUTE_DTYPE))
        return torch.cat(flat, dim=-1)

    def unflatten(self, flat: torch.Tensor) -> PyTree:
        """fp32 buffer [*B, P] -> dict with leaves [*B, *shape]: views of
        ``flat`` for fp32 leaves (so autograd flows through them)."""
        if flat.shape[-1] != self.n_params:
            raise ValueError(
                f"buffer has {flat.shape[-1]} params, layout expects {self.n_params}"
            )
        b = tuple(flat.shape[:-1])
        tree: dict = {}
        for spec, keys in zip(self.specs, self.keys):
            leaf = flat[..., spec.offset:spec.offset + spec.size].reshape(b + spec.shape)
            set_path(tree, keys, leaf.to(getattr(torch, spec.dtype)))
        return tree

    # -- checkpoint doc ------------------------------------------------------

    def to_doc(self) -> dict:
        """Self-describing msgpack-able doc, equal to the JAX package's for
        the same layout: the skeleton is the parameter dict with each leaf
        replaced by its index (keys inserted in sorted order, as
        ``jax.tree.unflatten`` builds a dict)."""
        skeleton: dict = {}
        for i, keys in enumerate(self.keys):
            set_path(skeleton, keys, i)
        return {
            "n_params": self.n_params,
            "specs": [dataclasses.asdict(s) | {"shape": list(s.shape)} for s in self.specs],
            "skeleton": _encode_skeleton(skeleton),
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "FlatLayout":
        skeleton = _decode_skeleton(doc["skeleton"])
        keys: dict[int, tuple[str, ...]] = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k], path + (k,))
            elif isinstance(node, int):
                keys[node] = path
            else:
                raise TypeError(
                    f"a {type(node).__name__} node in a layout skeleton: the port's "
                    "flat layouts are over parameter dicts"
                )

        walk(skeleton, ())
        specs = tuple(
            LeafSpec(path=s["path"], shape=tuple(s["shape"]), dtype=s["dtype"],
                     offset=s["offset"], size=s["size"])
            for s in doc["specs"]
        )
        return cls(specs=specs, keys=tuple(keys[i] for i in range(len(specs))),
                   n_params=doc["n_params"])


def _encode_skeleton(node):
    """Encode a dict/list/tuple/int skeleton as msgpack-able JSON-ish data
    (tuples tagged so they survive the round trip)."""
    if isinstance(node, dict):
        if not all(isinstance(k, str) for k in node):
            raise TypeError("FlatLayout checkpoint docs require str dict keys")
        return {k: _encode_skeleton(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return {"__tuple__": [_encode_skeleton(v) for v in node]}
    if isinstance(node, list):
        return [_encode_skeleton(v) for v in node]
    if isinstance(node, int):
        return node
    raise TypeError(
        f"pytree node {type(node)} not supported in a self-describing flat "
        "checkpoint; restore with an explicit `like` tree instead"
    )


def _decode_skeleton(node):
    if isinstance(node, dict):
        if set(node) == {"__tuple__"}:
            return tuple(_decode_skeleton(v) for v in node["__tuple__"])
        return {k: _decode_skeleton(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode_skeleton(v) for v in node]
    return node


@dataclasses.dataclass
class FlatPosterior:
    """Mean-field Gaussian posterior over flat buffers [*B, P]."""

    mean: torch.Tensor
    rho: torch.Tensor
    layout: FlatLayout

    def sigma(self) -> torch.Tensor:
        return softplus(self.rho)

    def precision(self) -> torch.Tensor:
        return 1.0 / torch.square(softplus(self.rho))

    def sample(self, eps: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Reparameterized sample theta = mu + sigma * eps, a FLAT [*B, P]
        tensor.  ``eps`` is the injected standard-normal noise; without it
        the noise is drawn from ``generator``."""
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator,
                              dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + softplus(self.rho) * eps

    def n_params(self) -> int:
        return self.layout.n_params


def flat_posterior_from_pytree(post, layout: FlatLayout | None = None,
                               leading_axes: int = 1) -> FlatPosterior:
    """``GaussianPosterior`` (dict leaves [*B, ...]) -> ``FlatPosterior``."""
    if layout is None:
        layout = FlatLayout.for_pytree(post.mean, leading_axes=leading_axes)
    return FlatPosterior(
        mean=layout.flatten(post.mean), rho=layout.flatten(post.rho), layout=layout
    )


def init_flat_posterior(params: PyTree, init_sigma: float = 0.05,
                        layout: FlatLayout | None = None,
                        leading_axes: int = 0) -> FlatPosterior:
    """mean = flatten(params), constant rho = softplus^-1(init_sigma)."""
    if layout is None:
        layout = FlatLayout.for_pytree(params, leading_axes=leading_axes)
    mean = layout.flatten(params)
    rho = torch.full_like(mean, softplus_inv_py(init_sigma))
    return FlatPosterior(mean=mean, rho=rho, layout=layout)


def make_flat_nll(nll_fn: Callable[[PyTree, Any], torch.Tensor], layout: FlatLayout):
    """Wrap a dict-parameter nll into one taking a flat theta [*B, P] — the
    single model-apply-boundary conversion of the flat runtime."""

    def flat_nll(theta_flat: torch.Tensor, batch: Any) -> torch.Tensor:
        return nll_fn(layout.unflatten(theta_flat), batch)

    return flat_nll


# ---------------------------------------------------------------------------
# Network-wide consensus over the flat buffers
# ---------------------------------------------------------------------------


def consensus_flat_reference(mean, rho, W, wire_dtype=None):
    """Eq. (6) on the flat [N, P] buffers in plain PyTorch, on any device —
    the reference semantics of the consensus kernel."""
    return consensus_network_plain(W, mean, rho, wire_dtype)


def consensus_flat(posts: FlatPosterior, W: torch.Tensor, *, wire_dtype=None) -> FlatPosterior:
    """Eq. (6) over the whole network: the CUDA kernel for posteriors on the
    card, its plain version for posteriors on the CPU.  ``W`` is cast to
    float32 on the posterior's device.  ``wire_dtype`` rounds the exchanged
    (prec, prec*mu) at the exchange boundary; f32/None is uncompressed."""
    W = W.to(device=posts.mean.device, dtype=torch.float32)
    mean, rho = consensus_fused_network(W, posts.mean, posts.rho, wire_dtype=wire_dtype)
    return FlatPosterior(mean=mean, rho=rho, layout=posts.layout)


def payload_validity(mean, rho, *, wire_dtype=None, bound: float = QUARANTINE_BOUND):
    """[N] bool: is each agent's exchanged (prec, prec*mu) payload sane?

    The check runs on the wire representation a receiver sees: every lane
    finite, ``prec`` strictly positive and both magnitudes within ``bound``.
    The CUDA kernel for tensors on the card, its plain version on the CPU."""
    return payload_validity_fused(mean, rho, bound=bound, wire_dtype=wire_dtype)


# ---------------------------------------------------------------------------
# Gossip event windows: masked and CSR-table consensus
# ---------------------------------------------------------------------------


def consensus_flat_masked_reference(mean, rho, W, active, wire_dtype=None):
    """Masked (event-window) eq. (6) in plain PyTorch, on any device: active
    agents get the computed row, inactive ones their original (mean, rho)
    row.  With ``active`` all-true it is bitwise the unmasked reference."""
    return consensus_masked_plain(W, active, mean, rho, wire_dtype)


def consensus_flat_masked(posts: FlatPosterior, W, active, *, wire_dtype=None) -> FlatPosterior:
    """Masked network-wide consensus for one gossip event window: ``W`` is
    the window's W-tilde (cast to float32 on the posterior's device) and
    ``active`` its [N] mask.  Active agents merge per eq. (6); inactive ones
    pass through bit-identically.  The CUDA kernel on the card, its plain
    version on the CPU."""
    dev = posts.mean.device
    W = torch.as_tensor(W).to(device=dev, dtype=torch.float32)
    mean, rho = consensus_fused_masked(W, torch.as_tensor(active, device=dev),
                                       posts.mean, posts.rho, wire_dtype=wire_dtype)
    return FlatPosterior(mean=mean, rho=rho, layout=posts.layout)


def neighbor_tables(W) -> tuple[np.ndarray, np.ndarray]:
    """CSR-style padded neighbour tables of a dense W for the sparse
    kernels: (neighbors [N, D] int32, weights [N, D] float32), D = max
    in-degree, ragged rows padded with the agent's own id at weight 0.0.
    Host-side; the one CSR construction of ``graphs.SparseGraph``."""
    return graphs.SparseGraph.from_dense(np.asarray(W)).neighbor_tables()


def consensus_flat_sparse(posts: FlatPosterior, neighbors, weights, *,
                          wire_dtype=None) -> FlatPosterior:
    """Sparse-neighbourhood eq. (6): each agent gathers only its deg(i)
    neighbour rows on the card (the CUDA kernel); the plain version on the
    CPU rebuilds the dense W."""
    mean, rho = consensus_fused_sparse(neighbors, weights, posts.mean, posts.rho,
                                       wire_dtype=wire_dtype)
    return FlatPosterior(mean=mean, rho=rho, layout=posts.layout)


def consensus_flat_masked_sparse(posts: FlatPosterior, neighbors, weights, active, *,
                                 wire_dtype=None) -> FlatPosterior:
    """Active-edge window consensus on CSR tables of the window's W-tilde
    (``neighbor_tables(window.w_eff)``): active agents gather only their
    fired-neighbour rows, inactive agents copy their own row."""
    mean, rho = consensus_fused_masked_sparse(
        neighbors, weights, torch.as_tensor(active, device=posts.mean.device),
        posts.mean, posts.rho, wire_dtype=wire_dtype,
    )
    return FlatPosterior(mean=mean, rho=rho, layout=posts.layout)


# ---------------------------------------------------------------------------
# Quarantine guard: fault-tolerant consensus
# ---------------------------------------------------------------------------


def quarantine_w(W: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Zero every column of an invalid source and move the dropped row mass
    onto self, so rows stay row-stochastic.  The self column survives even
    for an invalid agent.  With ``valid`` all-true the result is
    value-identical to ``W``."""
    n = W.shape[0]
    keep = valid[None, :] | torch.eye(n, dtype=torch.bool, device=W.device)
    Wk = torch.where(keep, W, 0.0)
    dropped = torch.sum(W - Wk, dim=1)
    Wk.diagonal().add_(dropped)  # Wk is a fresh tensor
    return Wk


def _sanitized_sources(posts, mean_src, rho_src, valid_src, valid_self):
    """Exchange-side (mean, rho) with every invalid payload replaced by a
    finite placeholder.  Zeroing an invalid source's W column is not enough:
    ``0 * NaN = NaN`` still poisons the sum, so the rows behind zeroed
    weights must be finite too.  A corrupted-but-healthy sender falls back
    to its true resident statistics; an agent whose resident state is itself
    garbage gets a neutral (0, rho=1) row that only multiplies zero weight."""
    v_src = valid_src[:, None]
    v_self = valid_self[:, None]
    safe_mean = torch.where(v_self, posts.mean, 0.0)
    safe_rho = torch.where(v_self, posts.rho, 1.0)
    return torch.where(v_src, mean_src, safe_mean), torch.where(v_src, rho_src, safe_rho)


def _guard(posts, mean_src, rho_src, wire_dtype, bound):
    """(valid_src, valid_self, sanitized exchange posterior) of a window."""
    mean_src = posts.mean if mean_src is None else mean_src
    rho_src = posts.rho if rho_src is None else rho_src
    valid_src = payload_validity(mean_src, rho_src, wire_dtype=wire_dtype, bound=bound)
    valid_self = payload_validity(posts.mean, posts.rho, wire_dtype=wire_dtype, bound=bound)
    mean_x, rho_x = _sanitized_sources(posts, mean_src, rho_src, valid_src, valid_self)
    return valid_src, valid_self, FlatPosterior(mean=mean_x, rho=rho_x, layout=posts.layout)


def _keep_resident(posts, out, valid_self) -> FlatPosterior:
    v_self = valid_self[:, None]
    return FlatPosterior(mean=torch.where(v_self, out.mean, posts.mean),
                         rho=torch.where(v_self, out.rho, posts.rho), layout=posts.layout)


def consensus_flat_masked_quarantined(posts: FlatPosterior, W, active, *, mean_src=None,
                                      rho_src=None, wire_dtype=None,
                                      bound: float = QUARANTINE_BOUND):
    """Quarantine-guarded ``consensus_flat_masked``: validate every incoming
    contribution at the exchange boundary, drop invalid ones, move their row
    mass to self.  Returns ``(posterior, valid_src [N] bool)``.

    ``mean_src``/``rho_src`` are the statistics agents actually transmit
    (default: the resident ``posts``), the fault-injection hook.  A
    corrupted sender still merges; an agent whose resident state is invalid
    passes through unchanged.  With zero faults every step is a
    value-identity, so the output is bitwise the unguarded path's."""
    valid_src, valid_self, posts_x = _guard(posts, mean_src, rho_src, wire_dtype, bound)
    dev = posts.mean.device
    W_g = quarantine_w(torch.as_tensor(W).to(device=dev, dtype=COMPUTE_DTYPE), valid_src)
    act_g = (torch.as_tensor(active, device=dev) > 0) & valid_self
    out = consensus_flat_masked(posts_x, W_g, act_g, wire_dtype=wire_dtype)
    return _keep_resident(posts, out, valid_self), valid_src


def consensus_flat_masked_sparse_quarantined(posts: FlatPosterior, neighbors, weights,
                                             active, *, mean_src=None, rho_src=None,
                                             wire_dtype=None,
                                             bound: float = QUARANTINE_BOUND):
    """Quarantine-guarded ``consensus_flat_masked_sparse``, the CSR form of
    the dense guard.  The table structure stays (gathering a sanitized
    zero-weight row is harmless); invalid non-self slots drop to 0.0 and each
    row's dropped mass lands on its real self slot (nonzero weight; pad slots
    are self at 0.0 and receive nothing).  Zero faults is a value-identity."""
    valid_src, valid_self, posts_x = _guard(posts, mean_src, rho_src, wire_dtype, bound)
    dev = posts.mean.device
    n = posts.mean.shape[0]
    nbr, wts = csr_tables("consensus_flat_masked_sparse_quarantined", neighbors, weights, n,
                          dev)
    nbr = nbr.long()
    rows = torch.arange(n, device=dev)
    self_mask = nbr == rows[:, None]
    wts_g = torch.where(valid_src[nbr] | self_mask, wts, 0.0)
    dropped = torch.sum(wts - wts_g, dim=1)
    self_slot = torch.argmax((self_mask & (wts > 0.0)).to(torch.int32), dim=1)
    wts_g[rows, self_slot] = wts_g[rows, self_slot] + dropped
    act_g = (torch.as_tensor(active, device=dev) > 0) & valid_self
    out = consensus_flat_masked_sparse(posts_x, nbr, wts_g, act_g, wire_dtype=wire_dtype)
    return _keep_resident(posts, out, valid_self), valid_src


# ---------------------------------------------------------------------------
# Delayed delivery and edge-native windows: eq. (6) over ragged term lists
# ---------------------------------------------------------------------------
#
# The reference scatters these with XLA (``.at[dst].add``).  Here each window
# becomes a destination-sorted term list on the host (``launch_plan.
# ragged_terms``: the reference's summation order per row, no [E, P] gather)
# and one ``consensus_fused_segments`` call sums it, in a fixed order on the
# card.  The quarantine guard's validity is read back to the host, where the
# dropped mass is summed in event order (``np.add.at`` in float32): no float
# scatter-add runs on the card.  A dropped contribution is left out of the
# list; the reference adds it as an exact 0.


def _host(x, dtype=None) -> np.ndarray:
    """A host numpy copy of an array-like or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)


def _diag(W) -> np.ndarray:
    """[N] float32 diagonal of a dense W, cast as the reference casts W."""
    return np.ascontiguousarray(np.diagonal(_host(W)).astype(np.float32))


def _fill_rows(agents, fill_mean, fill_rho, p: int, device, dtype=None):
    """[C, P] float32 constant rows of the agents' (fill_mean, fill_rho),
    rounded through ``dtype`` first when the ring would hold them in it."""
    rows = []
    for fill in (fill_mean, fill_rho):
        v = torch.from_numpy(_host(fill, np.float32)[agents].copy()).to(device)
        if dtype is not None:
            v = v.to(dtype).to(torch.float32)
        rows.append(v[:, None].expand(len(agents), p).contiguous())
    return rows


def _ring_consensus(posts, self_w, active, dst, ring_row, ev_w, hist_mean, hist_rho, *,
                    fill=None, wire_dtype=None) -> FlatPosterior:
    """Eq. (6) of a delayed window: active row i sums ``self_w[i]`` times its
    own current row first, then its events in order, event e reading ring
    row ``ring_row[e]`` of the ``[K N, P]`` view, or, where ``ring_row[e]``
    is ``-1 - j``, row j of ``fill`` (two ``[C, P]`` float32 buffers).
    Inactive rows pass through."""
    n, p = posts.mean.shape
    k = hist_mean.shape[0]
    x_mean, x_rho = posts.mean, posts.rho
    if fill is not None:
        x_mean, x_rho = torch.cat([x_mean, fill[0]]), torch.cat([x_rho, fill[1]])
    n_x = x_mean.shape[0]
    ring_row = np.asarray(ring_row, np.int64)
    src = np.where(ring_row >= 0, n_x + ring_row, n - 1 - ring_row)
    ar = np.arange(n)
    terms = ragged_terms(n, np.concatenate([ar, dst]), np.concatenate([ar, src]),
                         np.concatenate([self_w, ev_w]), active)
    mean, rho = consensus_fused_segments(
        terms, x_mean, x_rho, hist_mean.reshape(k * n, p), hist_rho.reshape(k * n, p),
        wire_dtype=wire_dtype, wp_first=True)
    return FlatPosterior(mean=mean, rho=rho, layout=posts.layout)


def _events(edges, weights, lags, round_idx, k: int, n: int):
    """(dst, src, weight, ring row) of a window's [E] event list: event e
    reads ring slot ``(round - lag) mod K`` of its source."""
    edges = _host(edges, np.int64).reshape(-1, 2)
    lags = _host(lags, np.int64).reshape(-1)
    slot = (int(round_idx) - lags) % k
    return edges[:, 0], edges[:, 1], _host(weights, np.float32).reshape(-1), slot * n + edges[:, 1]


def consensus_flat_delayed(posts: FlatPosterior, W, active, edges, weights, lags, hist_mean,
                           hist_rho, round_idx, wire_dtype=None) -> FlatPosterior:
    """Delivery-latency eq. (6): one gossip window whose events merge stale
    source posteriors (``gossip.clocks.DelayedClock``).

    Event k = ``(dst, src) = edges[k]`` with weight ``weights[k]`` delivers
    src's posterior as of window ``round_idx - lags[k]``, row ``src`` of ring
    slot ``(round_idx - lags[k]) mod K`` of ``hist_mean``/``hist_rho``
    ([K, N, P], resident in float32, bf16 or f16, decoded to fp32 before any
    arithmetic; the engine writes the window's own slot before the call, so
    a lag-0 event reads the current posterior).  Each active row sums
    ``W[i, i] * (prec, prec * mean)`` of its current row first, then its
    events in window order; inactive rows pass through bitwise.  At f32 the
    terms are ``(w * prec) * mean``, else ``w * wire(prec * mean)``.  Pad
    events (``(0, 0)`` at weight 0) add ``0 *`` ring row 0, once, as the
    reference's pads do (a non-finite row 0 makes agent 0's merge NaN)."""
    n = posts.mean.shape[0]
    dst, _, w, ring = _events(edges, weights, lags, round_idx, hist_mean.shape[0], n)
    return _ring_consensus(posts, _diag(W), _host(active) > 0, dst, ring, w, hist_mean,
                           hist_rho, wire_dtype=wire_dtype)


def consensus_flat_delayed_corrupted(posts: FlatPosterior, W, active, edges, weights, lags,
                                     hist_mean, hist_rho, round_idx, *, corrupt, fill_mean,
                                     fill_rho, wire_dtype=None) -> FlatPosterior:
    """``consensus_flat_delayed`` with the strict policy's sender-side
    corruption: every event from a ``corrupt`` source reads that agent's
    (fill_mean, fill_rho) as the ring would hold it (rounded through the
    ring's dtype), whatever its lag; the ring itself stays clean.  The
    reference (``repro/gossip/engine.py:514-528``) copies the whole ring
    with the fills written in; this reads [C, P] fill rows instead."""
    n, p = posts.mean.shape
    dst, src, w, ring = _events(edges, weights, lags, round_idx, hist_mean.shape[0], n)
    bad = _host(corrupt, bool).reshape(-1)[src]
    fill = None
    if bad.any():
        agents, j = np.unique(src[bad], return_inverse=True)
        ring = ring.copy()
        ring[bad] = -1 - j
        fill = _fill_rows(agents, fill_mean, fill_rho, p, posts.mean.device, hist_mean.dtype)
    return _ring_consensus(posts, _diag(W), _host(active) > 0, dst, ring, w, hist_mean,
                           hist_rho, fill=fill, wire_dtype=wire_dtype)


def consensus_flat_delayed_quarantined(posts: FlatPosterior, W, active, edges, weights, lags,
                                       hist_mean, hist_rho, round_idx, *, corrupt=None,
                                       fill_mean=None, fill_rho=None, wire_dtype=None,
                                       bound: float = QUARANTINE_BOUND):
    """Quarantine-guarded ``consensus_flat_delayed``: validate each delivered
    event's stale payload, drop invalid events (their weight moves to the
    destination's self term, summed in event order), keep agents with
    garbage resident state out of the merge.  Returns ``(posterior,
    valid_event [E] bool)``.

    ``corrupt``/``fill_mean``/``fill_rho`` ([N]) inject sender-side
    corruption at delivery time by source id (the ring stays clean).  A
    delivered row's validity is taken once per (slot, source) pair on the
    ring rows (``payload_validity``), a corrupted source's once per agent on
    its fill, never on an [E, P] gather.  Zero faults is a value-identity
    against ``consensus_flat_delayed``."""
    n, p = posts.mean.shape
    dev = posts.mean.device
    k = hist_mean.shape[0]
    dst, src, w, ring = _events(edges, weights, lags, round_idx, k, n)
    pairs, inv = np.unique(ring, return_inverse=True)
    rows = torch.from_numpy(pairs).to(dev)
    valid_e = _host(payload_validity(
        hist_mean.reshape(k * n, p).index_select(0, rows).to(torch.float32),
        hist_rho.reshape(k * n, p).index_select(0, rows).to(torch.float32),
        wire_dtype=wire_dtype, bound=bound))[inv.reshape(-1)]
    bad = (np.zeros(len(src), bool) if corrupt is None
           else _host(corrupt, bool).reshape(-1)[src])
    fill = None
    if bad.any():
        agents, j = np.unique(src[bad], return_inverse=True)
        fm, fr = _fill_rows(agents, fill_mean, fill_rho, 1, dev)
        valid_fill = _host(payload_validity(fm, fr, wire_dtype=wire_dtype, bound=bound))
        valid_e[bad] = valid_fill[j]
        read = bad & valid_e  # a valid fill is merged: read its row
        if read.any():
            agents, j = np.unique(src[read], return_inverse=True)
            ring = ring.copy()
            ring[read] = -1 - j
            fill = _fill_rows(agents, fill_mean, fill_rho, p, dev)
    w_g = np.where(valid_e, w, np.float32(0.0))
    drop = np.zeros(n, np.float32)
    np.add.at(drop, dst, w - w_g)
    valid_self = _host(payload_validity(posts.mean, posts.rho, wire_dtype=wire_dtype,
                                        bound=bound))
    out = _ring_consensus(posts, _diag(W) + drop, (_host(active) > 0) & valid_self,
                          dst[valid_e], ring[valid_e], w[valid_e], hist_mean, hist_rho,
                          fill=fill, wire_dtype=wire_dtype)
    return out, torch.from_numpy(valid_e).to(dev)


def _segments(posts: FlatPosterior, dst, src, w, act, h_mean=None, h_rho=None, *,
              block=None, wire_dtype=None) -> FlatPosterior:
    """Eq. (6) over an edge list whose sources index the stacked
    (posterior, h) rows; inactive rows pass through their resident row."""
    n = posts.mean.shape[0]
    # an active row no edge reaches sums nothing: 0 / 0, as in the reference
    lonely = np.flatnonzero(act & (np.bincount(dst, minlength=n) == 0))
    terms = ragged_terms(n, np.concatenate([dst, lonely]), np.concatenate([src, lonely]),
                         np.concatenate([w, np.zeros(len(lonely), np.float32)]), act)
    mean, rho = consensus_fused_segments(terms, posts.mean, posts.rho, h_mean, h_rho,
                                         wire_dtype=wire_dtype, block=block)
    return FlatPosterior(mean=mean, rho=rho, layout=posts.layout)


def _edge_arrays(posts, dst, src, weights, active):
    n = posts.mean.shape[0]
    return (_host(dst, np.int64).reshape(-1), _host(src, np.int64).reshape(-1),
            _host(weights, np.float32).reshape(-1),
            np.ones(n, bool) if active is None else _host(active) > 0)


def _transmissions(posts: FlatPosterior, corrupt=None, fill_mean=None, fill_rho=None,
                   mean_src=None, rho_src=None):
    """``(tx, h_mean, h_rho)``: agent j transmits row ``tx[j]`` of the
    stacked (posterior, h) rows.  With ``mean_src``/``rho_src`` h is those
    [N, P] buffers; with ``corrupt`` it is the corrupted agents' [C, P] fill
    rows; else there is no h and every agent transmits its resident row."""
    n, p = posts.mean.shape
    tx = np.arange(n)
    if mean_src is not None:
        return tx + n, mean_src, rho_src
    agents = (np.zeros(0, np.int64) if corrupt is None
              else np.flatnonzero(_host(corrupt, bool).reshape(-1)))
    if not len(agents):
        return tx, None, None
    tx[agents] = n + np.arange(len(agents))
    return (tx, *_fill_rows(agents, fill_mean, fill_rho, p, posts.mean.device))


def consensus_flat_segments(posts: FlatPosterior, dst, src, weights, *, active=None,
                            block=None, wire_dtype=None) -> FlatPosterior:
    """Edge-native eq. (6) over flat [E] edge arrays (self-loops included,
    e.g. ``SparseGraph.edge_arrays()``), never a dense [N, N] W:

        prec_out[i] = sum_{e: dst_e = i} w_e * prec_x[src_e]
        pm_out[i]   = sum_{e: dst_e = i} w_e * (prec * mu)_x[src_e]

    summed per row in edge order, with (prec, prec*mu) rounded through
    ``wire_dtype`` (a structural no-op at f32).  Zero-weight pad edges add
    ``0 *`` their source row.  ``active`` masks rows gossip-style: inactive
    rows pass through bitwise.  ``block`` (lanes) blocks the plain
    version's gather on the CPU; the kernel needs none."""
    dst, src, w, act = _edge_arrays(posts, dst, src, weights, active)
    return _segments(posts, dst, src, w, act, block=block, wire_dtype=wire_dtype)


def consensus_flat_segments_corrupted(posts: FlatPosterior, dst, src, weights, *, corrupt,
                                      fill_mean, fill_rho, active=None, block=None,
                                      wire_dtype=None) -> FlatPosterior:
    """``consensus_flat_segments`` with the strict policy's sender-side
    corruption: every edge from a ``corrupt`` source, its self loop
    included, reads that agent's constant (fill_mean, fill_rho) row;
    inactive rows keep their resident rows.  The reference
    (``repro/gossip/engine.py:590-603``) merges a full [N, P] copy with the
    fills written in and selects the inactive rows back; this reads [C, P]
    fill rows instead."""
    dst, src, w, act = _edge_arrays(posts, dst, src, weights, active)
    tx, h_mean, h_rho = _transmissions(posts, corrupt, fill_mean, fill_rho)
    return _segments(posts, dst, tx[src], w, act, h_mean, h_rho, block=block,
                     wire_dtype=wire_dtype)


def consensus_flat_segments_quarantined(posts: FlatPosterior, dst, src, weights, self_weight, *,
                                        active, mean_src=None, rho_src=None, corrupt=None,
                                        fill_mean=None, fill_rho=None, block=None,
                                        wire_dtype=None, bound: float = QUARANTINE_BOUND):
    """Quarantine-guarded ``consensus_flat_segments`` for edge-native windows
    (``gossip.clocks.SparseWindow``): ``dst``/``src``/``weights`` are the
    window's fired non-self edges (zero-weight pads allowed), ``self_weight``
    the conserve-rule self terms.  Every fired edge's wire payload is
    validated (its source's ``payload_validity`` on what the source
    transmits); invalid ones are dropped and their weight moves to the
    destination's self term; an agent whose resident state is invalid
    passes through unchanged; a sender whose transmission is invalid still
    merges, its self term reading its true resident row.  Returns
    ``(posterior, valid_edge [E] bool)``.

    What agents transmit: ``mean_src``/``rho_src`` ([N, P], the reference's
    injection hook), or the resident rows with ``corrupt`` agents' rows
    replaced by their constant (fill_mean, fill_rho), which the engine
    passes: those are read from [C, P] fill rows and validated once per
    agent.  With zero faults the terms are the unguarded call's over the
    fired-then-self edge list, so the output is bitwise that call's."""
    n = posts.mean.shape[0]
    valid_self = _host(payload_validity(posts.mean, posts.rho, wire_dtype=wire_dtype,
                                        bound=bound))
    tx, h_mean, h_rho = _transmissions(posts, corrupt, fill_mean, fill_rho, mean_src, rho_src)
    if mean_src is not None:
        valid_tx = _host(payload_validity(mean_src, rho_src, wire_dtype=wire_dtype, bound=bound))
    else:
        valid_tx = valid_self.copy()
        if h_mean is not None:
            fills = tx >= n
            valid_tx[fills] = _host(payload_validity(h_mean[:, :1].contiguous(),
                                                     h_rho[:, :1].contiguous(),
                                                     wire_dtype=wire_dtype, bound=bound))
    dst = _host(dst, np.int64).reshape(-1)
    src = _host(src, np.int64).reshape(-1)
    w = _host(weights, np.float32).reshape(-1)
    valid_e = valid_tx[src]
    drop = np.zeros(n, np.float32)
    np.add.at(drop, dst, w - np.where(valid_e, w, np.float32(0.0)))
    w_self = _host(self_weight).astype(np.float32).reshape(-1) + drop
    ar = np.arange(n)
    own = np.where(valid_tx, tx, ar)  # an invalid sender's self term reads its resident row
    terms = ragged_terms(
        n, np.concatenate([dst[valid_e], ar]), np.concatenate([tx[src[valid_e]], own]),
        np.concatenate([w[valid_e], w_self]), (_host(active) > 0) & valid_self,
        pass_src=np.where(valid_self, own, ar))
    mean, rho = consensus_fused_segments(terms, posts.mean, posts.rho, h_mean, h_rho,
                                         wire_dtype=wire_dtype, block=block)
    return (FlatPosterior(mean=mean, rho=rho, layout=posts.layout),
            torch.from_numpy(valid_e).to(posts.mean.device))
