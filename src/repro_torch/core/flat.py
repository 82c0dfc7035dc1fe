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
    consensus_fused_sparse,
    consensus_masked_plain,
    consensus_network_plain,
    csr_tables,
    payload_validity_fused,
)

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
