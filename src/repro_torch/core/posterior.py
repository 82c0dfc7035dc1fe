"""Mean-field Gaussian posteriors (port of the mean-field half of
``repro.core.posterior``).

Eq. (6), the closed-form consensus:
    prec_tilde_i = sum_j W_ij prec_j
    mu_tilde_i   = prec_tilde_i^{-1} sum_j W_ij prec_j mu_j

Two forms of a posterior go through the functions here, told apart by the
type of ``mean``: a parameter dict (a pytree, as in the reference, with
leaves in sorted-key order, which is ``jax.tree.flatten``'s order for
dicts) or a flat ``[*B, P]`` tensor (``core.flat.FlatPosterior``, the
runtime's form).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.numerics import softplus, softplus_inv, softplus_inv_py, wire_roundtrip

PyTree = Any  # a (possibly nested) dict of tensors


def leaves_with_keys(tree: PyTree, keys: tuple[str, ...] = ()):
    """(dict-key path, tensor) pairs in sorted-key order; a bare tensor is
    the one leaf at path ()."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_keys(tree[k], keys + (k,))
    elif isinstance(tree, torch.Tensor):
        yield keys, tree
    else:
        raise TypeError(f"unsupported parameter tree node {type(tree)}")


def set_path(tree: dict, keys: tuple[str, ...], value) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in leaves_with_keys(tree)]


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure, in sorted-key order
    (so draws made by ``fn`` follow the reference's leaf order)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in sorted(trees[0])}
    return fn(*trees)


@dataclasses.dataclass
class GaussianPosterior:
    """Mean-field Gaussian over a parameter dict; stddev = softplus(rho)."""

    mean: PyTree
    rho: PyTree

    def sigma(self) -> PyTree:
        return _map(softplus, self.rho)

    def precision(self) -> PyTree:
        return _map(lambda r: 1.0 / torch.square(softplus(r)), self.rho)

    def sample(self, generator: torch.Generator | None = None,
               noise: PyTree | None = None) -> PyTree:
        """Reparameterized sample theta = mu + sigma * eps.  ``noise`` is the
        injected standard-normal tree; without it each leaf draws its own
        ``eps`` from ``generator``, in sorted-key order."""
        if noise is None:
            noise = _map(lambda m: torch.randn(m.shape, generator=generator, dtype=m.dtype,
                                               device=m.device), self.mean)
        return _map(lambda m, r, e: m + softplus(r) * e, self.mean, self.rho, noise)

    def n_params(self) -> int:
        return sum(int(leaf.numel()) for leaf in _leaves(self.mean))


def init_posterior(params: PyTree, init_sigma: float = 0.05,
                   mean_init: PyTree | None = None) -> GaussianPosterior:
    """A mean-field posterior matching the structure of ``params``."""
    mean = params if mean_init is None else mean_init
    rho0 = softplus_inv_py(init_sigma)
    return GaussianPosterior(mean=mean, rho=_map(lambda p: torch.full_like(p, rho0), params))


def posterior_from_numpy(mean_tree, rho_tree, device=None) -> GaussianPosterior:
    """Carry a JAX-side pytree posterior across: dicts of numpy arrays
    (``jax.tree.map(np.asarray, ...)``) -> a ``GaussianPosterior`` of tensors
    on ``device``, bit for bit and dtype for dtype (bf16 leaves too)."""

    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: move the bits
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
        return torch.from_numpy(a.copy()).to(device)

    return GaussianPosterior(mean=_map(t, mean_tree), rho=_map(t, rho_tree))


def _leaf_kl(mq, rq, mp, rp, dim=None):
    sq = softplus(rq)
    sp = softplus(rp)
    terms = (torch.log(sp / sq)
             + (torch.square(sq) + torch.square(mq - mp)) / (2.0 * torch.square(sp)) - 0.5)
    return torch.sum(terms) if dim is None else torch.sum(terms, dim=dim)


def kl_gaussian(q, p) -> torch.Tensor:
    """KL(q || p) between two mean-field Gaussians:
      KL = sum [ log(sp/sq) + (sq^2 + (mq-mp)^2) / (2 sp^2) - 1/2 ]
    Over parameter dicts: one scalar, the leafwise sums added in sorted-key
    order.  Over flat buffers ``[*B, P]``: summed over the parameter axis,
    one value per agent."""
    if isinstance(q.mean, dict):
        total = torch.zeros((), dtype=torch.float32, device=_leaves(q.mean)[0].device)
        for mq, rq, mp, rp in zip(_leaves(q.mean), _leaves(q.rho), _leaves(p.mean),
                                  _leaves(p.rho)):
            total = total + _leaf_kl(mq, rq, mp, rp)
        return total
    return _leaf_kl(q.mean, q.rho, p.mean, p.rho, dim=-1)


def consensus_mean_field(posts: GaussianPosterior, w_row: torch.Tensor) -> GaussianPosterior:
    """Eq. (6) for ONE agent from stacked neighbour posteriors: every leaf
    carries a leading axis of size N (the neighbours, self included) and
    ``w_row [N]`` is the agent's row of W.  Zero weights contribute nothing."""

    def combine(mean_stack, rho_stack):
        prec = 1.0 / torch.square(softplus(rho_stack))
        w = w_row.to(device=mean_stack.device, dtype=prec.dtype).reshape(
            (-1,) + (1,) * (mean_stack.ndim - 1))
        new_prec = torch.sum(w * prec, dim=0)
        new_mean = torch.sum(w * prec * mean_stack, dim=0) / new_prec
        return new_mean, softplus_inv(torch.sqrt(1.0 / new_prec))

    out = _map(combine, posts.mean, posts.rho)
    return GaussianPosterior(mean=_map_pair(out, 0), rho=_map_pair(out, 1))


def _map_pair(tree, i):
    """Pick element ``i`` of every (a, b) pair leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _map_pair(v, i) for k, v in tree.items()}
    return tree[i]


def consensus_all_agents(posts, W: torch.Tensor, wire_dtype=None):
    """Eq. (6) for ALL agents.  A ``FlatPosterior`` ([N, P] buffers) goes
    through one network-wide pass (``core.flat.consensus_flat``: the CUDA
    kernel on the card); a ``GaussianPosterior`` over a parameter dict whose
    leaves carry a leading agent axis N goes leaf by leaf (the reference's
    paper-faithful loop).  ``wire_dtype`` rounds the exchanged (prec,
    prec*mu) at the exchange boundary; f32/None is uncompressed."""
    from repro_torch.core.flat import FlatPosterior, consensus_flat

    if isinstance(posts, FlatPosterior):
        return consensus_flat(posts, W, wire_dtype=wire_dtype)
    if not isinstance(posts, GaussianPosterior):
        raise TypeError("consensus_all_agents takes a FlatPosterior or a GaussianPosterior")

    def combine(mean_stack, rho_stack):
        prec = 1.0 / torch.square(softplus(rho_stack))
        pm = prec * mean_stack
        prec_x = wire_roundtrip(prec, wire_dtype)
        pm_x = wire_roundtrip(pm, wire_dtype)
        w = torch.as_tensor(W, device=mean_stack.device).to(prec.dtype)
        new_prec = torch.tensordot(w, prec_x, dims=1)
        new_mean = torch.tensordot(w, pm_x, dims=1) / new_prec
        return new_mean, softplus_inv(torch.sqrt(1.0 / new_prec))

    out = _map(combine, posts.mean, posts.rho)
    return GaussianPosterior(mean=_map_pair(out, 0), rho=_map_pair(out, 1))


def consensus_mean_only(params, W: torch.Tensor):
    """Degenerate (delta-posterior) consensus: plain W-weighted averaging of
    an [N, P] buffer, or of every [N, ...] leaf of a parameter dict — the
    non-Bayesian baseline."""
    def avg(x):
        return torch.tensordot(torch.as_tensor(W, device=x.device).to(x.dtype), x, dims=1)

    if isinstance(params, dict):
        return _map(avg, params)
    return torch.matmul(W.to(device=params.device, dtype=params.dtype), params)
