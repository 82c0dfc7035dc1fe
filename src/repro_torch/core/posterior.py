"""Mean-field Gaussian posteriors (port of the synchronous-round subset of
``repro.core.posterior``).

Eq. (6), the closed-form consensus:
    prec_tilde_i = sum_j W_ij prec_j
    mu_tilde_i   = prec_tilde_i^{-1} sum_j W_ij prec_j mu_j
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.numerics import softplus, softplus_inv_py

PyTree = Any  # a (possibly nested) dict of tensors


@dataclasses.dataclass
class GaussianPosterior:
    """Mean-field Gaussian over a parameter dict; stddev = softplus(rho)."""

    mean: PyTree
    rho: PyTree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_posterior(params: PyTree, init_sigma: float = 0.05,
                   mean_init: PyTree | None = None) -> GaussianPosterior:
    """A mean-field posterior matching the structure of ``params``."""
    mean = params if mean_init is None else mean_init
    rho0 = softplus_inv_py(init_sigma)
    return GaussianPosterior(mean=mean, rho=_map(lambda p: torch.full_like(p, rho0), params))


def kl_gaussian(q, p) -> torch.Tensor:
    """KL(q || p) between two mean-field Gaussians over flat buffers
    ``[*B, P]``, summed over the parameter axis (one value per agent):
      KL = sum [ log(sp/sq) + (sq^2 + (mq-mp)^2) / (2 sp^2) - 1/2 ]
    """
    sq = softplus(q.rho)
    sp = softplus(p.rho)
    return torch.sum(
        torch.log(sp / sq)
        + (torch.square(sq) + torch.square(q.mean - p.mean)) / (2.0 * torch.square(sp))
        - 0.5,
        dim=-1,
    )


def consensus_all_agents(posts, W: torch.Tensor, wire_dtype=None):
    """Eq. (6) for ALL agents of a ``FlatPosterior`` ([N, P] buffers) in one
    network-wide pass (``core.flat.consensus_flat``: the CUDA kernel on the
    card).  ``wire_dtype`` rounds the exchanged (prec, prec*mu) at the
    exchange boundary; f32/None is uncompressed."""
    from repro_torch.core.flat import FlatPosterior, consensus_flat

    if not isinstance(posts, FlatPosterior):
        raise TypeError("consensus_all_agents takes a FlatPosterior")
    return consensus_flat(posts, W, wire_dtype=wire_dtype)


def consensus_mean_only(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Degenerate (delta-posterior) consensus: plain W-weighted averaging of
    an [N, P] buffer — the non-Bayesian baseline."""
    return torch.matmul(W.to(device=x.device, dtype=x.dtype), x)
