"""The public kernel API over parameter pytrees (port of
``repro.kernels.ops``): each function flattens a posterior dict, runs one
kernel and rebuilds the dict.

Leaves go in sorted-key order (``jax.tree.flatten``'s order for dicts).
Flattening records every leaf's shape and dtype and computes in float32;
rebuilding casts every leaf back to its recorded dtype (bf16 and int leaves
too), so a mixed-dtype tree round-trips without silent promotion.

The device follows the tensors: CUDA tensors launch the kernels or raise,
CPU tensors take their plain versions.  For the runtime's flat ``[N, P]``
posterior use ``core.flat``, which keeps its layout once instead of
rebuilding it per call.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.numerics import COMPUTE_DTYPE
from repro_torch.core.posterior import GaussianPosterior, leaves_with_keys, set_path
from repro_torch.kernels.consensus import (
    consensus_fused,
    consensus_fused_network,
    consensus_fused_sparse,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gauss_vi import sample_and_kl_fused

PyTree = Any  # a (possibly nested) dict of tensors, or one tensor


def _flatten(tree: PyTree, lead: int = 0):
    """Concatenate the leaves, each reshaped to ``[*lead dims, -1]`` and cast
    to float32; returns (flat, paths, shapes, dtypes), the shapes without
    the ``lead`` leading axes."""
    paths, leaves = zip(*leaves_with_keys(tree))
    flat = torch.cat([leaf.reshape(tuple(leaf.shape[:lead]) + (-1,)).to(COMPUTE_DTYPE)
                      for leaf in leaves], dim=-1)
    return flat, paths, [tuple(leaf.shape[lead:]) for leaf in leaves], [
        leaf.dtype for leaf in leaves]


def _unflatten(flat: torch.Tensor, paths, shapes, dtypes) -> PyTree:
    """Split the last axis of ``flat`` back into the recorded leaves."""
    out: dict = {}
    off = 0
    for path, shape, dtype in zip(paths, shapes, dtypes):
        n = math.prod(shape)
        leaf = flat[..., off:off + n].reshape(tuple(flat.shape[:-1]) + shape).to(dtype)
        off += n
        if not path:  # the tree is one tensor
            return leaf
        set_path(out, path, leaf)
    return out


def consensus_posterior(posts: GaussianPosterior, w_row) -> GaussianPosterior:
    """Eq. (6) for one agent over a whole posterior pytree whose leaves are
    ``[N, ...]`` (the neighbours, self included), with ``w_row [N]`` the
    agent's row of W (kernel ``consensus_fused``).  Returns the agent's
    posterior, without the leading axis."""
    mean_flat, paths, shapes, dtypes = _flatten(posts.mean, lead=1)
    rho_flat = _flatten(posts.rho, lead=1)[0]
    w = torch.as_tensor(w_row, device=mean_flat.device).to(COMPUTE_DTYPE)
    mean_o, rho_o = consensus_fused(w, mean_flat, rho_flat)
    return GaussianPosterior(mean=_unflatten(mean_o, paths, shapes, dtypes),
                             rho=_unflatten(rho_o, paths, shapes, dtypes))


def consensus_network(posts, W):
    """Eq. (6) for every agent of a ``core.flat.FlatPosterior`` in one kernel
    launch (``consensus_fused_network``).  Prefer ``core.flat.consensus_flat``;
    this forces the kernel."""
    W = torch.as_tensor(W, device=posts.mean.device).to(COMPUTE_DTYPE)
    mean, rho = consensus_fused_network(W, posts.mean, posts.rho)
    return dataclasses.replace(posts, mean=mean, rho=rho)


def consensus_network_sparse(posts, neighbors, weights):
    """The CSR form of ``consensus_network`` (tables from
    ``core.flat.neighbor_tables``; kernel ``consensus_fused_sparse``)."""
    mean, rho = consensus_fused_sparse(neighbors, weights, posts.mean, posts.rho)
    return dataclasses.replace(posts, mean=mean, rho=rho)


def sample_and_kl(post: GaussianPosterior, prior: GaussianPosterior,
                  generator: torch.Generator | None = None, *, eps=None):
    """Reparameterized sample + KL over a whole posterior pytree in one pass
    (kernel ``sample_and_kl_fused``).  ``eps`` is the injected standard-normal
    noise over the flat concatenation of the leaves, in sorted-key order (the
    reference draws its noise over that same vector); without it the noise
    is drawn from ``generator``.  Returns (theta pytree, kl scalar)."""
    mu, paths, shapes, dtypes = _flatten(post.mean)
    rho = _flatten(post.rho)[0]
    mu_p = _flatten(prior.mean)[0]
    rho_p = _flatten(prior.rho)[0]
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    else:
        eps = torch.as_tensor(eps, device=mu.device).to(COMPUTE_DTYPE)
        if eps.shape != mu.shape:
            raise ValueError(f"eps of shape {tuple(eps.shape)}, expected {tuple(mu.shape)}")
    theta, kl = sample_and_kl_fused(mu, rho, eps, mu_p, rho_p)
    return _unflatten(theta, paths, shapes, dtypes), kl


def attention(q, k, v, *, causal=True, window=0, block_q=512, block_k=512):
    """``[B, H, S, hd]`` flash attention (kernel ``flash_attention``)."""
    return flash_attention(q, k, v, causal=causal, window=window, block_q=block_q,
                           block_k=block_k)
