"""Minimal optax-style optimizers (port of ``repro.optim.optimizers``).

An ``Optimizer`` is an (init, update) pair over parameter trees: a tensor,
or a dataclass of tensors or of dicts of tensors such as ``FlatPosterior``
and ``GaussianPosterior``.
``update`` takes (grads, state, step, lr) and returns (updates, new_state),
so learning-rate schedules stay outside the state.  ``step`` may carry
leading axes (the per-agent step counter [N]); they broadcast against the
leading axes of every leaf.  Updates run without autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, torch.Tensor, torch.Tensor], tuple[PyTree, PyTree]]


@dataclasses.dataclass
class AdamState:
    mu: PyTree
    nu: PyTree


@dataclasses.dataclass
class SgdState:
    momentum: PyTree


def _lead(x: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-agent [*B] value against a [*B, ...] leaf."""
    return x.reshape(tuple(x.shape) + (1,) * (leaf.ndim - x.ndim))


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam (Kingma & Ba, 2015) as the JAX package writes it:
    ``-lr * (m/bc1) / (sqrt(v/bc2) + eps)`` with a 1-indexed step."""

    def init(params: PyTree) -> AdamState:
        return AdamState(mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads, state: AdamState, step, lr):
        t = (step + 1).to(torch.float32)  # 1-indexed for bias correction
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g), state.nu, grads)
        updates = tree_map(
            lambda m, v: -lr * (m / _lead(bc1, m)) / (torch.sqrt(v / _lead(bc2, v)) + eps),
            mu, nu,
        )
        return updates, AdamState(mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def sgd(momentum: float = 0.0) -> Optimizer:
    def init(params: PyTree) -> SgdState:
        return SgdState(momentum=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads, state: SgdState, step, lr):
        del step
        mom = tree_map(lambda m, g: momentum * m + g, state.momentum, grads)
        return tree_map(lambda m: -lr * m, mom), SgdState(momentum=mom)

    return Optimizer(init=init, update=update)


@torch.no_grad()
def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree: PyTree) -> torch.Tensor:
    """The l2 norm of all of ``tree``'s leaves together, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """``grads`` scaled by ``min(1, max_norm / (global_norm + 1e-12))``."""
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)
