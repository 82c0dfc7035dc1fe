"""Production step functions (port of ``repro.launch.steps``, the
``nll_fn`` branch): one local Bayes-by-Backprop step against an explicit
prior, and the standalone eq. (6) consensus, over a ``BayesTrainState``
whose posterior is a ``FlatPosterior`` end to end.

The language-model objective (``nll_fn=None``: ``models.nll_loss`` on a
config), ``make_train_round_step`` and the prefill and decode steps need the
model zoo (ROADMAP queue A item 10); ``make_local_step`` refuses them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.flat import FlatPosterior, make_flat_nll
from repro_torch.core.posterior import consensus_all_agents
from repro_torch.core.tree import tree_map
from repro_torch.optim import Optimizer
from repro_torch.optim.schedules import Schedule
from repro_torch.vi.bayes_by_backprop import vi_step

PyTree = Any


@dataclasses.dataclass
class BayesTrainState:
    """Leaves in ``jax.tree.leaves`` order: ``posterior.mean``,
    ``posterior.rho``, the optimizer state's, then ``step``."""

    posterior: FlatPosterior  # [A, P]
    opt_state: Any
    step: torch.Tensor  # 0-d int32: local steps taken

    def to(self, device) -> "BayesTrainState":
        """A copy of the whole state on ``device``."""
        return tree_map(lambda x: x.to(device, copy=True), self)


def make_local_step(cfg, opt: Optimizer, lr_schedule: Schedule, kl_scale: float = 1e-4,
                    *, nll_fn: Callable[[PyTree, Any], torch.Tensor] | None = None,
                    n_mc_samples: int = 1):
    """One local VI step against an explicit prior:

        step_fn(state, prior, batch, eps=None, generator=None) -> (state', loss [A])

    The loss is each agent's free energy ``kl_scale * KL(q||prior) +
    E_q[nll]`` (eq. 5, ``vi.free_energy`` over ``n_mc_samples`` samples);
    the gradient is that of their sum, so each agent's is its own.  The
    optimizer takes the scalar ``state.step`` and the learning rate
    ``lr_schedule(state.step)``.  ``eps [A, S, P]`` injects the noise, else
    it is drawn from ``generator``.  ``nll_fn(params, batch) -> [A]`` takes
    the parameter dict; the flat theta crosses to it at the model-apply
    boundary."""
    if cfg is not None or nll_fn is None:
        raise NotImplementedError(
            "the language-model objective of make_local_step needs the model zoo "
            "(ROADMAP queue A item 10); pass cfg=None and an nll_fn")

    def step_fn(state: BayesTrainState, prior: FlatPosterior, batch: dict,
                eps: torch.Tensor | None = None, generator: torch.Generator | None = None):
        post = state.posterior
        if eps is None:
            eps = torch.randn((post.mean.shape[0], n_mc_samples, post.mean.shape[1]),
                              generator=generator, device=post.mean.device)
        new_post, opt_state, loss = vi_step(
            post, prior, opt, state.opt_state, make_flat_nll(nll_fn, post.layout), batch,
            lr_schedule(state.step), state.step, eps, kl_scale)
        return BayesTrainState(posterior=new_post, opt_state=opt_state,
                               step=state.step + 1), loss

    return step_fn


def make_consensus_step(cfg, W: torch.Tensor, wire_dtype=None):
    """Standalone eq. (6) over the agent axis, the communication phase of a
    round: ``core.posterior.consensus_all_agents``, which runs the fused
    network-wide kernel for a ``FlatPosterior`` on the card.  ``wire_dtype``
    compresses the exchanged (prec, prec*mu); f32/None is uncompressed."""
    del cfg  # consensus is model-independent

    def step_fn(posterior: FlatPosterior) -> FlatPosterior:
        return consensus_all_agents(posterior, W, wire_dtype=wire_dtype)

    return step_fn
