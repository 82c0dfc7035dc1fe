"""Production step functions (port of ``repro.launch.steps``): one local
Bayes-by-Backprop step against an explicit prior (the ``nll_fn`` branch),
the standalone eq. (6) consensus, over a ``BayesTrainState`` whose
posterior is a ``FlatPosterior`` end to end; and, over the model zoo's
dense configs, ``init_train_state``, ``serve_params`` and the prefill and
decode steps for A agents at once.

Agent axis: the reference ``jax.vmap``s the prefill and decode steps over
agents.  The flash-attention kernels launch through raw pointers, which
``torch.func.vmap`` cannot trace, so the port carries the agents as the
leading axis of every params and cache leaf and of the tokens, and runs
them in one pass (``models.transformer``): each kernel launches once per
step for all agents.

The language-model objective of the local step (``nll_fn=None``) and
``make_train_round_step`` come with the LM training slice (ROADMAP queue A
item 10e); ``make_local_step`` refuses them.  ``launch`` imports the model
zoo only inside the LM functions.
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
            "the language-model objective of make_local_step comes with the LM training slice "
            "(ROADMAP queue A item 10e); pass cfg=None and an nll_fn")

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


# ---------------------------------------------------------------------------
# the model zoo: train state, serving weights, prefill and decode
# ---------------------------------------------------------------------------


def init_train_state(cfg, n_agents: int, opt: Optimizer, generator: torch.Generator | None = None,
                     init_sigma: float = 0.02, flat: bool = True, device=None) -> BayesTrainState:
    """Every agent starts from the same ``models.init_params`` draw: a
    ``FlatPosterior [A, P]`` (its ``FlatLayout`` the reference's for the
    same config) or, with ``flat=False``, a ``GaussianPosterior`` over the
    agent-stacked parameter dict."""
    from repro_torch.core.flat import flat_posterior_from_pytree
    from repro_torch.core.posterior import init_posterior
    from repro_torch.models import init_params

    params = init_params(cfg, generator, device=device)
    stacked = tree_map(lambda p: p.expand((n_agents,) + tuple(p.shape)), params)
    post = init_posterior(stacked, init_sigma=init_sigma)
    if flat:
        post = flat_posterior_from_pytree(post, leading_axes=1)
    else:
        post = tree_map(lambda x: x.contiguous(), post)
    return BayesTrainState(posterior=post, opt_state=opt.init(post),
                           step=torch.zeros((), dtype=torch.int32,
                                            device=params["embed"]["emb"].device))


def serve_params(posterior, dtype=torch.bfloat16) -> PyTree:
    """Posterior-mean weights cast for serving (the paper's L=1 predictive
    path).  A flat posterior is unflattened here: serving consumes the model
    dict, leaves ``[A, ...]``."""
    mean = posterior.mean
    if isinstance(posterior, FlatPosterior):
        mean = posterior.layout.unflatten(mean)
    return tree_map(lambda m: m.to(dtype), mean)


def make_prefill_step(cfg, window_override: int | None = None):
    """``(params [A, ...], batch {"tokens": [A, B, S]}, cache [A, ...]) ->
    (next-token logits [A, B, 1, V], cache)``; the cache is written in
    place."""
    from repro_torch.models import forward

    def step_fn(params: PyTree, batch: dict, cache: PyTree):
        logits, cache, _ = forward(params, cfg, batch["tokens"], cache=cache,
                                   frames=batch.get("frames"), patches=batch.get("patches"),
                                   logits_tail=1, window_override=window_override)
        return logits, cache

    return step_fn


def make_decode_step(cfg, window_override: int | None = None):
    """``(params [A, ...], token [A, B, 1], position, cache) -> (logits
    [A, B, 1, V], cache)``; ``position`` is one absolute position for every
    agent (an int or a 0-d tensor)."""
    from repro_torch.models import decode_step

    def step_fn(params: PyTree, token: torch.Tensor, position, cache: PyTree, frames=None):
        return decode_step(params, cfg, token, position, cache, enc_out_frames=frames,
                           window_override=window_override)

    return step_fn


def make_agent_cache(cfg, n_agents: int, batch_per_agent: int, capacity: int,
                     dtype=torch.bfloat16, device=None) -> PyTree:
    """Agent-stacked decode cache ``[A, ...]``, empty (positions -1)."""
    from repro_torch.models import init_cache

    return init_cache(cfg, batch_per_agent, capacity, dtype, device, n_agents=n_agents)
