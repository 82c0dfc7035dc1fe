"""Simulated multi-agent runtime (port of ``repro.core.simulated``): the whole
network lives on one device and agents are the leading axis of every
buffer.

One communication round at every agent i (Sec 2.1):
  1. draw a local batch (the data pipeline pre-slices u minibatches),
  2+3. u local Bayes-by-Backprop steps against the prior q_i^{(n-1)},
  4+5. consensus: precision-weighted averaging with row W_i (eq. 6), one
       network-wide pass (the CUDA kernel on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.flat import FlatLayout, FlatPosterior, flat_posterior_from_pytree, make_flat_nll
from repro_torch.core.posterior import consensus_all_agents, consensus_mean_only, init_posterior
from repro_torch.core.tree import tree_map
from repro_torch.optim import AdamState, Optimizer
from repro_torch.optim.schedules import Schedule
from repro_torch.vi.bayes_by_backprop import NllFn, local_vi_steps

PyTree = Any


@dataclasses.dataclass
class NetworkState:
    """State of the whole N-agent network (leading axis N on every buffer)."""

    posterior: FlatPosterior  # [N, P]
    opt_state: Any
    step: torch.Tensor  # per-agent local step counter [N] int32
    round: torch.Tensor  # scalar communication-round counter, int32

    def to(self, device) -> "NetworkState":
        """A copy of the whole state (posterior, Adam moments, counters) on
        ``device``."""
        return tree_map(lambda x: x.to(device, copy=True), self)


def init_network(generator: torch.Generator | None, n_agents: int,
                 init_params_fn: Callable[..., PyTree], opt: Optimizer,
                 init_sigma: float = 0.05, shared_init: bool = True,
                 device=None, params: PyTree | None = None) -> NetworkState:
    """Paper Remark 7: agents share one initialization the first time the
    local models are trained (``shared_init=False`` draws one per agent).

    ``params`` injects the drawn parameters (one agent's dict if
    ``shared_init``, else a dict of ``[N, ...]`` leaves) in place of the draw
    from ``generator``."""
    if params is None:
        if shared_init:
            params = init_params_fn(generator, device)
        else:
            draws = [init_params_fn(generator, device) for _ in range(n_agents)]
            params = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    if shared_init:
        params = {k: v.expand((n_agents,) + tuple(v.shape)) for k, v in params.items()}
    post = flat_posterior_from_pytree(init_posterior(params, init_sigma=init_sigma),
                                      leading_axes=1)
    return NetworkState(
        posterior=post,
        opt_state=opt.init(post),
        step=torch.zeros((n_agents,), dtype=torch.int32, device=post.mean.device),
        round=torch.zeros((), dtype=torch.int32, device=post.mean.device),
    )


def network_state_from_numpy(mean, rho, *, layout: FlatLayout, mu=None, nu=None,
                             step=None, round=0, device=None) -> NetworkState:
    """Carry a JAX-side network state across as numpy arrays: flat ``mean``
    and ``rho`` [N, P], the Adam moments ``mu`` and ``nu`` each as a (mean,
    rho) pair of [N, P] arrays (zeros if omitted), the per-agent ``step``
    [N] and the ``round`` counter.  The column spans are ``layout``'s, which
    match the JAX package's for the same parameter dict."""

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    post = FlatPosterior(t(mean), t(rho), layout)
    if post.mean.shape != post.rho.shape or post.mean.shape[-1] != layout.n_params:
        raise ValueError(f"posterior buffers {tuple(post.mean.shape)} do not fit "
                         f"the layout's P={layout.n_params}")
    zeros = (np.zeros(post.mean.shape, np.float32),) * 2
    mu, nu = mu or zeros, nu or zeros
    n = post.mean.shape[0]
    step = np.zeros(n, np.int32) if step is None else np.asarray(step, np.int32)
    return NetworkState(
        posterior=post,
        opt_state=AdamState(mu=FlatPosterior(t(mu[0]), t(mu[1]), layout),
                            nu=FlatPosterior(t(nu[0]), t(nu[1]), layout)),
        step=torch.from_numpy(step.copy()).to(device),
        round=torch.tensor(int(np.asarray(round)), dtype=torch.int32, device=device),
    )


def network_local_steps(posterior, prior, opt: Optimizer, opt_state, nll, batches,
                        lr, step, n_samples: int = 1, kl_scale: float = 1.0,
                        eps: torch.Tensor | None = None,
                        generator: torch.Generator | None = None):
    """The network-wide local phase, shared by the synchronous round and
    (in a later slice) the gossip window.  Returns (posterior', opt_state',
    per-agent mean losses [N])."""
    return local_vi_steps(posterior, prior, opt, opt_state, nll, batches, lr, step,
                          n_samples=n_samples, kl_scale=kl_scale, eps=eps,
                          generator=generator)


def make_round_fn(nll_fn: NllFn, opt: Optimizer, lr_schedule: Schedule,
                  n_mc_samples: int = 1, kl_scale: float = 1.0,
                  consensus: str = "gaussian", wire_dtype=None):
    """Build the per-round transition

        round_fn(state, batches, W, eps=None, generator=None) -> (state', losses [N])

    ``batches``: dict of ``[N, u, B, ...]`` tensors; ``W``: ``[N, N]``
    row-stochastic (may differ per round); ``eps``: the injected BbB noise
    ``[N, u, S, P]`` (else drawn from ``generator``).  ``nll_fn`` keeps its
    dict-parameter signature; the flat theta crosses to a dict only at the
    model-apply boundary.  ``wire_dtype`` compresses the gaussian consensus
    exchange; f32/None is uncompressed."""
    if consensus not in ("gaussian", "mean_only", "none"):
        raise ValueError(f"unknown consensus mode {consensus!r}")

    def round_fn(state: NetworkState, batches: dict, W: torch.Tensor,
                 eps: torch.Tensor | None = None,
                 generator: torch.Generator | None = None):
        nll = make_flat_nll(nll_fn, state.posterior.layout)
        lr = lr_schedule(state.round)
        prior = state.posterior  # q_i^{(n-1)}: consensus result of last round
        post, opt_state, losses = network_local_steps(
            state.posterior, prior, opt, state.opt_state, nll, batches, lr,
            state.step, n_samples=n_mc_samples, kl_scale=kl_scale, eps=eps,
            generator=generator,
        )
        u = next(iter(batches.values())).shape[1]
        if consensus == "gaussian":
            post = consensus_all_agents(post, W, wire_dtype=wire_dtype)
        elif consensus == "mean_only":
            post = dataclasses.replace(
                post,
                mean=consensus_mean_only(post.mean, W),
                rho=consensus_mean_only(post.rho, W),
            )
        # consensus == "none": isolated learning (paper Fig 1b baseline)
        new_state = NetworkState(
            posterior=post, opt_state=opt_state,
            step=state.step + u, round=state.round + 1,
        )
        return new_state, losses

    return round_fn


def as_w_schedule(w_schedule) -> Callable[[int], Any]:
    """Normalize a static W, a list cycled over rounds, or a round-indexed
    callable to one ``Callable[[int], W]``."""
    if callable(w_schedule):
        return w_schedule
    if isinstance(w_schedule, (list, tuple)):
        ws = list(w_schedule)
        if not ws:
            raise ValueError("empty W schedule")
        return lambda r: ws[r % len(ws)]
    return lambda r: w_schedule


def run_rounds(round_fn, state: NetworkState,
               batch_sampler: Callable[[torch.Generator, int], Any],
               w_schedule: Sequence | Any | Callable[[int], Any], n_rounds: int,
               generator: torch.Generator | None = None,
               eval_fn: Callable[[NetworkState], dict] | None = None,
               eval_every: int = 0) -> tuple[NetworkState, list[dict]]:
    """Python-level driver: batch_sampler(generator, round) -> batches
    [N, u, ...]; W from ``w_schedule`` (static, cycled list or callable)."""
    history: list[dict] = []
    w_for_round = as_w_schedule(w_schedule)
    device = state.posterior.mean.device
    for r in range(n_rounds):
        batches = batch_sampler(generator, r)
        W = torch.as_tensor(np.asarray(w_for_round(r)), dtype=torch.float32, device=device)
        state, losses = round_fn(state, batches, W, generator=generator)
        if eval_every and ((r + 1) % eval_every == 0 or r == n_rounds - 1):
            rec = {"round": r + 1, "loss": float(losses.mean())}
            if eval_fn is not None:
                rec.update(eval_fn(state))
            history.append(rec)
    return state, history
