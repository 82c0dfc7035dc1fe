"""Bayes-by-Backprop variational inference (Blundell et al. [10]), the
paper's steps 2+3 (Remark 1, eq. 5); port of ``repro.vi.bayes_by_backprop``:

    b_i^{(n)} = argmin_{pi in Q}  KL(pi || q_i^{(n-1)}) + E_pi[ -log l_i(Y | . , X) ]

Everything runs on the whole network at once: ``post``/``prior`` are
``FlatPosterior``s over ``[N, P]`` buffers and ``nll_fn(theta [N, P],
batch)`` returns one value per agent; or ``GaussianPosterior``s over
parameter dicts whose leaves lead with the agent axis, ``nll_fn`` then
taking the sampled dict and the noise a dict of the same leaves.  Agents
are independent, so the gradient of the summed per-agent free energies is
each agent's own gradient (``torch.autograd`` on plain PyTorch ops, as the
JAX package leaves it to ``jax.grad``).

Noise seam: every draw takes an optional injected tensor and otherwise uses
the caller's ``torch.Generator``.  The BbB noise of a round is
``eps [N, u, S, P]`` (agent, local step, MC sample), the order of the JAX
key chain; the predictive noise is ``eps [n_mc, P]`` or ``[n_mc, N, P]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.flat import FlatPosterior
from repro_torch.core.posterior import kl_gaussian_agents
from repro_torch.core.tree import tree_leaves, tree_map, tree_replace_leaves
from repro_torch.obs.trace import current_obs, maybe_span
from repro_torch.optim import Optimizer, apply_updates

PyTree = Any
# nll_fn(theta [N, P], batch) -> [N] total negative log-likelihood per agent
NllFn = Callable[[torch.Tensor, Any], torch.Tensor]


def free_energy(post: FlatPosterior, prior: FlatPosterior, nll_fn: NllFn,
                batch: Any, eps: torch.Tensor, kl_scale: float = 1.0) -> torch.Tensor:
    """Per-agent variational free energy (eq. 5), ``[N]``:
    ``kl_scale * KL(q||prior) + E_q[-log lik]`` with the expectation over the
    MC samples ``eps [N, S, P]`` (a dict of ``[N, S, ...]`` leaves for a
    ``GaussianPosterior``)."""
    kl = kl_gaussian_agents(post, prior)
    n_samples = tree_leaves(eps)[0].shape[1]
    enll = torch.stack(
        [nll_fn(post.sample(noise=tree_map(lambda e: e[:, s], eps)), batch)
         for s in range(n_samples)]
    ).mean(dim=0)
    return kl_scale * kl + enll


AGENT_BLOCK_BYTES = 1 << 30  # a block's [agents, P] float32 buffer, at most


def agent_blocks(n: int, p: int) -> list[slice]:
    """The agent blocks a local step runs its autograd over: equal blocks
    whose [b, P] float32 buffer holds at most ``AGENT_BLOCK_BYTES``, so the
    graph's saved tensors and the optimizer's temporaries stay a fraction
    of the [N, P] state (N = 4,200 at the 784-200-200-10 model's P =
    199,210 runs 4 blocks; the paper's networks run one)."""
    k = min(n, max(1, -(-n * p * 4 // AGENT_BLOCK_BYTES)))
    b = -(-n // k)
    return [slice(s, min(s + b, n)) for s in range(0, n, b)]


def grads_like(post, leaves, value: torch.Tensor):
    """``torch.autograd.grad(value, leaves)`` as a tree shaped like
    ``post``: the gradient in each of ``leaves`` (``post``'s mean leaves,
    then its rho leaves, or the mean's alone, the rho's then 0), in a
    ``local.backward`` span of the current observability bundle."""
    n = len(tree_leaves(post.mean))
    with maybe_span(current_obs(), "local.backward"):
        grads = torch.autograd.grad(value, leaves)
    if len(grads) == n:
        grads = grads + tuple(torch.zeros_like(r) for r in tree_leaves(post.rho))
    return dataclasses.replace(post, mean=tree_replace_leaves(post.mean, grads[:n]),
                               rho=tree_replace_leaves(post.rho, grads[n:]))


def free_energy_and_grad(post: FlatPosterior, prior: FlatPosterior, nll_fn: NllFn,
                         batch: Any, eps: torch.Tensor, kl_scale: float = 1.0):
    """``free_energy`` ``[N]`` and its gradient with respect to ``post``'s
    buffers (a posterior of ``post``'s form): the gradient of the summed
    per-agent free energies, which is each agent's own
    (``torch.autograd.grad``; the prior is held fixed).  ``eps`` is the
    injected MC noise.  The value is a ``local.forward`` span of the current
    observability bundle."""
    q = tree_map(lambda x: x.detach().requires_grad_(True), post)
    prior = tree_map(torch.Tensor.detach, prior)
    with torch.enable_grad():
        with maybe_span(current_obs(), "local.forward"):
            value = free_energy(q, prior, nll_fn, batch, eps, kl_scale)
            total = value.sum()
        grads = grads_like(q, tree_leaves(q.mean) + tree_leaves(q.rho), total)
    return value.detach(), grads


def blocked_update(post: FlatPosterior, prior: FlatPosterior, opt: Optimizer, opt_state: Any,
                   grad_fn, batch: dict, eps: torch.Tensor | None, lr: torch.Tensor,
                   step: torch.Tensor, out=None):
    """The agent-block loop of one local step, over ``agent_blocks``: for
    each block, ``grad_fn(block, block_prior, block_batch, block_eps) ->
    (metrics, grads)`` (a tuple of ``[b]`` tensors, and a ``FlatPosterior``
    of the block's gradients), the optimizer's update and its new rows.
    ``step`` is the per-agent counter ``[N]`` or one scalar for all.  The
    new rows go into ``out`` (a ``(posterior, opt_state)`` pair, which may
    be ``post`` and ``opt_state`` themselves: a block's rows are read before
    they are written), else into new buffers.  ``post`` is a
    ``FlatPosterior`` or a ``GaussianPosterior`` (agent blocks by its
    parameters an agent; ``eps`` then a dict).  Each block's update and
    write-back is a ``local.optimizer`` span of the current observability
    bundle.  Returns (post', opt_state', the metrics, each ``[N]``)."""
    obs = current_obs()
    mean_leaves = tree_leaves(post.mean)
    n = mean_leaves[0].shape[0]
    p = sum(leaf[0].numel() for leaf in mean_leaves)
    if out is None:
        out = (tree_map(torch.empty_like, post), tree_map(torch.empty_like, opt_state))
    metrics = []
    for rows in agent_blocks(n, p):
        block = tree_map(lambda x: x[rows], post)
        values, grads = grad_fn(block, tree_map(lambda x: x[rows], prior),
                                {k: v[rows] for k, v in batch.items()},
                                None if eps is None else tree_map(lambda e: e[rows], eps))
        with maybe_span(obs, "local.optimizer"):
            updates, new_opt = opt.update(grads, tree_map(lambda x: x[rows], opt_state),
                                          step[rows] if step.ndim else step, lr)
            del grads  # [b, P] each: not held into the next block's forward
            new = apply_updates(block, updates)
            del updates
            for dst, src in zip(tree_leaves(out), tree_leaves((new, new_opt))):
                dst[rows].copy_(src)
        metrics.append(values)
    return out[0], out[1], tuple(torch.cat(m) for m in zip(*metrics))


def vi_step(post: FlatPosterior, prior: FlatPosterior, opt: Optimizer, opt_state: Any,
            nll_fn: NllFn, batch: dict, lr: torch.Tensor, step: torch.Tensor,
            eps: torch.Tensor, kl_scale: float = 1.0, out=None):
    """One Bayes-by-Backprop step on every agent (``batch``: dict of
    ``[N, ...]`` tensors, ``eps [N, S, P]``), run over ``agent_blocks``
    (``blocked_update``; ``out`` as there).  Returns (post', opt_state',
    loss [N])."""

    def grad_fn(block, block_prior, block_batch, block_eps):
        loss, grads = free_energy_and_grad(block, block_prior, nll_fn, block_batch, block_eps,
                                           kl_scale)
        return (loss,), grads

    post, opt_state, (loss,) = blocked_update(post, prior, opt, opt_state, grad_fn, batch, eps,
                                              lr, step, out)
    return post, opt_state, loss


def local_vi_steps(post: FlatPosterior, prior: FlatPosterior, opt: Optimizer,
                   opt_state: Any, nll_fn: NllFn, batches: dict, lr: torch.Tensor,
                   step0: torch.Tensor, n_samples: int = 1, kl_scale: float = 1.0,
                   eps: torch.Tensor | None = None,
                   generator: torch.Generator | None = None):
    """Run u local Bayes-by-Backprop steps on every agent.

    ``batches``: dict of ``[N, u, ...]`` tensors (one slice per local step).
    ``eps``: the injected noise ``[N, u, S, P]``; without it each step draws
    ``[N, S, P]`` from ``generator``.  Each step is a ``vi_step``: into new
    buffers at the first step (the inputs stay as they were), in place
    after.  Returns (new_post, new_opt_state, per-agent mean loss over the u
    steps [N])."""
    n, p = post.mean.shape
    u = next(iter(batches.values())).shape[1]
    out = None
    step = step0
    losses = []
    for t in range(u):
        eps_t = eps[:, t] if eps is not None else torch.randn(
            (n, n_samples, p), generator=generator, device=post.mean.device
        )
        post, opt_state, loss = vi_step(post, prior, opt, opt_state, nll_fn,
                                        {k: v[:, t] for k, v in batches.items()}, lr, step,
                                        eps_t, kl_scale, out=out)
        out = (post, opt_state)
        step = step + 1
        losses.append(loss)
    return post, opt_state, torch.stack(losses).mean(dim=0)


@torch.no_grad()
def mc_predict(post: FlatPosterior, logits_fn, x: torch.Tensor,
               eps: torch.Tensor | None = None, n_mc: int = 8,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Paper Sec 4.2: Monte-Carlo predictive distribution
    P(y) = (1/L) sum_k Softmax(y, f_{theta_k}(x)), theta_k ~ b_i^{(n)}, for
    every agent of ``post`` ([N, P]) at once.

    ``x`` is ``[T, dim]`` (shared by the agents) or ``[N, T, dim]``; ``eps``
    is ``[n_mc, P]`` (the same noise for every agent) or ``[n_mc, N, P]``.
    Returns the averaged class probabilities ``[N, T, n_classes]``."""
    n, p = post.mean.shape
    if x.ndim == 2:
        x = x.unsqueeze(0).expand(n, -1, -1)
    if eps is None:
        eps = torch.randn((n_mc, p), generator=generator, device=post.mean.device)
    probs = [
        torch.softmax(logits_fn(post.layout.unflatten(post.sample(e)), x), dim=-1)
        for e in eps
    ]
    return torch.stack(probs).mean(dim=0)


def predictive_confidence(probs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(argmax prediction, confidence = its predictive probability)."""
    return torch.argmax(probs, dim=-1), torch.amax(probs, dim=-1)
