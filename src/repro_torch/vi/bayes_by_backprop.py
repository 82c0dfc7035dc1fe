"""Bayes-by-Backprop variational inference (Blundell et al. [10]), the
paper's steps 2+3 (Remark 1, eq. 5); port of ``repro.vi.bayes_by_backprop``:

    b_i^{(n)} = argmin_{pi in Q}  KL(pi || q_i^{(n-1)}) + E_pi[ -log l_i(Y | . , X) ]

Everything runs on the whole network at once: ``post``/``prior`` are
``FlatPosterior``s over ``[N, P]`` buffers and ``nll_fn(theta [N, P],
batch)`` returns one value per agent.  Agents are independent, so the
gradient of the summed per-agent free energies is each agent's own gradient
(``torch.autograd`` on plain PyTorch ops, as the JAX package leaves it to
``jax.grad``).

Noise seam: every draw takes an optional injected tensor and otherwise uses
the caller's ``torch.Generator``.  The BbB noise of a round is
``eps [N, u, S, P]`` (agent, local step, MC sample), the order of the JAX
key chain; the predictive noise is ``eps [n_mc, P]`` or ``[n_mc, N, P]``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.flat import FlatPosterior
from repro_torch.core.posterior import kl_gaussian
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.optim import Optimizer, apply_updates

PyTree = Any
# nll_fn(theta [N, P], batch) -> [N] total negative log-likelihood per agent
NllFn = Callable[[torch.Tensor, Any], torch.Tensor]


def free_energy(post: FlatPosterior, prior: FlatPosterior, nll_fn: NllFn,
                batch: Any, eps: torch.Tensor, kl_scale: float = 1.0) -> torch.Tensor:
    """Per-agent variational free energy (eq. 5), ``[N]``:
    ``kl_scale * KL(q||prior) + E_q[-log lik]`` with the expectation over the
    MC samples ``eps [N, S, P]``."""
    kl = kl_gaussian(post, prior)
    enll = torch.stack(
        [nll_fn(post.sample(eps[:, s]), batch) for s in range(eps.shape[1])]
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


def local_vi_steps(post: FlatPosterior, prior: FlatPosterior, opt: Optimizer,
                   opt_state: Any, nll_fn: NllFn, batches: dict, lr: torch.Tensor,
                   step0: torch.Tensor, n_samples: int = 1, kl_scale: float = 1.0,
                   eps: torch.Tensor | None = None,
                   generator: torch.Generator | None = None):
    """Run u local Bayes-by-Backprop steps on every agent.

    ``batches``: dict of ``[N, u, ...]`` tensors (one slice per local step).
    ``eps``: the injected noise ``[N, u, S, P]``; without it each step draws
    ``[N, S, P]`` from ``generator``.  Agents are independent, so each step
    runs over ``agent_blocks`` and writes every block's new rows into one
    set of output buffers (new at the first step: the inputs stay as they
    were; updated in place after).  Returns (new_post, new_opt_state,
    per-agent mean loss over the u steps [N])."""
    n, p = post.mean.shape
    u = next(iter(batches.values())).shape[1]
    prior = FlatPosterior(prior.mean.detach(), prior.rho.detach(), prior.layout)
    blocks = agent_blocks(n, p)
    out = out_opt = None
    step = step0
    losses = []
    for t in range(u):
        batch = {k: v[:, t] for k, v in batches.items()}
        eps_t = eps[:, t] if eps is not None else torch.randn(
            (n, n_samples, p), generator=generator, device=post.mean.device
        )
        if out is None:
            out, out_opt = tree_map(torch.empty_like, post), tree_map(torch.empty_like, opt_state)
        loss_t = []
        for rows in blocks:
            mean = post.mean[rows].detach().requires_grad_(True)
            rho = post.rho[rows].detach().requires_grad_(True)
            loss = free_energy(FlatPosterior(mean, rho, post.layout),
                               tree_map(lambda x: x[rows], prior), nll_fn,
                               {k: v[rows] for k, v in batch.items()}, eps_t[rows], kl_scale)
            g_mean, g_rho = torch.autograd.grad(loss.sum(), (mean, rho))
            updates, new_opt = opt.update(FlatPosterior(g_mean, g_rho, post.layout),
                                          tree_map(lambda x: x[rows], opt_state), step[rows], lr)
            del g_mean, g_rho  # [b, P] each: not held into the next block's forward
            new = apply_updates(FlatPosterior(mean.detach(), rho.detach(), post.layout), updates)
            del updates
            for dst, src in zip(tree_leaves((out, out_opt)), tree_leaves((new, new_opt))):
                dst[rows].copy_(src)
            loss_t.append(loss.detach())
        post, opt_state = out, out_opt
        step = step + 1
        losses.append(torch.cat(loss_t))
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
