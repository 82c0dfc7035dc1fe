"""Finite-Theta decentralized learning rule (the exact setting of Theorem 1;
port of ``repro.core.discrete``).

With Theta finite and Q = P(Theta) the projection step (eq. 3) is the
identity, so one round at agent i is exactly:

  local Bayesian update (eq. 2):
      log b_i(theta) = log q_i(theta) + sum_{m in batch} log l_i(y_m | theta, x_m)
      (then normalize)
  consensus (eq. 4):
      log q_i(theta) = sum_j W_ij log b_j(theta)   (then normalize)

Everything is carried in log-space; beliefs have shape [N, |Theta|], float32.
``run_social_learning`` runs on the card unless asked for the CPU; its
``logliks=`` seam injects every round's log-likelihoods (the port cannot
replay the JAX package's threefry draws).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.dispatch import resolve_device


def normalize_log(logb: torch.Tensor) -> torch.Tensor:
    """Normalize log-beliefs along the last (Theta) axis."""
    return logb - torch.logsumexp(logb, dim=-1, keepdim=True)


def local_bayes_update(logq: torch.Tensor, loglik: torch.Tensor) -> torch.Tensor:
    """Eq. (2) in log space.

    logq:   [N, T] current private posteriors
    loglik: [N, T] sum over the agent's batch of log l_i(y|theta, x)
    returns [N, T] public posteriors b_i^{(n)}
    """
    return normalize_log(logq + loglik)


def consensus_update(logb: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Eq. (4) in log space: log q_i = sum_j W_ij log b_j (then normalize)."""
    return normalize_log(W @ logb)


def social_learning_round(logq: torch.Tensor, loglik: torch.Tensor,
                          W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One full round; returns (new_logq, logb)."""
    logb = local_bayes_update(logq, loglik)
    return consensus_update(logb, W), logb


def run_social_learning(
    generator: torch.Generator | None,
    W,
    loglik_sampler: Callable[[torch.Generator], torch.Tensor] | None,
    n_rounds: int,
    n_theta: int,
    device=None,
    logliks=None,
) -> torch.Tensor:
    """Run ``n_rounds`` rounds from the uniform prior on ``device`` (default:
    the card).

    ``loglik_sampler(generator) -> [N, T]`` draws one round's batch
    log-likelihoods; ``logliks`` ([n_rounds, N, T]) injects them all
    instead.  Returns the trajectory of public posteriors logb:
    [n_rounds, N, T].
    """
    device = resolve_device(device)
    W = torch.as_tensor(W, dtype=torch.float32, device=device)
    if logliks is not None:
        logliks = torch.as_tensor(logliks, dtype=torch.float32, device=device)
        if logliks.shape[0] != n_rounds:
            raise ValueError(f"logliks has {logliks.shape[0]} rounds, expected {n_rounds}")
    # -log|Theta| in float32, as jnp.log(n_theta) computes it
    logq = (-torch.log(torch.tensor(float(n_theta), device=device))).expand(W.shape[0], n_theta)
    traj = []
    for r in range(n_rounds):
        loglik = logliks[r] if logliks is not None else loglik_sampler(generator)
        logq, logb = social_learning_round(logq, loglik.to(torch.float32), W)
        traj.append(logb)
    return torch.stack(traj)


def wrong_belief_trajectory(traj_logb: torch.Tensor, wrong_idx) -> torch.Tensor:
    """max_i max_{theta in wrong set} b_i^{(n)}(theta) per round — the LHS of
    Theorem 1's bound.  traj_logb: [R, N, T]; wrong_idx: [k] indices."""
    wrong = traj_logb[..., torch.as_tensor(wrong_idx, device=traj_logb.device)]  # [R, N, k]
    return torch.exp(torch.amax(wrong, dim=(1, 2)))
