"""Theorem 1 quantities: eigenvector centrality, spectral gap, rate K(Theta),
and the sample-complexity bound.

    K(Theta) = min_{theta* in Theta*, theta notin Theta*} sum_j v_j I_j(theta*, theta)
    n >= 8 C log(N |Theta| / delta) / (eps^2 (1 - lambda_max(W)))

where v is the unique stationary distribution of W (v = v W), lambda_max is
the second-largest eigenvalue (by the paper's indexing lambda_0 = 1), and
C = |log(L/alpha)| bounds the log-likelihood ratios.
"""
from __future__ import annotations

import numpy as np


def stationary_distribution(W: np.ndarray) -> np.ndarray:
    """Unique stationary distribution v of the row-stochastic W: v = v W.

    (= eigenvector centrality of the agents, paper Remark 3.)
    """
    W = np.asarray(W, dtype=np.float64)
    vals, vecs = np.linalg.eig(W.T)
    idx = int(np.argmin(np.abs(vals - 1.0)))
    v = np.real(vecs[:, idx])
    v = v / v.sum()
    if np.any(v < -1e-9):
        raise ValueError("stationary distribution has negative entries; W not irreducible?")
    return np.clip(v, 0.0, None) / np.clip(v, 0.0, None).sum()


def lambda_max(W: np.ndarray) -> float:
    """Second-largest eigenvalue modulus of W (paper: max_{1<=i<=N-1} lambda_i,
    with lambda_0 = 1 excluded)."""
    vals = np.linalg.eigvals(np.asarray(W, dtype=np.float64))
    mags = np.sort(np.abs(vals))[::-1]
    # drop one eigenvalue equal to 1 (Perron root)
    return float(mags[1]) if len(mags) > 1 else 0.0


def spectral_gap(W: np.ndarray) -> float:
    return 1.0 - lambda_max(W)


def rate_K(v: np.ndarray, I: np.ndarray) -> float:
    """K(Theta) from eq. (7).

    I: array [N, n_star, n_wrong] of divergence gaps
       I[j, s, t] = I_j(theta*_s, theta_t)  (may be negative per-agent; the
       network sum must be positive under Assumption 2).
    """
    v = np.asarray(v)
    I = np.asarray(I)
    summed = np.einsum("j,jst->st", v, I)  # [n_star, n_wrong]
    return float(summed.min())


def sample_complexity(
    n_agents: int, n_theta: int, delta: float, eps: float, C: float, W: np.ndarray
) -> float:
    """Theorem 1 sample-size condition n >= 8C log(N|Theta|/delta) / (eps^2 gap)."""
    gap = spectral_gap(W)
    if gap <= 0:
        return float("inf")
    return 8.0 * C * np.log(n_agents * n_theta / delta) / (eps**2 * gap)


def gaussian_divergence_gap(
    mean_true: np.ndarray, mean_wrong: np.ndarray, noise_var: float
) -> float:
    """I_j(theta*, theta) in the realizable Gaussian-likelihood case:
    E[KL(N(f*(x), s^2) || N(f_theta(x), s^2))] = E[(f* - f_theta)^2] / (2 s^2).

    Arguments are per-sample predictions under theta* and theta; the mean over
    samples approximates the expectation over P_j.
    """
    diff = np.asarray(mean_true) - np.asarray(mean_wrong)
    return float(np.mean(diff**2) / (2.0 * noise_var))


def predicted_decay_curve(K: float, n: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """Theorem 1 bound: max wrong-parameter belief < exp(-n (K - eps))."""
    return np.exp(-np.asarray(n) * (K - eps))


def consensus_contraction_rate(W: np.ndarray) -> float:
    """Per-round exponential decay rate of network DISAGREEMENT under
    repeated averaging with a static W: the disagreement component lives in
    the eigenspace orthogonal to the Perron root, so
    ``disagreement_n ~ lambda_max^n = exp(-n * rate)`` with
    ``rate = -log(lambda_max(W))``.

    This is the spectral (zero-learning) analogue of ``rate_K``: it feeds
    the same ``predicted_decay_curve(rate, n)`` overlay that the
    observability convergence tracker (``repro.obs.convergence``) compares
    measured disagreement decay against.  A disconnected W (lambda_max = 1)
    contracts nothing: rate 0.  A single pass of a complete uniform W
    (lambda_max = 0) contracts everything: rate inf.
    """
    lam = lambda_max(W)
    if lam >= 1.0:
        return 0.0
    # eigensolver noise: a uniform W's non-Perron eigenvalues come back as
    # ~1e-16 garbage, which -log would turn into a huge-but-finite rate
    if lam <= 1e-12:
        return float("inf")
    return float(-np.log(lam))
