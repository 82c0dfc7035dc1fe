"""The finite-Theta learning rule of repro_torch (``core.discrete``) against
the JAX package's, on the CPU, at every setting of tests/test_discrete.py.

The port cannot replay JAX's threefry draws, so each test computes the JAX
run's per-round log-likelihoods (``split(key(seed), rounds)`` -> the
sampler, repro/core/discrete.py:74) and injects them through
``run_social_learning(..., logliks=)``.  Tolerance on the log-beliefs of
every round: ``atol=1e-5, rtol=1e-6``.  The relative term is fp32 rounding:
after 300 rounds a log-belief reaches -600, where one ulp is 6.1e-5, and
the two packages' logsumexp and matmul sum in another order (measured: at
most 0.29 of that tolerance).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import discrete as jd  # noqa: E402
from repro.core.graphs import complete_w, ring_w, star_w  # noqa: E402
from repro_torch.core import discrete as td  # noqa: E402
from repro_torch.core import theory as tt  # noqa: E402


def _sampler(key, means, noise_std, n_agents, batch=4):
    """tests/test_discrete.py:17."""
    y = means[:, 0:1] + noise_std * jax.random.normal(key, (n_agents, batch))
    return -0.5 * jnp.sum(((y[:, :, None] - means[:, None, :]) / noise_std) ** 2, axis=1)


def _star_means(idx):
    m = np.zeros((5, 2), np.float32)
    m[idx, 1] = 1.0
    return m


_M2 = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
_RATE = np.random.default_rng(0).normal(0, 1.0, (4, 3)).astype(np.float32)
_RATE[:, 0] = 0.0
SETTINGS = {  # tests/test_discrete.py's runs: (W, means, rounds, seed)
    "jointly_identifiable": (np.array([[0.5, 0.5], [0.5, 0.5]]), _M2, 300, 0),
    "isolated": (np.eye(2), _M2, 300, 0),
    "rate_K": (complete_w(4), _RATE, 150, 1),
    **{f"star_center_s{s}": (star_w(4, a=0.5), _star_means(0), 25, s) for s in range(5)},
    **{f"star_edge_s{s}": (star_w(4, a=0.5), _star_means(2), 25, s) for s in range(5)},
}


def _jax_run(name):
    W, means, rounds, seed = SETTINGS[name]
    m = jnp.asarray(means)
    n, t = means.shape
    traj = jd.run_social_learning(jax.random.key(seed), jnp.asarray(W),
                                  lambda k: _sampler(k, m, 1.0, n), rounds, t)
    logliks = np.stack([np.asarray(_sampler(k, m, 1.0, n))
                        for k in jax.random.split(jax.random.key(seed), rounds)])
    return np.asarray(traj), logliks


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_run_social_learning_matches_jax_with_injected_logliks(name):
    W, means, rounds, _ = SETTINGS[name]
    want, logliks = _jax_run(name)
    got = td.run_social_learning(None, W, None, rounds, means.shape[1], device="cpu",
                                 logliks=logliks)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    wrong_idx = np.arange(1, means.shape[1])
    np.testing.assert_allclose(
        td.wrong_belief_trajectory(got, wrong_idx).numpy(),
        np.asarray(jd.wrong_belief_trajectory(jnp.asarray(want), jnp.asarray(wrong_idx))),
        rtol=1e-4, atol=1e-30)


def test_the_decay_rate_clears_half_of_K_on_the_port():
    """tests/test_discrete.py:65's check on the port's own draws: the
    tail slope of the max wrong belief is at least half of K(Theta)."""
    W, means, rounds, _ = SETTINGS["rate_K"]
    n, t = means.shape
    v = tt.stationary_distribution(W)
    I = np.zeros((n, 1, t - 1))
    for j in range(n):
        for k in range(1, t):
            I[j, 0, k - 1] = 4 * float((means[j, 0] - means[j, k]) ** 2) / 2.0
    K = tt.rate_K(v, I)
    m = torch.from_numpy(means)

    def sampler(g):
        y = m[:, 0:1] + torch.randn((n, 4), generator=g)
        return -0.5 * torch.sum((y[:, :, None] - m[:, None, :]) ** 2, dim=1)

    traj = td.run_social_learning(torch.Generator().manual_seed(1), W, sampler, rounds, t,
                                  device="cpu")
    wrong = td.wrong_belief_trajectory(traj, np.arange(1, t)).numpy()
    tail = np.arange(rounds // 3, rounds)
    valid = wrong[tail] > 1e-30
    slope = -np.polyfit(tail[valid], np.log(wrong[tail][valid]), 1)[0]
    assert slope > 0.5 * K, (slope, K)


def test_round_preserves_normalization_and_matches_jax():
    """tests/test_discrete.py:114 in the port, beside the reference."""
    logq = np.log(np.array([[0.2, 0.5, 0.3], [0.6, 0.2, 0.2]], np.float32))
    loglik = np.array(jax.random.normal(jax.random.key(0), (2, 3)))
    W = ring_w(2).astype(np.float32)
    q2, b = td.social_learning_round(torch.from_numpy(logq), torch.from_numpy(loglik),
                                     torch.from_numpy(W))
    jq2, jb = jd.social_learning_round(jnp.asarray(logq), jnp.asarray(loglik), jnp.asarray(W))
    np.testing.assert_allclose(np.exp(q2.numpy()).sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(np.exp(b.numpy()).sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(q2.numpy(), np.asarray(jq2), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)


def test_social_learning_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        td.run_social_learning(None, np.eye(2), None, 1, 2, logliks=np.zeros((1, 2, 2)))
    with pytest.raises(ValueError, match="rounds"):
        td.run_social_learning(None, np.eye(2), None, 3, 2, device="cpu",
                               logliks=np.zeros((1, 2, 2)))
