"""Paper Example 1 / Sec 4.1: decentralized Bayesian linear regression with
extreme non-IID feature partition.

True model: y = theta*^T phi(x) + eta, eta ~ N(0, alpha^2); agent i observes
inputs along ONLY coordinate i:  x = [0,...,0, x_i, 0,...,0], x_i ~
Unif[-r_i, r_i].  Supplementary 1.3 gives theta* = [-0.3, 0.5, 0.5, 0.1, 0.2]
(d=5), alpha=0.8, ranges r = [1, 1.5, 1.25, 0.75] for the 4 agents, prior
N(0, diag 0.5).  We default to the identity basis phi(x)=x, matching the
coordinate-observation description.
"""
from __future__ import annotations

import dataclasses

import numpy as np

THETA_STAR = np.array([-0.3, 0.5, 0.5, 0.1, 0.2])
NOISE_STD = 0.8
AGENT_RANGES = np.array([1.0, 1.5, 1.25, 0.75])
PRIOR_VAR = 0.5


@dataclasses.dataclass
class LinRegTask:
    theta_star: np.ndarray  # [d]
    noise_std: float
    agent_coords: list[list[int]]  # coordinates observable by each agent
    agent_ranges: np.ndarray  # [N] uniform half-ranges
    d: int

    @property
    def n_agents(self) -> int:
        return len(self.agent_coords)

    def sample_local(
        self, rng: np.random.Generator, agent: int, n: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Draw n (phi(x), y) pairs for one agent (only its coordinates active)."""
        phi = np.zeros((n, self.d))
        for c in self.agent_coords[agent]:
            phi[:, c] = rng.uniform(-self.agent_ranges[agent], self.agent_ranges[agent], n)
        y = phi @ self.theta_star + rng.normal(0.0, self.noise_std, n)
        return phi, y

    def sample_global(
        self, rng: np.random.Generator, n: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Global test set: all coordinates active (the centralized view)."""
        phi = rng.uniform(-1.0, 1.0, (n, self.d))
        y = phi @ self.theta_star + rng.normal(0.0, self.noise_std, n)
        return phi, y


def make_linreg_task(
    d: int = 5, n_agents: int = 4, theta_star: np.ndarray | None = None
) -> LinRegTask:
    """Default = the paper's exact setup: 4 agents, d=5, each agent sees one
    coordinate (agent i -> coordinate i); coordinate d-1=4 is observed by no
    single agent alone in the paper's text, we give it to agent 3 together
    with coordinate 3 so the union covers all of R^d (Assumption 2)."""
    theta = THETA_STAR[:d] if theta_star is None else np.asarray(theta_star)
    coords: list[list[int]] = [[i] for i in range(n_agents)]
    # distribute any remaining coordinates round-robin so the union spans R^d
    for c in range(n_agents, d):
        coords[c % n_agents].append(c)
    return LinRegTask(
        theta_star=theta,
        noise_std=NOISE_STD,
        agent_coords=coords,
        agent_ranges=AGENT_RANGES[:n_agents]
        if n_agents <= len(AGENT_RANGES)
        else np.ones(n_agents),
        d=d,
    )
