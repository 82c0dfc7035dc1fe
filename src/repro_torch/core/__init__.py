"""Core runtime: numerics, graphs, posteriors (mean-field and the
full-covariance family of paper Example 1), flat posteriors (``core.flat``),
the simulated round (``core.simulated``), and the Theorem-1 theory with its
finite-Theta learning rule (``theory``, ``discrete``).

The package exports the posterior families and the theory modules; import
``core.flat`` and ``core.simulated`` by module (they import the kernels and
``vi``, which import this package)."""
from repro_torch.core.posterior import (
    FullCovGaussian,
    GaussianPosterior,
    consensus_all_agents,
    consensus_full_cov,
    consensus_mean_field,
    consensus_mean_only,
    init_posterior,
    kl_gaussian,
    linreg_bayes_update,
)
from repro_torch.core.numerics import softplus, softplus_inv
from repro_torch.core import discrete, graphs, theory

__all__ = [
    "FullCovGaussian",
    "GaussianPosterior",
    "consensus_all_agents",
    "consensus_full_cov",
    "consensus_mean_field",
    "consensus_mean_only",
    "init_posterior",
    "kl_gaussian",
    "linreg_bayes_update",
    "softplus",
    "softplus_inv",
    "discrete",
    "graphs",
    "theory",
]
