"""Core runtime: numerics, graphs, flat posteriors, the simulated round."""
