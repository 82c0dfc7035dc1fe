"""Bayes-by-Backprop variational inference."""
