"""Bayes-by-Backprop variational inference."""
from repro_torch.vi.bayes_by_backprop import (
    free_energy,
    free_energy_and_grad,
    local_vi_steps,
    mc_predict,
    predictive_confidence,
)

__all__ = [
    "free_energy",
    "free_energy_and_grad",
    "local_vi_steps",
    "mc_predict",
    "predictive_confidence",
]
