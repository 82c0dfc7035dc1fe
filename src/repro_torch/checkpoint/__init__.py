"""Checkpoints in the JAX package's document format (``checkpoint.io``)."""
from repro_torch.checkpoint.io import (
    CheckpointManager,
    restore_flat_posterior,
    restore_pytree,
    restore_session,
    save_flat_posterior,
    save_pytree,
    save_session,
)

__all__ = [
    "save_pytree",
    "restore_pytree",
    "save_flat_posterior",
    "restore_flat_posterior",
    "save_session",
    "restore_session",
    "CheckpointManager",
]
