"""Assigned-architecture registry (a copy of ``repro.configs``).
``get_config(name)`` returns the full production config;
``get_config(name).reduced()`` the CPU smoke variant."""
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.registry import ARCHS, get_config, list_archs

__all__ = [
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "ARCHS",
    "get_config",
    "list_archs",
]
