"""Architecture registry: ``--arch <id>`` -> ModelConfig."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import (
    deepseek_7b,
    granite_20b,
    mistral_nemo_12b,
    olmoe_1b_7b,
    phi35_moe_42b_a6_6b,
    pixtral_12b,
    qwen3_8b,
    recurrentgemma_9b,
    whisper_tiny,
    xlstm_1_3b,
)
from repro_torch.configs.paper_models import REPRO_100M

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        olmoe_1b_7b.CONFIG,
        phi35_moe_42b_a6_6b.CONFIG,
        qwen3_8b.CONFIG,
        granite_20b.CONFIG,
        xlstm_1_3b.CONFIG,
        recurrentgemma_9b.CONFIG,
        whisper_tiny.CONFIG,
        pixtral_12b.CONFIG,
        mistral_nemo_12b.CONFIG,
        deepseek_7b.CONFIG,
        REPRO_100M,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    cfg = ARCHS[name]
    cfg.validate()
    return cfg


def list_archs() -> list[str]:
    return sorted(ARCHS)
