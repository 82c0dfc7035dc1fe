"""Learning-rate schedules (port of ``repro.optim.schedules``).  The paper
uses Adam with initial lr 1e-3 and a multiplicative decay of 0.99 per
communication round — ``exponential_decay(1e-3, 0.99)``.  A schedule maps a
step tensor to a float32 tensor on the step's device."""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def constant_schedule(lr: float) -> Schedule:
    return lambda step: _f32(lr, step)


def exponential_decay(lr: float, decay: float) -> Schedule:
    """lr * decay^step (step = communication round in the paper)."""
    return lambda step: _f32(lr, step) * _f32(decay, step) ** step.to(torch.float32)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.0) -> Schedule:
    def fn(step):
        frac = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return lr * (final_frac + (1.0 - final_frac) * cos)

    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    cosine = cosine_schedule(lr, max(total_steps - warmup_steps, 1))

    def fn(step):
        step_f = step.to(torch.float32)
        warm = lr * step_f / max(warmup_steps, 1)
        return torch.where(step_f < warmup_steps, warm, cosine(step - warmup_steps))

    return fn
