"""Model registry for the declarative API (port of ``repro.api.models``).

The paper's NN experiments use a small ReLU MLP trained with
Bayes-by-Backprop (Sec 4.2: 2 hidden layers, 200 units on MNIST).  The
registry maps ``InferenceSpec.model`` names to a ``ModelFns`` triple; the
input/output dimensions come from the ``DataSpec`` at ``build_session`` time.

The apply functions are batched over the agent axis: parameters are dicts
of ``[N, fan_in, fan_out]`` / ``[N, fan_out]`` tensors (views of the flat
``[N, P]`` theta, ``core.flat.make_flat_nll``), inputs ``[N, B, dim]``, and
each layer is one ``torch.bmm`` over the agents.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ModelFns:
    """(init, logits, nll) for one model family at fixed dimensions."""

    init_fn: Callable[..., PyTree]
    logits_fn: Callable[[PyTree, torch.Tensor], torch.Tensor]
    nll_fn: Callable[[PyTree, Any], torch.Tensor]


def mlp_init(dim: int, hidden: int, n_classes: int, depth: int = 2):
    """``depth``-hidden-layer ReLU MLP, 1/sqrt(fan_in) init.  ``init(generator,
    device)`` draws one agent's parameter dict from ``generator``."""

    sizes = [dim] + [hidden] * depth + [n_classes]

    def init(generator: torch.Generator | None = None, device=None):
        params = {}
        for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:]), 1):
            params[f"w{i}"] = torch.randn(
                (fan_in, fan_out), generator=generator, device=device
            ) / math.sqrt(fan_in)
            params[f"b{i}"] = torch.zeros((fan_out,), device=device)
        return params

    return init


def mlp_logits(theta: PyTree, x: torch.Tensor) -> torch.Tensor:
    """theta leaves [N, ...], x [N, B, dim] -> logits [N, B, n_classes]."""
    n_layers = len(theta) // 2
    h = x
    for i in range(1, n_layers):
        h = torch.relu(torch.bmm(h, theta[f"w{i}"]) + theta[f"b{i}"].unsqueeze(1))
    return torch.bmm(h, theta[f"w{n_layers}"]) + theta[f"b{n_layers}"].unsqueeze(1)


def mlp_nll(theta: PyTree, batch: dict) -> torch.Tensor:
    """Per-agent total (summed) softmax cross-entropy over the batch: [N]."""
    logits = mlp_logits(theta, batch["x"])
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"].long().unsqueeze(-1)).squeeze(-1)
    return torch.sum(logz - gold, dim=-1)


def _build_mlp(dim: int, n_classes: int, hidden: int, depth: int) -> ModelFns:
    return ModelFns(
        init_fn=mlp_init(dim, hidden, n_classes, depth=depth),
        logits_fn=mlp_logits,
        nll_fn=mlp_nll,
    )


MODELS: dict[str, Callable[..., ModelFns]] = {
    "mlp": _build_mlp,
}


def build_model(name: str, dim: int, n_classes: int, *, hidden: int, depth: int) -> ModelFns:
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; known: {sorted(MODELS)}")
    return MODELS[name](dim, n_classes, hidden=hidden, depth=depth)
