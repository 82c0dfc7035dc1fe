"""Per-leaf norms of a run's state: the program's flat ``[N, P]`` buffers
cut by the program's own layout, and the reference's per-leaf tensors,
summed in float64."""
from __future__ import annotations

import re

import torch


def leaf_name(path: str) -> str:
    """``"['stacks']['attn']['wq']"`` -> ``"stacks.attn.wq"``."""
    return ".".join(re.findall(r"\['([^']*)'\]", path))


def sq_norm(x: torch.Tensor, minus: torch.Tensor | None = None, block: int = 256) -> float:
    """Sum of squares of a 2-D tensor (less the row ``minus``) in float64,
    ``block`` rows at a time."""
    total = 0.0
    for s in range(0, x.shape[0], block):
        rows = x[s:s + block] if minus is None else x[s:s + block] - minus
        total += float(torch.sum(torch.square(rows.double())))
    return total


def flat_leaf_norms(buf: torch.Tensor, specs, prefix: str, minus: dict | None = None) -> dict:
    """Per-leaf l2 norms over all agents of a flat ``[N, P]`` buffer of the
    program, leaves by its layout's column spans; ``minus`` (leaf -> [size]
    row) is subtracted first."""
    out = {}
    for spec in specs:
        name = leaf_name(spec.path)
        cols = buf[:, spec.offset:spec.offset + spec.size]
        row = None if minus is None else minus[name].reshape(1, -1).to(cols.dtype)
        out[f"{prefix}.{name}"] = sq_norm(cols, row) ** 0.5
    return out


def dict_leaf_norms(leaves: dict, prefix: str, minus: dict | None = None) -> dict:
    """Per-leaf l2 norms over all agents of ``[N, ...]`` tensors."""
    return {f"{prefix}.{k}": sq_norm(v.reshape(v.shape[0], -1),
                                     None if minus is None else minus[k].reshape(1, -1)) ** 0.5
            for k, v in leaves.items()}
