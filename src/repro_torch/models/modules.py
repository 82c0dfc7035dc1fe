"""Basic neural modules (port of ``repro.models.modules``): functional,
dict-of-tensors params.

All weights are drawn in float32 (the Bayesian posterior needs fp32 means
and rhos) and cast to the compute dtype inside ``apply``.  Initializers take
an explicit ``torch.Generator`` and draw on ``device``; ``lead`` prepends
axes to every leaf (the transformer's ``[n_periods, c_kind]`` stacks), each
entry an independent draw with the same fan-in.  ``dtype`` casts each leaf
right after its draw, so a bf16 tree never holds its f32 draws at once.

The agent axis.  Where the reference ``jax.vmap``s over agents, the port
carries them as leading axes: a weight ``w [*A, D, F]`` applies to
``x [*A, ..., D]`` with the same leading ``*A`` (``matmul``), and a vector
``[*A, D]`` broadcasts over the axes in between (``per_agent``).  A tree
without agent axes is one agent's, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

PyTree = Any


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [*A, ..., D] @ w [*A, D, F] -> [*A, ..., F]``: the leading
    ``w.ndim - 2`` axes of ``w`` are agents, matched to the leading axes of
    ``x``; the axes in between fold into rows, so one batched product serves
    every agent and no weight is copied."""
    lead = w.ndim - 2
    if lead == 0:
        return x @ w
    rows = x.reshape(tuple(x.shape[:lead]) + (-1, x.shape[-1]))
    return torch.matmul(rows, w).reshape(tuple(x.shape[:-1]) + (w.shape[-1],))


def per_agent(v: torch.Tensor, x: torch.Tensor, tail: int = 1) -> torch.Tensor:
    """``v [*A, *T]`` (``tail`` trailing axes T) reshaped to broadcast
    against ``x [*A, ..., *T]``."""
    lead = v.ndim - tail
    return v.reshape(tuple(v.shape[:lead]) + (1,) * (x.ndim - v.ndim) + tuple(v.shape[lead:]))


def truncated_normal_init(generator, shape, scale, dtype=torch.float32, device=None,
                          lead=()):
    """``scale / sqrt(fan_in)`` times a standard normal truncated to
    [-2, 2]; ``fan_in`` is ``shape[-2]`` (``shape[-1]`` for a vector)."""
    shape = tuple(shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    t = torch.empty(tuple(lead) + shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale / math.sqrt(fan_in)).to(dtype)


def linear_init(generator, d_in: int, d_out: int, dtype=torch.float32, device=None, lead=()):
    return {"w": truncated_normal_init(generator, (d_in, d_out), 1.0, dtype, device, lead)}


def linear(params, x, dtype):
    return matmul(x, params["w"].to(dtype))


def embed_init(generator, vocab: int, d_model: int, dtype=torch.float32, device=None, lead=()):
    emb = torch.randn(tuple(lead) + (vocab, d_model), generator=generator, device=device)
    return {"emb": emb.mul_(0.02).to(dtype)}


def embed(params, tokens, dtype):
    """Rows of ``emb [*A, V, D]`` for ``tokens [*A, ...]`` (gathered, then
    cast: the same values as the reference's cast-then-gather)."""
    emb = params["emb"]
    if emb.ndim == 2:
        return emb[tokens].to(dtype)
    if emb.ndim != 3:
        raise ValueError(f"embed: emb of shape {tuple(emb.shape)}: one agent axis at most")
    a = emb.shape[0]
    rows = torch.arange(a, device=emb.device).reshape((a,) + (1,) * (tokens.ndim - 1))
    return emb[rows, tokens].to(dtype)


def unembed(params, x, dtype):
    """Tied unembedding: logits in fp32 for a stable softmax-xent."""
    return matmul(x, params["emb"].to(dtype).transpose(-1, -2)).float()


def rmsnorm_init(d: int, dtype=torch.float32, device=None, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * per_agent(params["scale"].float(), x32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding.  x: [..., S, H, hd]; positions: [S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].to(device=x.device, dtype=torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]  # [S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_init(generator, d_model: int, d_ff: int, dtype=torch.float32, device=None, lead=()):
    return {
        "w_gate": truncated_normal_init(generator, (d_model, d_ff), 1.0, dtype, device, lead),
        "w_up": truncated_normal_init(generator, (d_model, d_ff), 1.0, dtype, device, lead),
        "w_down": truncated_normal_init(generator, (d_ff, d_model), 1.0, dtype, device, lead),
    }


def swiglu(params, x, dtype):
    g = matmul(x, params["w_gate"].to(dtype))
    u = matmul(x, params["w_up"].to(dtype))
    return matmul(F.silu(g) * u, params["w_down"].to(dtype))


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Total (summed) cross-entropy; logits [..., V], targets [...] int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.sum(logz - gold)
