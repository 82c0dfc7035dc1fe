"""Top-k mixture-of-experts FFN with capacity-based dispatch (port of
``repro.models.moe``).

Routing: softmax router -> top-k experts per token -> capacity-limited
dispatch (assignments over an expert's capacity are dropped, Switch/GShard
semantics) -> every expert's SwiGLU over its ``[C, D]`` slots as one
batched product -> weighted combine.  Also the Switch load-balancing
auxiliary loss ``E * sum_e f_e * p_e``.

The agent axis.  Capacity is per agent: an agent's ``T = B * S`` tokens
fill ``cap = _capacity(T, E, k, capacity_factor)`` slots an expert, in the
order of its ``[T * k]`` assignments, token-major, as the reference does
for one model.  So the agent axis is never folded into the tokens (that
would change ``cap`` and which assignments drop): every step batches over
it, and the expert products are ``[A, E, C, D] @ [A, E, D, F]``.

Bits.  Top-k breaks ties towards the lower expert index, as
``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` promises no
order among ties).  Dispatch writes each kept (expert, slot) once and
combine sums a token's k contributions in assignment order, so two calls
on the same inputs give the same bits on the card too (no atomics).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.modules import truncated_normal_init


def moe_init(generator, cfg, *, dtype=torch.float32, device=None, lead=()):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "router": truncated_normal_init(generator, (d, e), 1.0, **kw),
        "w_gate": truncated_normal_init(generator, (e, d, f), 1.0, **kw),
        "w_up": truncated_normal_init(generator, (e, d, f), 1.0, **kw),
        "w_down": truncated_normal_init(generator, (e, f, d), 1.0, **kw),
    }


def route_topk(router_logits: torch.Tensor, top_k: int):
    """``[..., T, E]`` -> (weights ``[..., T, k]``, expert_idx ``[..., T, k]``,
    probs ``[..., T, E]``).  Top-k softmax weights renormalized over the
    selected experts; among equal probabilities the lower index first."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[..., :top_k], idx[..., :top_k]
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return weights, idx, probs


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss ``E * sum_e (fraction routed to e) * (mean
    prob e)`` over the token axis (``probs [..., T, E]``, ``idx [..., T, k]``);
    one value for each leading index."""
    t, k = idx.shape[-2], idx.shape[-1]
    flat = idx.reshape(tuple(idx.shape[:-2]) + (t * k,))
    counts = torch.zeros(tuple(idx.shape[:-2]) + (n_experts,), dtype=torch.float32,
                         device=idx.device)
    counts.scatter_add_(-1, flat, torch.ones(flat.shape, dtype=torch.float32,
                                             device=idx.device))  # integers: exact in any order
    frac = counts / (t * k)
    mean_prob = torch.mean(probs, dim=-2)
    return n_experts * torch.sum(frac * mean_prob, dim=-1)


def _capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(n_tokens * top_k * factor / n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, floor 8


def moe_ffn(params, x: torch.Tensor, cfg, dtype=None):
    """``x [*A, B, S, D]`` -> (y ``[*A, B, S, D]``, aux ``[*A]``).

    ``params`` leaves carry the same leading agent axes ``*A`` (none for one
    model).  For each (agent, expert, slot) the source token is computed,
    gathered, run through the expert products, and added back to its token
    with its router weight."""
    dtype = dtype or x.dtype
    lead = params["router"].ndim - 2
    a_shape = tuple(x.shape[:lead])
    n_a, d = math.prod(a_shape), x.shape[-1]
    t = x.numel() // (n_a * d)  # one agent's B * S tokens
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(t, e, k, cfg.capacity_factor)
    xt = x.reshape(n_a, t, d)
    dev = x.device

    def stacked(w):  # [*A, ...] -> [A, ...] in the compute dtype
        return w.reshape((n_a,) + tuple(w.shape[lead:])).to(dtype)

    logits = torch.matmul(xt, stacked(params["router"]))  # [A, T, E]
    weights, idx, probs = route_topk(logits, k)  # [A, T, k] x2, [A, T, E]
    aux = load_balance_loss(probs, idx, e)  # [A]

    # position of each (token, k) assignment within its expert's capacity: the
    # running count of its expert's assignments, scanned along the last axis
    expert_of = idx.reshape(n_a, t * k)
    running = torch.cumsum(F.one_hot(expert_of, e).transpose(1, 2), dim=2)  # [A, E, T*k]
    slot = torch.gather(running, 1, expert_of[:, None, :])[:, 0] - 1
    keep = slot < cap
    del running
    token_of = torch.arange(t, device=dev).repeat_interleave(k).expand(n_a, t * k)
    w_of = weights.reshape(n_a, t * k)

    # (expert, slot) -> token index + 1 (0 = empty: the zero row); every kept
    # (expert, slot) is written once; the dropped assignments write 0 into a
    # spare cell past the end
    cell = torch.where(keep, expert_of * cap + slot, e * cap)
    dispatch = torch.zeros((n_a, e * cap + 1), dtype=torch.long, device=dev)
    dispatch.scatter_(1, cell, torch.where(keep, token_of + 1, 0))
    dispatch = dispatch[:, :e * cap]
    xt_pad = torch.cat([torch.zeros((n_a, 1, d), dtype=xt.dtype, device=dev), xt], dim=1)
    x_disp = torch.gather(xt_pad, 1, dispatch[..., None].expand(n_a, e * cap, d))
    x_disp = x_disp.reshape(n_a, e, cap, d)

    # every expert's SwiGLU over its slots: [A, E, C, D] @ [A, E, D, F]
    g = torch.matmul(x_disp, stacked(params["w_gate"]))
    u = torch.matmul(x_disp, stacked(params["w_up"]))
    del x_disp
    yd = torch.matmul(F.silu(g) * u, stacked(params["w_down"])).reshape(n_a, e * cap, d)
    del g, u

    # combine: each token's k contributions, summed in assignment order
    src = torch.where(keep, expert_of * cap + slot, 0)
    gathered = torch.gather(yd, 1, src[..., None].expand(n_a, t * k, d))
    contrib = torch.where(keep[..., None], gathered.float() * w_of[..., None], 0.0)
    contrib = contrib.reshape(n_a, t, k, d)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    return out.to(dtype).reshape(x.shape), aux.reshape(a_shape)
