"""RecurrentGemma / Griffin recurrent block (port of ``repro.models.rglru``;
De et al., arXiv:2402.19427).

RG-LRU recurrence (diagonal, real-valued):
    r_t = sigmoid(W_r x_t)                    (recurrence gate)
    i_t = sigmoid(W_i x_t)                    (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)    (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The diagonal linear recurrence is a scan over pairs ``(a, b)`` with the
operator ``(a2 a1, a2 b1 + b2)``; where the reference calls
``lax.associative_scan`` the port doubles the offset (log2 S passes of
elementwise products over the whole sequence).  h0 rides as a pseudo-step
with a = 0, as in the reference; decode (S = 1) is the one step.  The block
is the Griffin recurrent block: linear in, a width-4 causal conv1d, the
RG-LRU, gated by a GeLU branch (tanh form: ``jax.nn.gelu``'s default),
linear out.  Gates and states in fp32; states ``[*A, B, D]`` and
``[*A, B, 3, D]`` stay fp32 whatever the compute dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.numerics import softplus
from repro_torch.models.modules import matmul, per_agent, rmsnorm, rmsnorm_init, \
    truncated_normal_init

_C = 8.0
CONV_WIDTH = 4


def rglru_init(generator, cfg, *, dtype=torch.float32, device=None, lead=()):
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device, lead=lead)
    # Lambda so that a ~ Unif[0.9, 0.999]^(1/(c*0.5)) territory (paper App.)
    lam = 0.9 + 0.099 * torch.rand(tuple(lead) + (d,), generator=generator, device=device)
    lam_raw = torch.log(torch.expm1(-torch.log(lam) / (_C * 0.5)))  # softplus^-1
    return {
        "norm": rmsnorm_init(d, **kw),
        "w_in": truncated_normal_init(generator, (d, d), 1.0, **kw),
        "w_gate": truncated_normal_init(generator, (d, d), 1.0, **kw),
        "conv_w": truncated_normal_init(generator, (CONV_WIDTH, d), 1.0, **kw),
        "conv_b": torch.zeros(tuple(lead) + (d,), dtype=dtype, device=device),
        "w_r": truncated_normal_init(generator, (d, d), 1.0, **kw),
        "w_i": truncated_normal_init(generator, (d, d), 1.0, **kw),
        "lam_raw": lam_raw.to(dtype),
        "w_out": truncated_normal_init(generator, (d, d), 1.0, **kw),
    }


def rglru_state_init(cfg, batch: int, dtype=torch.float32, device=None, lead=()):
    d, lead = cfg.d_model, tuple(lead)
    return {
        "h": torch.zeros(lead + (batch, d), dtype=dtype, device=device),
        "conv": torch.zeros(lead + (batch, CONV_WIDTH - 1, d), dtype=dtype,
                            device=device),  # the last w-1 inputs
    }


def causal_conv1d(x, w, b, history=None):
    """Depthwise causal conv, width W.  ``x [*A, B, S, D]``; ``w [*A, W, D]``,
    ``b [*A, D]`` (the same leading agent axes, or none).

    ``history``: ``[*A, B, W-1, D]`` inputs preceding x (decode), else
    zeros.  Returns (out, the last W-1 inputs) in ``x.dtype``."""
    s = x.shape[-2]
    if history is None:
        history = torch.zeros(tuple(x.shape[:-2]) + (CONV_WIDTH - 1, x.shape[-1]),
                              dtype=x.dtype, device=x.device)
    xx = torch.cat([history.to(x.dtype), x], dim=-2)  # [..., S+W-1, D]
    out = torch.zeros_like(x)
    for i in range(CONV_WIDTH):
        out = out + xx[..., i:i + s, :] * per_agent(w[..., i, :].to(x.dtype), x)
    return out + per_agent(b.to(x.dtype), x), xx[..., -(CONV_WIDTH - 1):, :]


def rglru_scan(x, r, i, lam_raw, h0):
    """The RG-LRU over ``x, r, i [*A, B, S, D]`` from ``h0 [*A, B, D]``;
    ``lam_raw [*A, D]``.  Returns (h ``[*A, B, S, D]``, final state), fp32."""
    sp = per_agent(softplus(lam_raw).float(), r)
    a = torch.exp(-_C * sp * r.float())
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-12)) * (i.float() * x.float())
    # h0 as a pseudo-step with a = 0, then the scan by doubling offsets
    a_all = torch.cat([torch.zeros_like(a[..., :1, :]), a], dim=-2)
    b_all = torch.cat([h0[..., None, :].float(), gated], dim=-2)
    n, off = a_all.shape[-2], 1
    if torch.is_grad_enabled() and (a_all.requires_grad or b_all.requires_grad):
        while off < n:  # the same passes, joined by ``cat``: ``out=`` records no gradient
            b_all = torch.cat([b_all[..., :off, :], torch.addcmul(
                b_all[..., off:, :], a_all[..., off:, :], b_all[..., :-off, :])], dim=-2)
            if 2 * off < n:
                a_all = torch.cat([a_all[..., :off, :],
                                   a_all[..., off:, :] * a_all[..., :-off, :]], dim=-2)
            off *= 2
        return b_all[..., 1:, :], b_all[..., -1, :]
    while off < n:  # each pass writes a new buffer: its head copied, its tail combined
        b_new = torch.empty_like(b_all)
        b_new[..., :off, :] = b_all[..., :off, :]
        torch.addcmul(b_all[..., off:, :], a_all[..., off:, :], b_all[..., :-off, :],
                      out=b_new[..., off:, :])
        if 2 * off < n:
            a_new = torch.empty_like(a_all)
            a_new[..., :off, :] = a_all[..., :off, :]
            torch.mul(a_all[..., off:, :], a_all[..., :-off, :], out=a_new[..., off:, :])
            a_all = a_new
        b_all = b_new
        off *= 2
    return b_all[..., 1:, :], b_all[..., -1, :]


def rglru_block(params, x, cfg, state=None):
    """Griffin recurrent block.  ``x [*A, B, S, D]`` -> (y, new_state)."""
    dt = x.dtype
    xin = rmsnorm(params["norm"], x, cfg.norm_eps)
    branch = matmul(xin, params["w_in"].to(dt))
    gate = F.gelu(matmul(xin, params["w_gate"].to(dt)), approximate="tanh")
    if state is None:
        state = rglru_state_init(cfg, x.shape[-3], device=x.device,
                                 lead=tuple(x.shape[:-3]))
    conv_out, new_hist = causal_conv1d(branch, params["conv_w"], params["conv_b"],
                                       state["conv"])
    r = torch.sigmoid(matmul(conv_out, params["w_r"].to(dt)))
    ig = torch.sigmoid(matmul(conv_out, params["w_i"].to(dt)))
    hs, h_last = rglru_scan(conv_out, r, ig, params["lam_raw"], state["h"])
    y = matmul(hs.to(dt) * gate, params["w_out"].to(dt))
    return x + y, {"h": h_last, "conv": new_hist}
