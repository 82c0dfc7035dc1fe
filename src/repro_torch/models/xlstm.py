"""xLSTM blocks (port of ``repro.models.xlstm``; Beck et al.,
arXiv:2405.04517): mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential scan).

mLSTM recurrence (per head, stabilized):
    m_t = max(logsig(f_t) + m_{t-1}, i_t)
    C_t = exp(logsig(f_t)+m_{t-1}-m_t) C_{t-1} + exp(i_t - m_t) k_t v_t^T
    n_t = exp(logsig(f_t)+m_{t-1}-m_t) n_{t-1} + exp(i_t - m_t) k_t
    h_t = C_t^T q_t / max(|n_t^T q_t|, exp(-m_t))
The stored state (C, n) is the stabilized one: C_stored = C_true * exp(-m).

The mLSTM runs chunkwise, as the reference does: a loop over chunks of
``chunk_size`` carrying (C, n, m); within a chunk the intra-chunk term is a
masked product and the inter-chunk term one ``[c, hd] @ [hd, hd]`` product
a head (heads-first, so each is one batched product).  The last chunk is
padded with i = -1e30 (no input) and f = 40 (the carry decays by 1), so an
S that is not a multiple of the chunk, and decode (S = 1, c = 1), give the
reference's state.  The intra-chunk decay is masked before its exp, where
the reference masks after it: the values are the same, but above the
diagonal the exponent can overflow, and there the reference's gradient
is 0 * inf = NaN (a 256-token chunk of reduced xLSTM trains to NaN in the
reference; the port's gradient stays finite).  The sLSTM is a true
recurrence: one step at a time, its four per-head recurrent products
stacked into one ``[H, hd, 4 hd]`` product a step.  Gates and states in fp32, whatever the compute dtype; leading axes
``[*A, B]`` (agents, batch) fold into the batch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.modules import matmul, rmsnorm, rmsnorm_init, truncated_normal_init

NEG_INIT = -1e30  # the stabiliser's start, and the padded steps' input gate
F_PAD = 40.0  # the padded steps' forget gate: logsig(40) ~ 0


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(generator, cfg, *, dtype=torch.float32, device=None, lead=()):
    d = cfg.d_model
    p = 2 * d  # projection factor 2 (xLSTM paper)
    h = cfg.n_heads
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "norm": rmsnorm_init(d, **kw),
        "w_up": truncated_normal_init(generator, (d, p), 1.0, **kw),
        "w_gate": truncated_normal_init(generator, (d, p), 1.0, **kw),
        "wq": truncated_normal_init(generator, (p, p), 1.0, **kw),
        "wk": truncated_normal_init(generator, (p, p), 1.0, **kw),
        "wv": truncated_normal_init(generator, (p, p), 1.0, **kw),
        "w_i": truncated_normal_init(generator, (p, h), 1.0, **kw),
        "w_f": truncated_normal_init(generator, (p, h), 1.0, **kw),
        "w_down": truncated_normal_init(generator, (p, d), 1.0, **kw),
        "out_norm": rmsnorm_init(p, **kw),
    }


def mlstm_state_init(cfg, batch: int, dtype=torch.float32, device=None, lead=()):
    p = 2 * cfg.d_model
    h = cfg.n_heads
    hd = p // h
    lead = tuple(lead) + (batch,)
    return {
        "C": torch.zeros(lead + (h, hd, hd), dtype=dtype, device=device),
        "n": torch.zeros(lead + (h, hd), dtype=dtype, device=device),
        "m": torch.full(lead + (h,), NEG_INIT, dtype=dtype, device=device),
    }


def mlstm_scan(q, k, v, i_gate, f_gate, state, chunk_size: int = 256):
    """Chunkwise stabilized mLSTM.

    ``q, k [*L, S, H, hd]`` (k pre-scaled by hd^-0.5 by the caller), ``v
    [*L, S, H, hv]`` (``hv`` = hd, or a block of the value columns: the
    placed schedule's); ``i_gate, f_gate [*L, S, H]`` raw (pre-activation)
    gates; ``state`` dict(C ``[*L, H, hd, hv]``, n ``[*L, H, hd]``, m
    ``[*L, H]``), the stabilized carry.  Returns (h ``[*L, S, H, hv]`` in
    ``q.dtype``, the new state in fp32)."""
    lead = tuple(q.shape[:-3])
    s, h, hd = q.shape[-3:]
    hv = v.shape[-1]
    c = min(chunk_size, s)
    n_chunks = -(-s // c)
    pad = n_chunks * c - s
    q, k = (t.reshape((-1, s, h, hd)) for t in (q, k))
    v = v.reshape((-1, s, h, hv))
    i_gate, f_gate = (t.reshape((-1, s, h)) for t in (i_gate, f_gate))
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_gate = F.pad(i_gate, (0, 0, 0, pad), value=NEG_INIT)
        f_gate = F.pad(f_gate, (0, 0, 0, pad), value=F_PAD)

    def heads_first(t):  # [b, S', H, ...] -> fp32 [b, H, S', ...]
        return t.float().transpose(1, 2)

    qh, kh, vh, ih, fh = (heads_first(t) for t in (q, k, v, i_gate, f_gate))
    C0 = state["C"].reshape((-1, h, hd, hv)).float()
    n0 = state["n"].reshape((-1, h, hd)).float()
    m0 = state["m"].reshape((-1, h)).float()
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    outs = []
    for j in range(n_chunks):
        cs = slice(j * c, (j + 1) * c)
        qj, kj, vj, ij = qh[:, :, cs], kh[:, :, cs], vh[:, :, cs], ih[:, :, cs]
        logf = F.logsigmoid(fh[:, :, cs])  # [b, H, c]
        bcum = torch.cumsum(logf, dim=-1)  # b_j
        a = bcum + m0[..., None]  # carry-decay log
        itb = ij - bcum  # i_l - b_l
        local_max = torch.cummax(itb, dim=-1).values
        m = torch.maximum(a, bcum + local_max)  # m_j

        # intra-chunk: D[j, l] = exp(b_j - b_l + i_l - m_j) for l <= j.  Masked
        # before the exp: above the diagonal logd can overflow exp, and the
        # gradient of exp there (0 * inf) would be NaN; the values are the same
        logd = (bcum - m)[..., :, None] + itb[..., None, :]  # [b, H, j, l]
        dmat = torch.exp(torch.where(mask, logd, float("-inf")))
        scores = torch.matmul(qj, kj.transpose(-1, -2)) * dmat
        h_intra = torch.matmul(scores, vj)
        n_intra = torch.matmul(dmat, kj)

        # inter-chunk: exp(a_j - m_j) * (q_j @ C0)
        w_inter = torch.exp(a - m)[..., None]  # [b, H, c, 1]
        h_inter = torch.matmul(qj, C0) * w_inter
        n_inter = n0[:, :, None, :] * w_inter

        num = h_intra + h_inter
        nvec = n_intra + n_inter
        qn = torch.sum(qj * nvec, dim=-1)
        denom = torch.maximum(torch.abs(qn), torch.exp(-m))
        outs.append(num / denom[..., None])

        # carry update (at j = c - 1)
        m_end = m[..., -1]  # [b, H]
        w_carry = torch.exp(a[..., -1] - m_end)  # decay of the old carry
        w_kv = torch.exp((bcum[..., -1:] - bcum) + ij - m_end[..., None])[..., None]
        C0 = C0 * w_carry[..., None, None] + torch.matmul((w_kv * kj).transpose(-1, -2), vj)
        n0 = n0 * w_carry[..., None] + torch.sum(w_kv * kj, dim=-2)
        m0 = m_end
    out = torch.cat(outs, dim=2)[:, :, :s].transpose(1, 2)  # [b, S, H, hv]
    new = {"C": C0.reshape(lead + (h, hd, hv)), "n": n0.reshape(lead + (h, hd)),
           "m": m0.reshape(lead + (h,))}
    return out.to(q.dtype).reshape(lead + (s, h, hv)), new


def mlstm_block(params, x, cfg, state=None, chunk_size: int = 256):
    """Full mLSTM residual block.  ``x [*A, B, S, D]``.  Returns (y, new_state)."""
    s, d = x.shape[-2:]
    dt = x.dtype
    h = cfg.n_heads
    p = 2 * d
    hd = p // h
    rows = tuple(x.shape[:-1])

    def heads(t):
        return t.reshape(rows + (h, hd))

    xin = rmsnorm(params["norm"], x, cfg.norm_eps)
    up = matmul(xin, params["w_up"].to(dt))  # [..., S, p]
    gate = F.silu(matmul(xin, params["w_gate"].to(dt)))
    q = heads(matmul(up, params["wq"].to(dt)))
    # the reference divides by sqrt(hd) rounded to the compute dtype
    k = heads(matmul(up, params["wk"].to(dt))) / torch.tensor(
        math.sqrt(hd), dtype=torch.float32, device=x.device).to(dt)
    v = heads(matmul(up, params["wv"].to(dt)))
    ig = matmul(up, params["w_i"].to(dt))  # [..., S, H]
    fg = matmul(up, params["w_f"].to(dt))
    if state is None:
        state = mlstm_state_init(cfg, x.shape[-3], device=x.device, lead=tuple(x.shape[:-3]))
    hseq, new_state = mlstm_scan(q, k, v, ig, fg, state, chunk_size)
    hseq = rmsnorm(params["out_norm"], hseq.reshape(rows + (p,)), cfg.norm_eps)
    y = matmul(hseq * gate, params["w_down"].to(dt))
    return x + y, new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(generator, cfg, *, dtype=torch.float32, device=None, lead=()):
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {"norm": rmsnorm_init(d, **kw)}
    for name in ("w_z", "w_i", "w_f", "w_o"):  # input projections for z, i, f, o
        p[name] = truncated_normal_init(generator, (d, d), 1.0, **kw)
    for name in ("r_z", "r_i", "r_f", "r_o"):  # block-diagonal (per-head) recurrent matrices
        p[name] = truncated_normal_init(generator, (h, hd, hd), 1.0, **kw)
    p["w_down"] = truncated_normal_init(generator, (d, d), 1.0, **kw)
    p["out_norm"] = rmsnorm_init(d, **kw)
    return p


def slstm_state_init(cfg, batch: int, dtype=torch.float32, device=None, lead=()):
    shape = tuple(lead) + (batch, cfg.d_model)
    return {
        "c": torch.zeros(shape, dtype=dtype, device=device),
        "n": torch.zeros(shape, dtype=dtype, device=device),
        "h": torch.zeros(shape, dtype=dtype, device=device),
        "m": torch.full(shape, NEG_INIT, dtype=dtype, device=device),
    }


def slstm_scan(params, xz, xi, xf, xo, state, n_heads):
    """Sequential sLSTM over time (a true recurrence: not parallelizable).

    ``xz..xo [*A, B, S, D]`` pre-activation input contributions; ``params``'
    ``r_*`` ``[*A, H, hd, hd]`` (the same leading agent axes, or none);
    ``state`` dict(c, n, h, m ``[*A, B, D]``).  Returns (h ``[*A, B, S, D]``
    fp32, the new state).  A step is one product for the four gates'
    recurrent terms, ``[*A, H, B, hd] @ [*A, H, hd, 4 hd]``, and one add of
    the inputs laid out to match it (``[*A, B, S, H, 4 hd]``)."""
    n_agent = params["r_z"].ndim - 3
    hd = params["r_z"].shape[-1]
    rec = torch.cat([params[f"r_{g}"].float() for g in "zifo"], dim=-1)  # [*A, H, hd, 4 hd]
    rows = tuple(state["h"].shape[:-1])  # [*A, B]
    heads = rows + (n_heads, hd)
    s = xz.shape[-2]
    x_all = torch.cat([t.float().reshape(rows + (s, n_heads, hd)) for t in (xz, xi, xf, xo)],
                      dim=-1)  # [*A, B, S, H, 4 hd]
    split = rows[:n_agent] + (-1, n_heads, hd)
    c, n, h, m = (state[k].reshape(heads) for k in "cnhm")
    hs = []
    for t in range(s):
        rec_t = torch.matmul(h.reshape(split).transpose(-2, -3), rec).transpose(-2, -3)
        pre = x_all[..., t, :, :] + rec_t.reshape(heads[:-1] + (4 * hd,))
        z = torch.tanh(pre[..., :hd])
        i_raw = pre[..., hd:2 * hd]
        logf = F.logsigmoid(pre[..., 2 * hd:3 * hd])
        o = torch.sigmoid(pre[..., 3 * hd:])
        m_new = torch.maximum(logf + m, i_raw)
        i_s = torch.exp(i_raw - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * z
        n = f_s * n + i_s
        h = o * c / torch.maximum(n, torch.exp(-m_new))
        m = m_new
        hs.append(h)
    flat = rows + (n_heads * hd,)
    return (torch.stack(hs, dim=-3).reshape(rows + (s, n_heads * hd)),
            {"c": c.reshape(flat), "n": n.reshape(flat), "h": h.reshape(flat),
             "m": m.reshape(flat)})


def slstm_block(params, x, cfg, state=None):
    """Full sLSTM residual block.  ``x [*A, B, S, D]``.  Returns (y, new_state)."""
    dt = x.dtype
    xin = rmsnorm(params["norm"], x, cfg.norm_eps)
    xz, xi, xf, xo = (matmul(xin, params[name].to(dt)) for name in ("w_z", "w_i", "w_f", "w_o"))
    if state is None:
        state = slstm_state_init(cfg, x.shape[-3], device=x.device, lead=tuple(x.shape[:-3]))
    hseq, new_state = slstm_scan(params, xz, xi, xf, xo, state, cfg.n_heads)
    hseq = rmsnorm(params["out_norm"], hseq.to(dt), cfg.norm_eps)
    y = matmul(hseq, params["w_down"].to(dt))
    return x + y, new_state
