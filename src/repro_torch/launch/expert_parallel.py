"""Expert-parallel MoE FFN with an explicit all-to-all (port of
``repro.launch.expert_parallel``).

The baseline MoE (``models.moe.moe_ffn``) runs every expert on one device.
This is the explicit schedule production MoE systems use, over a
``launch.mesh.Mesh`` with ``data`` and an expert axis (``model``):

  tokens split over (data x model)  ->  route locally  ->  per-destination-
  shard capacity buffers  ->  ALL_TO_ALL over ``model``  ->  the shard's
  E/m local experts on what it received  ->  ALL_TO_ALL back  ->  weighted
  combine.

Wire bytes a shard and direction: (m - 1) x cap x d elements of the
activations' dtype (cap = ``_capacity(T_dev, m, k, capacity_factor)``, a
destination shard's slots), independent of E.

One process drives every shard (single controller, as the reference's
``shard_map``).  Shard (i, j) of the ``("data", model)`` grid holds token
block ``i * m + j`` of the flattened ``[B * S, D]`` tokens and experts
``[j E/m, (j + 1) E/m)``, on the device of that mesh position (repeats
allowed: virtual shards run one after another; an abstract mesh runs every
shard on the input's device).  An all-to-all is ``Tensor.copy_`` of each
cross-shard block into the receiver's buffer, counted in ``ep_counts()``
with its bytes (a shard's own block is placed, not sent).  Unlike the
reference, the metadata is not sent back: the source shard keeps its own.

Bits.  Routing is ``models.moe.route_topk`` (ties to the lower expert) and
a slot is the running count of the assignment's destination shard, as the
reference's.  Each local expert runs once on the rows it received, gathered
in slot order (a gather and a product per expert where the reference takes
a one-hot einsum over all local experts: the same values up to float32
sums in another order), and a token's k contributions are summed in
assignment order in float32: no atomics, so two calls give the same bits
on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.moe import _capacity, load_balance_loss, route_topk

_moved = {"all_to_all": 0, "copies": 0, "bytes": 0, "meta_bytes": 0, "kept": 0, "dropped": 0}


def ep_counts() -> dict[str, int]:
    """All-to-alls, cross-shard block copies, their activation and
    metadata bytes, and the (token, expert) assignments kept and dropped
    since the last ``reset_ep_counts``."""
    return dict(_moved)


def reset_ep_counts() -> None:
    for k in _moved:
        _moved[k] = 0


def _dispatch_to_buffers(x, expert_of, w_of, keep, n_dst, cap, experts_per_dst):
    """Build ``[n_dst, cap, ...]`` send buffers from flat assignments.

    Returns (x_buf ``[n_dst, cap, d]``, meta_buf ``[n_dst, cap, 3]``) where
    meta = (source flat-assignment index + 1, local expert id, weight); an
    assignment past its destination's capacity (or not ``keep``) is dropped
    and its cells stay 0."""
    t_k, d = expert_of.shape[0], x.shape[-1]
    dev = x.device
    dst = torch.div(expert_of, experts_per_dst, rounding_mode="floor")
    local_e = expert_of % experts_per_dst
    # slot within (dst): running count of prior assignments to the same dst
    running = torch.cumsum(F.one_hot(dst, n_dst).T, dim=1)  # [n_dst, T*k]
    slot = torch.gather(running, 0, dst[None, :])[0] - 1
    del running
    ok = keep & (slot < cap)
    cell = torch.where(ok, dst * cap + slot, n_dst * cap)  # dropped: a spare cell
    x_buf = torch.zeros((n_dst * cap + 1, d), dtype=x.dtype, device=dev)
    x_buf.index_copy_(0, cell, torch.where(ok[:, None], x, 0))
    src_idx = torch.arange(t_k, dtype=torch.float32, device=dev) + 1.0
    meta = torch.stack([src_idx, local_e.to(torch.float32), w_of.to(torch.float32)], dim=-1)
    meta_buf = torch.zeros((n_dst * cap + 1, 3), dtype=torch.float32, device=dev)
    meta_buf.index_copy_(0, cell, torch.where(ok[:, None], meta, 0.0))
    return (x_buf[:-1].reshape(n_dst, cap, d), meta_buf[:-1].reshape(n_dst, cap, 3))


def _route(xt, w_router, cfg, m, e_loc, cap):
    """One shard's routing and send buffers: (x_buf, meta, aux)."""
    t_dev, k = xt.shape[0], cfg.top_k
    logits = xt @ w_router.to(xt.dtype)
    weights, idx, probs = route_topk(logits, k)
    aux = load_balance_loss(probs, idx, cfg.n_experts)
    expert_of = idx.reshape(-1)
    token_of = torch.arange(t_dev, device=xt.device).repeat_interleave(k)
    keep = torch.ones_like(expert_of, dtype=torch.bool)
    x_buf, meta = _dispatch_to_buffers(xt[token_of], expert_of, weights.reshape(-1), keep, m,
                                       cap, e_loc)
    return x_buf, meta, aux


def _experts(xr, meta, w_gate, w_up, w_down, e_loc):
    """The shard's local experts on its received ``[m * cap, d]`` rows:
    each expert's SwiGLU on the rows addressed to it (valid rows only), the
    other rows 0."""
    local_e = meta[:, 1].to(torch.long)
    valid = meta[:, 0] > 0
    order = torch.argsort(torch.where(valid, local_e, e_loc), stable=True)
    counts = torch.bincount(local_e[valid], minlength=e_loc).tolist()  # one host sync a shard
    y = torch.zeros_like(xr)
    start = 0
    for e, c in enumerate(counts):
        if c:
            rows = order[start:start + c]
            xe = xr[rows]
            h = F.silu(xe @ w_gate[e]) * (xe @ w_up[e])
            y.index_copy_(0, rows, h @ w_down[e])
        start += c
    return y


def _all_to_all(blocks, devices, meta=False):
    """``recv[j][i] = blocks[i][j]``: shard j receives block j of every
    shard i, each cross-shard block a counted ``copy_`` into j's buffer."""
    m = len(blocks)
    _moved["all_to_all"] += 1
    out = []
    for j in range(m):
        buf = torch.empty((m,) + tuple(blocks[j].shape[1:]), dtype=blocks[j].dtype,
                          device=devices[j])
        for i in range(m):
            buf[i].copy_(blocks[i][j])
            if i != j:
                _moved["copies"] += 1
                nbytes = blocks[i][j].numel() * blocks[i][j].element_size()
                _moved["meta_bytes" if meta else "bytes"] += nbytes
        out.append(buf)
    return out


def moe_ffn_expert_parallel(params, x: torch.Tensor, cfg, mesh, *, axis: str = "model",
                            dtype=None):
    """Expert-parallel MoE FFN.  ``x [B, S, D]``; the flattened tokens are
    split over ``("data", axis)``, the expert stacks of ``params`` over
    ``axis`` on the E dim (the router replicated).  Returns (y ``[B, S,
    D]`` on ``x``'s device, aux: the mean of the shards' load-balance
    losses)."""
    dtype = dtype or x.dtype
    m = mesh.shape[axis]
    e = cfg.n_experts
    if e % m:
        raise ValueError(f"{e} experts do not divide over the {m}-shard axis {axis!r}")
    e_loc = e // m
    n_data = mesh.shape.get("data", 1)
    b, s, d = x.shape
    if (b * s) % (n_data * m):
        raise ValueError(f"{b * s} tokens do not split over {n_data} x {m} shards")
    t_dev = b * s // (n_data * m)
    cap = _capacity(t_dev, m, cfg.top_k, cfg.capacity_factor)
    xt = x.reshape(b * s, d)
    ys, auxes = [], []
    for i in range(n_data):
        devices = [mesh.device_at({"data": i, axis: j}, x.device) for j in range(m)]
        sends, metas = [], []
        for j, dev in enumerate(devices):
            blk = xt[(i * m + j) * t_dev:(i * m + j + 1) * t_dev].to(dev)
            x_buf, meta, aux = _route(blk, params["router"].to(dev), cfg, m, e_loc, cap)
            sends.append(x_buf)
            metas.append(meta)
            auxes.append(aux)
            kept = int(torch.count_nonzero(meta[..., 0]))
            _moved["kept"] += kept
            _moved["dropped"] += t_dev * cfg.top_k - kept
        recv = _all_to_all(sends, devices)
        meta_recv = _all_to_all(metas, devices, meta=True)
        del sends
        outs = []
        for j, dev in enumerate(devices):
            w = [params[k][j * e_loc:(j + 1) * e_loc].to(device=dev, dtype=recv[j].dtype)
                 for k in ("w_gate", "w_up", "w_down")]
            y = _experts(recv[j].reshape(m * cap, d), meta_recv[j].reshape(m * cap, 3), *w, e_loc)
            outs.append(y.reshape(m, cap, d))
        del recv, meta_recv
        back = _all_to_all(outs, devices)
        del outs
        for j, dev in enumerate(devices):
            # combine: each token's k contributions in assignment order, fp32
            # (each assignment's cell in the returned buffer: m * cap where dropped)
            meta = metas[j].reshape(m * cap, 3)
            t_k = t_dev * cfg.top_k
            src = meta[:, 0].to(torch.long)
            pos = torch.full((t_k + 1,), m * cap, dtype=torch.long, device=dev)
            pos.scatter_(0, torch.where(src > 0, src - 1, t_k), torch.arange(m * cap, device=dev))
            pos = pos[:t_k]
            hit = pos < m * cap
            yb = torch.cat([back[j].reshape(m * cap, d),
                            torch.zeros((1, d), dtype=back[j].dtype, device=dev)])
            wgt = torch.cat([meta[:, 2], torch.zeros(1, device=dev)])
            contrib = torch.where(hit[:, None], yb[pos].float() * wgt[pos][:, None], 0.0)
            contrib = contrib.reshape(t_dev, cfg.top_k, d)
            out = contrib[:, 0]
            for kk in range(1, cfg.top_k):
                out = out + contrib[:, kk]
            ys.append(out.to(dtype).to(x.device))
    y = torch.cat(ys).reshape(b, s, d)
    aux = torch.stack([a.to(x.device) for a in auxes]).mean()
    return y, aux


__all__ = ["ep_counts", "moe_ffn_expert_parallel", "reset_ep_counts"]
