"""GQA attention with RoPE, optional qk-norm, sliding windows, KV caches and
cross-attention (port of ``repro.models.attention``).

Routes, by what the call has (the reference runs its pure-JAX
``chunked_attention`` on every one; its docstring names the Pallas kernel
as the same contract):

* Prefill into a cache (S > 1) and the causal no-cache forward: the
  hand-written ``flash_attention`` kernels through ``kernels.ops.attention``
  (``kernel_attention``): on the card the tensor-core kernel for bf16/f16
  and the 3xTF32 kernel for f32, on the CPU their plain version.
  ``kernel_attention`` moves the ``[B, S, H, hd]`` layout to the kernel's
  contiguous ``[B, H, S, hd]``, pads S > 512 at the end to a multiple of
  512 (the kernel's tile check), and drops the padded rows: under a causal
  mask every pad key lies after every real query, so it changes no real
  row; a non-causal pad is refused.
* The non-causal no-cache forward of S > 1 queries (an encoder's
  self-attention, cross-attention over the encoder's output, Sq and Sk
  free): ``kernel_attention_full``, the same kernels with ``block_q = Sq``
  and ``block_k = Sk``, so the TPU-style divisibility check passes any
  lengths and nothing is padded.  The CUDA kernels tile by their own
  ``TC_TILES`` and mask a ragged Sk tail themselves.
* Decode (S = 1): self-attention over the cache needs ``q_offset``,
  ``k_valid`` and ``k_positions``, which the kernel does not take, and a
  decode step's cross-attention has one query row a head: both stay the
  plain ``chunked_attention`` in PyTorch, as in the reference, outside any
  kernel (over the unrepeated KV heads, in one chunk).  A decode-attention
  kernel is not a port item (the TPU side has none).
* Training.  The reference trains through its plain ``chunked_attention``
  (``nll_loss`` -> ``forward`` never reaches the Pallas kernel, which has
  no backward).  So does the port: where autograd records the no-cache
  forward (a loss being differentiated), ``attention_block`` takes
  ``chunked_attention`` for every kind, whose plain PyTorch ops autograd
  differentiates.  The kernel is launched through raw pointers, so its
  route is an ``autograd.Function`` whose backward raises: a kernel
  forward recorded under autograd would otherwise give attention no
  gradient.

Caches hold ``[*A, B, capacity, kv, hd]`` (a ring buffer when capacity <
context) with absolute positions ``[*A, B, capacity]`` (-1 = empty), or
int8 codes with per-(slot, head) fp32 scales.  The port writes the cache IN
PLACE and returns the same dict (the reference returns a new cache; a
serving loop donates it): the old cache is not kept.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.modules import matmul, rmsnorm, rope, truncated_normal_init

NEG_INF = -1e30
KERNEL_BLOCK = 512  # flash_attention's tile check: S > 512 must be a multiple of 512


def attn_init(generator, cfg, cross: bool = False, *, dtype=torch.float32, device=None,
              lead=()):
    hd = cfg.hd
    p = {
        name: truncated_normal_init(generator, shape, 1.0, dtype, device, lead)
        for name, shape in (("wq", (cfg.d_model, cfg.n_heads * hd)),
                            ("wk", (cfg.d_model, cfg.n_kv_heads * hd)),
                            ("wv", (cfg.d_model, cfg.n_kv_heads * hd)),
                            ("wo", (cfg.n_heads * hd, cfg.d_model)))
    }
    if cfg.qk_norm and not cross:
        for name in ("q_norm", "k_norm"):
            p[name] = {"scale": torch.ones(tuple(lead) + (hd,), dtype=dtype, device=device)}
    return p


def _split_heads(x, n, hd):
    return x.reshape(tuple(x.shape[:-1]) + (n, hd))


def _repeat_kv(k, n_heads):
    """[..., S, kv, hd] -> [..., S, H, hd] by group replication."""
    kv = k.shape[-2]
    if kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kv, dim=-2)


def _fold(t, keep):
    """Fold every axis before the last ``keep`` into one batch axis."""
    return t.reshape((-1,) + tuple(t.shape[t.ndim - keep:]))


def chunked_attention(q, k, v, *, causal: bool, window: int = 0, q_offset=0,
                      k_valid=None, k_positions=None, chunk_size: int = 512):
    """Flash-attention algorithm over KV chunks, in plain PyTorch.

    ``q [*B, Sq, H, hd]``, ``k, v [*B, Sk, H or kv, hd]`` (fewer heads: GQA,
    query head h reads KV head ``h // (H / kv)``, as ``_repeat_kv`` lays them
    out), ``k_valid [*B, Sk]`` bool (cache slots), ``k_positions [*B, Sk]``
    absolute positions.  ``q_offset``: absolute position of q[0] (prefill
    continuation / decode).  ``window`` > 0 masks keys older than
    ``window`` positions behind a query.  Scores, softmax and sums in fp32;
    K and V are cast once into a heads-first fp32 copy, so each chunk is
    two batched products over contiguous tiles.
    """
    lead = tuple(q.shape[:-3])
    q, k, v = _fold(q, 3), _fold(k, 3), _fold(v, 3)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    if k_valid is not None:
        k_valid = _fold(k_valid, 1)
    if k_positions is not None:
        k_positions = _fold(k_positions, 1)
    scale = 1.0 / math.sqrt(hd)
    n_chunks = -(-sk // chunk_size)
    pad = n_chunks * chunk_size - sk
    if pad:
        valid = k_valid if k_valid is not None else torch.ones((b, sk), dtype=torch.bool,
                                                                 device=dev)
        k_valid = torch.cat([valid, torch.zeros((b, pad), dtype=torch.bool, device=dev)], 1)
        if k_positions is not None:
            k_positions = F.pad(k_positions, (0, pad))
    skp = sk + pad
    if k_positions is None:
        k_positions = torch.arange(skp, device=dev).expand(b, skp)
    if k_valid is None:
        k_valid = torch.ones((b, skp), dtype=torch.bool, device=dev)

    def heads_first(t):  # [b, sk, kv, hd] -> fp32 [b, kv, skp, hd], zero pad keys
        out = torch.zeros((b, kvh, skp, hd), dtype=torch.float32, device=dev)
        out[:, :, :sk].copy_(t.transpose(1, 2))
        return out

    kf, vf = heads_first(k), heads_first(v)
    # query rows (group member, position) of each KV head: [b, kv, g * Sq, hd]
    qf = q.float().reshape(b, sq, kvh, g, hd).permute(0, 2, 3, 1, 4).reshape(b, kvh, g * sq, hd)
    q_pos = (q_offset + torch.arange(sq, device=dev)).repeat(g)[None, None, :, None]
    m = torch.full((b, kvh, g * sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g * sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g * sq, hd), dtype=torch.float32, device=dev)
    for j in range(n_chunks):
        cs = slice(j * chunk_size, (j + 1) * chunk_size)
        kp = k_positions[:, cs][:, None, None, :]
        s = torch.matmul(qf, kf[:, :, cs].transpose(-1, -2)) * scale
        mask = k_valid[:, cs][:, None, None, :]
        if causal:
            mask = mask & (kp <= q_pos)
        if window:
            mask = mask & (kp > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vf[:, :, cs])
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.reshape(b, kvh, g, sq, hd).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype).reshape(lead + (sq, h, hd))


def _padded_len(s: int) -> int:
    if s <= KERNEL_BLOCK:
        return s
    return -(-s // KERNEL_BLOCK) * KERNEL_BLOCK


def _kernel_attention(q, k, v, causal, window, full):
    lead, (s, h, hd) = tuple(q.shape[:-3]), tuple(q.shape[-3:])
    pad = 0 if full else _padded_len(s) - s
    if pad and not causal:
        raise ValueError(f"kernel_attention: S = {s} needs a pad to {s + pad}, which only a "
                         "causal mask leaves out of the real rows")

    def heads_first(t):  # [*B, S, H, hd] -> contiguous [B, H, S + pad, hd]
        t = _fold(t, 3).transpose(1, 2)
        return F.pad(t, (0, 0, 0, pad)) if pad else t.contiguous()

    blocks = dict(block_q=s, block_k=k.shape[-3]) if full else {}
    out = ops.attention(heads_first(q), heads_first(k), heads_first(v), causal=causal,
                        window=window, **blocks)
    return out[:, :, :s].transpose(1, 2).reshape(lead + (s, h, hd))


class _KernelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, full):
        return _kernel_attention(q, k, v, causal, window, full)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash_attention has no backward (nor has the Pallas kernel it ports): training "
            "differentiates chunked_attention, as the reference does; attention_block takes it "
            "wherever autograd records the forward")


def kernel_attention(q, k, v, *, causal: bool, window: int = 0):
    """Attention of ``q [*B, S, H, hd]`` over ``k, v [*B, S, H, hd]``
    (queries and keys at positions 0..S-1) on ``flash_attention``; returns
    ``[*B, S, H, hd]`` in ``q.dtype``."""
    return _KernelAttention.apply(q, k, v, bool(causal), int(window), False)


def kernel_attention_full(q, k, v):
    """Non-causal attention of ``q [*B, Sq, H, hd]`` over ``k, v [*B, Sk,
    H, hd]`` (every query sees every key; Sq and Sk free) on
    ``flash_attention``, unpadded; returns ``[*B, Sq, H, hd]`` in
    ``q.dtype``."""
    return _KernelAttention.apply(q, k, v, False, 0, True)


def init_kv_cache(cfg, batch: int, capacity: int, dtype=torch.bfloat16, device=None, lead=()):
    """Fixed-capacity KV cache (ring buffer when capacity < context).

    ``dtype=torch.int8`` stores int8 codes with per-(slot, head) absmax
    scales, dequantized on read (halves the KV bytes a decode step reads
    against bf16)."""
    lead = tuple(lead)
    shape = lead + (batch, capacity, cfg.n_kv_heads, cfg.hd)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full(lead + (batch, capacity), -1, dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return cache


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] bf16/f32 -> (int8, per-[...] fp32 scale)."""
    x32 = x.float()
    absmax = torch.amax(torch.abs(x32), dim=-1)
    scale = torch.clamp_min(absmax / 127.0, 1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


# the slot axis of each cache leaf, from the end
_SLOT_AXIS = {"k": -3, "v": -3, "k_scale": -2, "v_scale": -2, "pos": -1}


def _stored(cache, k, v):
    """(name, value) pairs of what ``k, v [..., S, kv, hd]`` store as."""
    if cache["k"].dtype == torch.int8:
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}


def cache_update(cache, k_new, v_new, position):
    """Write one decode step (S = 1) at slot ``position % capacity``.
    ``position`` is an int or a one-element tensor; the slot is computed on
    the cache's device, so a decode step never waits for the host."""
    pos = cache["pos"]
    if not isinstance(position, torch.Tensor):
        position = torch.full((1,), int(position), dtype=torch.long, device=pos.device)
    position = position.reshape(1).to(pos.device)
    slot = (position % cache["k"].shape[-3]).long()
    for name, val in _stored(cache, k_new, v_new).items():
        leaf = cache[name]
        leaf.index_copy_(leaf.ndim + _SLOT_AXIS[name], slot, val)
    pos.index_copy_(pos.ndim - 1, slot,
                    position.to(pos.dtype).expand(pos.shape[:-1] + (1,)).contiguous())
    return cache


def cache_read_kv(cache, dtype):
    """Materialize (k, v) from the cache, dequantizing if int8-stored."""
    if cache["k"].dtype == torch.int8:
        return (_dequantize_kv(cache["k"], cache["k_scale"], dtype),
                _dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"].to(dtype), cache["v"].to(dtype)


def _prefill_cache(cache, k, v, positions):
    """Bulk-write a prefill's k/v: slots 0..S-1 when capacity >= S, else
    (ring buffer) only the last ``capacity`` positions, each at its slot
    ``position % capacity`` (decode then continues seamlessly)."""
    s, cap = k.shape[-3], cache["k"].shape[-3]
    stored = _stored(cache, k, v)
    pos = cache["pos"]
    positions = positions.to(pos.device)
    if cap >= s:
        for name, val in stored.items():
            leaf = cache[name]
            leaf.narrow(leaf.ndim + _SLOT_AXIS[name], 0, s).copy_(val)
        pos.narrow(-1, 0, s).copy_(positions.to(pos.dtype))
        return
    tail_pos = positions[s - cap:]
    slots = (tail_pos % cap).long()
    for name, val in stored.items():
        leaf = cache[name]
        dim = leaf.ndim + _SLOT_AXIS[name]
        leaf.index_copy_(dim, slots, val.narrow(dim, s - cap, cap))
    pos.index_copy_(pos.ndim - 1, slots,
                    tail_pos.to(pos.dtype).expand(pos.shape[:-1] + (cap,)).contiguous())


def attention_qkv(params, x, cfg, positions, cross_x=None, use_rope: bool = True):
    """q ``[..., S, H, hd]`` of ``x [..., S, D]`` and k, v ``[..., Sk, kv,
    hd]`` of ``cross_x`` (``x`` without it) after the qk-norm, and RoPE at
    ``positions`` unless ``use_rope`` is off or ``cross_x`` is given."""
    hd, dt = cfg.hd, x.dtype
    kv_src = x if cross_x is None else cross_x
    q = _split_heads(matmul(x, params["wq"].to(dt)), cfg.n_heads, hd)
    k = _split_heads(matmul(kv_src, params["wk"].to(dt)), cfg.n_kv_heads, hd)
    v = _split_heads(matmul(kv_src, params["wv"].to(dt)), cfg.n_kv_heads, hd)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if use_rope and cross_x is None:
        q, k = rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(params, x, cfg, *, causal: bool = True, window: int = 0, positions=None,
                    cache: dict | None = None, cross_x=None, use_rope: bool = True):
    """``x [*A, B, S, D]`` -> (y ``[*A, B, S, D]``, the cache or None).
    ``cross_x [*A, B, Sk, D]``: attend over it (cross-attention: no RoPE,
    no mask, no cache) instead of over ``x``.  ``use_rope=False``: no
    rotary embedding (the enc-dec kinds).

    Branches (the module docstring's routes): decode (a cache and S = 1:
    append to the cache, attend over it with ``chunked_attention``); no
    cache where autograd records the forward (``chunked_attention``); no
    cache, non-causal (``kernel_attention_full``; a decode step's one query
    row, ``chunked_attention`` in one chunk); else prefill into a cache or
    the causal no-cache forward (``kernel_attention``)."""
    s = x.shape[-2]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = attention_qkv(params, x, cfg, positions, cross_x, use_rope)
    causal = causal and cross_x is None

    if cache is not None and s == 1:
        # one query row a head: the whole cache is one chunk (chunking saves no
        # memory at Sq = 1 and costs launches); the KV heads are not repeated
        cache_update(cache, k, v, positions[:1])
        k_deq, v_deq = cache_read_kv(cache, x.dtype)
        out = chunked_attention(
            q, k_deq, v_deq, causal=causal, window=window, q_offset=positions[0],
            k_valid=cache["pos"] >= 0, k_positions=cache["pos"],
            chunk_size=k_deq.shape[-3])
    elif cache is None and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        out = chunked_attention(q, k, v, causal=causal, window=window)
    elif cache is None and not causal:
        if s == 1:
            out = chunked_attention(q, k, v, causal=False, chunk_size=k.shape[-3])
        else:
            out = kernel_attention_full(q, _repeat_kv(k, cfg.n_heads),
                                        _repeat_kv(v, cfg.n_heads))
    else:
        if cache is not None:
            _prefill_cache(cache, k, v, positions)
        out = kernel_attention(q, _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads),
                               causal=causal, window=window)
    y = matmul(out.reshape(tuple(x.shape[:-1]) + (cfg.n_heads * cfg.hd,)),
               params["wo"].to(x.dtype))
    return y, cache
