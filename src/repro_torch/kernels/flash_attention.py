"""Blocked flash attention (causal / sliding-window) over ``[B, H, S, hd]``,
beside its plain PyTorch version (port of ``repro.kernels.flash_attention``).

The ``[S, Sk]`` score matrix never exists in the kernel: K/V tiles stream
through shared memory while a running (max, denominator, accumulator) lives
in registers, and K tiles that the causal frontier or the window mask out
entirely are skipped.  Inputs are float32, bfloat16 or float16; the kernel
computes in float32 and writes ``q.dtype``; the scale is ``1/sqrt(hd)``.
CUDA source: ``csrc/flash_attention.cu`` (head dims 32, 64, 128, 256).

A query row with no key left (possible when Sk < S under a window) gives 0,
as the TPU kernel does; ``ref.attention_ref`` instead gives the uniform
average over its ``-1e30`` scores.  The plain version follows the kernel.

``block_q``/``block_k`` are the TPU kernel's tile sizes: they no longer pick
the tiles (the CUDA kernel picks its own), but the same divisibility check
rejects the same inputs.

The wrapper takes the plain version only for tensors on the CPU.  A CUDA
tensor launches the kernel on the current stream or raises: there is no
fallback.  A launch adds one to ``flash_attention``'s counter in ``dispatch``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import dispatch

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def attention_mask(s: int, sk: int, causal: bool, window: int, device=None) -> torch.Tensor:
    """``[S, Sk]`` bool: may query ``i`` attend to key ``j``?"""
    q_idx = torch.arange(s, device=device)[:, None]
    k_idx = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_idx <= q_idx)
    if window:
        mask = mask & (k_idx > q_idx - window)
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window=0):
    """The plain PyTorch version of ``flash_attention``: the TPU kernel's
    arithmetic with one K block holding every key (full materialisation)."""
    hd = q.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    s_mat = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(q.shape[2], k.shape[2], causal, window, q.device)
    s_mat = torch.where(mask, s_mat, NEG_INF)
    m = torch.amax(s_mat, dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.where(mask, torch.exp(s_mat - m_safe), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype)


def _check(q, k, v, block_q, block_k):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, S, hd]")
    b, h, s, hd = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    bq, bk = min(block_q, s), min(block_k, sk)
    if s % bq or sk % bk:
        raise ValueError(f"flash_attention: seq lens ({s}, {sk}) must divide block sizes "
                         f"({bq}, {bk})")


def flash_attention(q, k, v, *, causal=True, window=0, block_q=512, block_k=512):
    """Attention of ``q [B, H, S, hd]`` over ``k, v [B, H, Sk, hd]``; returns
    ``[B, H, S, hd]`` in ``q.dtype``."""
    _check(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    b, h, s, hd = q.shape
    sk = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("flash_attention: q, k, v must be contiguous, of one dtype, on "
                             f"{q.device}; got {t.dtype} on {t.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: expects float32/bfloat16/float16, got {q.dtype}")
    if max(b, h) > 65535 or max(s, sk) >= 2 ** 31 or not 0 <= window < 2 ** 31:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} / Sk {sk} / window "
                         f"{window} out of the kernel's range")
    out = torch.empty_like(q)
    err = dispatch.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, sk, hd,
        _DTYPE_CODE[q.dtype], int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    dispatch.check_cuda(err, "flash_attention")
    dispatch.count_launch("flash_attention")
    return out
