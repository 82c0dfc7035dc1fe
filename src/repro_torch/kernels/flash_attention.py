"""Blocked flash attention (causal / sliding-window) over ``[B, H, S, hd]``,
beside its plain PyTorch version (port of ``repro.kernels.flash_attention``).

The ``[S, Sk]`` score matrix never exists in a kernel: K/V tiles stream
through shared memory while a running (max, denominator, accumulator) lives
in registers, and K tiles that the causal frontier or the window mask out
entirely are never loaded.  The scale is ``1/sqrt(hd)``; the output is in
``q.dtype``.  Two CUDA kernels serve it, chosen by dtype (head dims 32, 64,
128, 256 for both):

* bfloat16 / float16: ``csrc/flash_attention_tc.cu``, on Hopper's tensor
  cores.  Bound by operations (4 hd flops per unmasked pair at 989 TFLOP/s).
  A producer warp feeds a 2-stage ring of K/V tiles by TMA; two consumer
  warpgroups of 64 query rows each run ``wgmma`` for Q K^T (fp32
  accumulation), the online softmax in registers, and P V with P split into
  two halves in the input type (hi + lo), so P keeps ~16 bits where one
  rounding would keep 8.  The two take turns to issue their products, so
  one's softmax runs under the other's.  Tiles ``TC_TILES[hd]`` (BQ, BK).
* float32: ``csrc/flash_attention.cu``, on the tensor cores as 3xTF32: each
  operand is split into ``hi = rna_tf32(x)`` and ``lo = rna_tf32(x - hi)``
  and a product taken as ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` in fp32, which
  holds the 2e-5 contract against the plain version where one TF32 product
  does not.  Bound by operations (3 x 4 hd flops per unmasked pair at the
  495 TFLOP/s TF32 rate).  It runs ``mma.sync.m16n8k8`` on operands split in
  registers (one design at every head dim): warps of 16 query rows, tiles
  ``F32_TILES[hd]`` (query rows, keys; 8 warps a block at hd 256, else 4),
  K/V tiles through a ring of ``cp.async`` copies (2 stages, 1 at hd 256),
  P taken from the S accumulator with the keys relabelled on both
  operands.  ``wgmma`` would need hi and lo copies of Q, K and a transposed
  V in shared memory, more than a block has at hd 128 and 256 (the ``.cu``
  header).

Both kernels run one block per (b * h, query tile) on a 1-D grid, the
heaviest causal tiles of every head first (``launch_plan.attention_block``),
so B and H have no limit of their own: only B * H * (query tiles) is held
to the grid's 2^31 - 1 blocks.

A CUDA tensor goes to the kernel of its dtype or raises: neither kernel
falls back to the other, to SDPA or to the plain version.  Both need 16-byte
aligned q, k, v (TMA, ``cp.async``).  Both count under ``flash_attention``
in ``dispatch``, and the float32 kernel also under ``flash_attention_f32``.

A query row with no key left (possible when Sk < S under a window) gives 0,
as the TPU kernel does; ``ref.attention_ref`` instead gives the uniform
average over its ``-1e30`` scores.  The plain version follows the kernel.

``block_q``/``block_k`` are the TPU kernel's tile sizes: they no longer pick
the tiles (the CUDA kernels pick their own), but the same divisibility check
rejects the same inputs.

The wrapper takes the plain version only for tensors on the CPU.  A CUDA
tensor launches a kernel on the current stream or raises: there is no
fallback.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import dispatch, launch_plan

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
_TC_DTYPE_CODE = {torch.bfloat16: 1, torch.float16: 2}
# (BQ, BK) of the tensor-core kernel by head dim, as ``TcCfg`` in
# csrc/flash_attention_tc.cu sets them
TC_TILES = {32: (128, 128), 64: (128, 128), 128: (128, 128), 256: (128, 64)}
# (BQ, BK) of the float32 kernel by head dim, as ``F32Cfg`` in
# csrc/flash_attention.cu sets them
F32_TILES = {32: (64, 64), 64: (64, 32), 128: (64, 32), 256: (128, 32)}


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
    if q.dtype != torch.float32 and q.dtype not in _TC_DTYPE_CODE:
        raise TypeError(f"flash_attention: expects float32/bfloat16/float16, got {q.dtype}")
    if max(s, sk) >= 2 ** 31 or not 0 <= window < 2 ** 31:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} / Sk {sk} / window "
                         f"{window} out of the kernel's range")
    # one block per (b * h, query tile) on a 1-D grid: raises past 2^31 - 1 blocks
    launch_plan.attention_blocks(b * h, s, (F32_TILES if q.dtype == torch.float32
                                            else TC_TILES)[hd][0])
    out = torch.empty_like(q)
    lib = dispatch.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / math.sqrt(hd)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: the kernels need 16-byte aligned q, k, v "
                         "(TMA, cp.async)")
    with torch.cuda.device(q.device):  # the launch runs on the tensors' card
        if q.dtype == torch.float32:
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, sk, hd,
                int(bool(causal)), int(window), scale, stream,
            )
        else:
            err = lib.flash_attention_tc_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, s, sk, hd,
                _TC_DTYPE_CODE[q.dtype], int(bool(causal)), int(window), scale, stream,
            )
    dispatch.check_cuda(err, "flash_attention")
    dispatch.count_launch("flash_attention")
    if q.dtype == torch.float32:
        dispatch.count_launch("flash_attention_f32")
    return out
