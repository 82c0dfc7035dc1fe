"""The arithmetic of the tensor-core flash attention kernel
(``src/repro_torch/kernels/csrc/flash_attention_tc.cu``), emulated in
PyTorch on the CPU, against the plain version and against the Pallas kernel
in interpret mode.  The CUDA kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py); this checks its error budget and its
skip logic where there is no card.

The emulation follows the kernel: BQ x BK tiles from ``TC_TILES``; the K
tiles of each query tile from the kernel's loop bounds; Q K^T from the
16-bit operands accumulated in fp32; log2-scaled scores; the element mask;
the online softmax with the ``m_safe`` / ``corr`` guards; P split into
``hi = round(p)`` and ``lo = round(p - hi)`` in the input type before P V;
``max(l, 1e-30)``.

Tolerances:
* the emulation's fp32 output against the plain version's fp32 output on
  the same (16-bit valued) inputs: atol = rtol = 2e-5, the f32 kernel's
  contract.  The split keeps ~16 bits of p at bf16 (~22 at f16), so its
  error is a few 1e-6;
* outputs rounded to the input type, against the plain version and the
  Pallas kernel: one ulp of the output (rtol 2^-7 at bf16, 2^-10 at f16,
  atol 1e-5 near 0), since an fp32 difference of 1e-6 can flip a rounding.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash_attention  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

NEG_INF = -1e30
LOG2E = 1.4426950408889634
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7),
          "f16": (torch.float16, jnp.float16, 2.0 ** -10)}
WG_ROWS = 64  # query rows of one consumer warpgroup


def k_tile_range(q0, bq, bk, sk, causal, window):
    """The kernel's K-loop bounds [lo, hi) for the query tile at ``q0``."""
    n_kt = -(-sk // bk)
    hi = min(n_kt, (q0 + bq - 1) // bk + 1) if causal else n_kt
    lo = 0
    if window and q0 - window - bk + 1 >= 0:
        lo = (q0 - window - bk + 1) // bk + 1
    return lo, max(lo, hi)


def needs_mask(k0, bk, q_lo, sk, causal, window):
    """The kernel's test of whether a warpgroup's rows [q_lo, q_lo + 64)
    meet a masked pair in the K tile at ``k0`` (else the mask is skipped)."""
    return (k0 + bk > sk or (causal and k0 + bk - 1 > q_lo)
            or bool(window and k0 <= q_lo + WG_ROWS - 1 - window))


def _padded(x, start, rows):
    """Rows [start, start + rows) of ``x [..., n, d]``, zeros past n (TMA's
    out-of-bounds fill)."""
    out = x.new_zeros(x.shape[:-2] + (rows, x.shape[-1]))
    part = x[..., start:start + rows, :]
    out[..., :part.shape[-2], :] = part
    return out


def emulate(q, k, v, causal, window, dtype):
    """The kernel's arithmetic on float32 tensors holding ``dtype`` values;
    returns its fp32 output before the final rounding."""
    b, h, s, hd = q.shape
    sk = k.shape[2]
    bq, bk = tfa.TC_TILES[hd]
    scale_log2 = np.float32(np.float32(1.0 / math.sqrt(hd)) * np.float32(LOG2E))
    out = torch.zeros_like(q)
    for q0 in range(0, s, bq):
        rows = torch.arange(q0, q0 + bq)[:, None]
        qt = _padded(q, q0, bq)
        m = torch.full((b, h, bq), NEG_INF)
        l = torch.zeros((b, h, bq))
        o = torch.zeros((b, h, bq, hd))
        lo, hi = k_tile_range(q0, bq, bk, sk, causal, window)
        for kt in range(lo, hi):
            k0 = kt * bk
            cols = torch.arange(k0, k0 + bk)[None, :]
            ok = cols < sk
            if causal:
                ok = ok & (cols <= rows)
            if window:
                ok = ok & (cols > rows - window)
            for w0 in range(0, bq, WG_ROWS):  # the kernel skips the mask here
                if not needs_mask(k0, bk, q0 + w0, sk, causal, window):
                    assert bool(ok[w0:w0 + WG_ROWS].all())
            x = (qt @ _padded(k, k0, bk).transpose(-1, -2)) * float(scale_log2)
            x = torch.where(ok, x, NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp2(m - m_safe))
            p = torch.exp2(x - m_safe[..., None])
            l = l * corr + p.sum(-1)
            p_hi = p.to(dtype).float()
            p_lo = (p - p_hi).to(dtype).float()
            vt = _padded(v, k0, bk)
            o = o * corr[..., None] + p_hi @ vt + p_lo @ vt
            m = m_new
        res = o / torch.clamp_min(l, 1e-30)[..., None]
        out[:, :, q0:q0 + bq] = res[:, :, :min(bq, s - q0)]
    return out


def _inputs(shape_q, sk, dtype, seed):
    rng = np.random.default_rng(seed)
    b, h, _, hd = shape_q
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(dtype)
               for sh in (shape_q, (b, h, sk, hd), (b, h, sk, hd)))
    return q, k, v


def _within_one_ulp(got, want, eps):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=1e-5, rtol=eps)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s,sk,causal,window", [(512, 512, True, 0), (512, 512, True, 100),
                                                (448, 320, False, 100)])
def test_emulated_kernel_matches_plain_and_pallas(dt, hd, s, sk, causal, window):
    tdt, jdt, eps = DTYPES[dt]
    q, k, v = _inputs((1, 2, s, hd), sk, tdt, seed=s + sk + hd)
    got32 = emulate(q.float(), k.float(), v.float(), causal, window, tdt)
    plain32 = tfa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                        window=window)
    np.testing.assert_allclose(got32.numpy(), plain32.numpy(), atol=2e-5, rtol=2e-5)
    got = got32.to(tdt).float()
    plain = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert plain.dtype == tdt
    _within_one_ulp(got.numpy(), plain.float().numpy(), eps)
    pallas = j_flash_attention(*(jnp.asarray(x.float().numpy()).astype(jdt) for x in (q, k, v)),
                               causal=causal, window=window, block_q=s, block_k=sk,
                               interpret=True)
    _within_one_ulp(got.numpy(), np.asarray(pallas, np.float32), eps)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_emulated_kernel_rows_without_keys_are_zero(dt):
    """Sk = 128 < S = 256 under window 16: queries 143.. have no key left."""
    tdt, _, _ = DTYPES[dt]
    q, k, v = _inputs((1, 2, 256, 64), 128, tdt, seed=11)
    got = emulate(q.float(), k.float(), v.float(), True, 16, tdt)
    dead = torch.arange(256) >= 128 + 16 - 1
    assert bool((got[:, :, dead] == 0).all()) and bool((got[:, :, ~dead] != 0).any())
    plain = tfa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True, window=16)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
@pytest.mark.parametrize("s,sk,causal,window", [
    (512, 512, True, 0), (512, 512, True, 100), (448, 320, False, 100), (300, 300, True, 100),
    (256, 128, True, 16), (4096, 4096, True, 0), (4096, 4096, True, 2048),
])
def test_tile_predicate_skips_only_masked_tiles(hd, s, sk, causal, window):
    """The kernel's K-loop bounds are the block predicate of
    flash_attention.py:51-55 at its BQ x BK; every tile they skip is fully
    masked, every unmasked pair lies in a visited tile, and a warpgroup
    skips the element mask only where no pair is masked."""
    bq, bk = tfa.TC_TILES[hd]
    mask = tfa.attention_mask(s, sk, causal, window)
    covered = torch.zeros_like(mask)
    n_kt = -(-sk // bk)
    for q0 in range(0, s, bq):
        lo, hi = k_tile_range(q0, bq, bk, sk, causal, window)
        needed = [kt for kt in range(n_kt)
                  if (not causal or kt * bk <= q0 + bq - 1)
                  and (not window or kt * bk + bk - 1 > q0 - window)]
        assert list(range(lo, hi)) == needed
        for kt in range(n_kt):
            k0 = kt * bk
            block = mask[q0:q0 + bq, k0:k0 + bk]
            if not lo <= kt < hi:
                assert not bool(block.any())
                continue
            covered[q0:q0 + bq, k0:k0 + bk] = True
            for w0 in range(0, bq, WG_ROWS):
                rows = block[w0:w0 + WG_ROWS]
                if rows.numel() and not needs_mask(k0, bk, q0 + w0, sk, causal, window):
                    assert rows.shape[1] == bk and bool(rows.all())
    assert not bool((mask & ~covered).any())
