"""The arithmetic of the float32 flash attention kernel
(``src/repro_torch/kernels/csrc/flash_attention.cu``: 3xTF32 on
``mma.sync.m16n8k8``), emulated in PyTorch on the CPU, against the plain
version and against the Pallas kernel in interpret mode.  The CUDA kernel
itself runs only on the card (tests/test_torch_kernels_cuda.py); this checks
its split, its skip logic and its fragment layouts where there is no card.

The emulation follows the kernel: BQ x BK tiles from ``F32_TILES`` (read
back from the ``.cu``); the K tiles of each query tile from the kernel's
loop bounds; a warp of 16 query rows that skips a tile none of its rows can
see and applies the element mask only where its rows meet a masked pair;
each f32 operand split into ``hi = rna_tf32(x)`` and ``lo = rna_tf32(x - hi)``
(round to nearest, ties away, to 10 mantissa bits: the kernel's integer form
of ``cvt.rna.tf32.f32``); the products ``a_hi b_hi + a_hi b_lo + a_lo b_hi``
in fp32; log2-scaled scores and ``exp2``; the online softmax with the
``m_safe`` / ``corr`` guards; ``max(l, 1e-30)``.  The relabelling of the
contraction index (dims in Q K^T, keys in P V) changes only the order of the
fp32 sums, which the emulation does not follow; the fragment test below
checks, lane by lane, that the relabelled fragments give S = Q K^T and
O = P V.

Tolerance: atol = rtol = 2e-5, the f32 kernel's contract
(``ATT_TOL["f32"]``, tests/test_kernels.py:75).  The dropped ``a_lo b_lo``
and lo's rounding leave ~2^-22 of each product; a single TF32 product (the
control) leaves ~2^-11 and breaks the contract on the same inputs.  The
emulation takes ``exp2`` exactly and sums in IEEE fp32, where the kernel
has ``ex2.approx.ftz`` and the tensor cores' own accumulation, which on the
card adds more error than the split; so this file shows that the split
holds the contract, and the card's sweep (chip_smoke.py phase 2,
tests/test_torch_kernels_cuda.py) is what holds the kernel's whole error
to it.
"""
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash_attention  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
      / "flash_attention.cu")
NEG_INF = -1e30
LOG2E = 1.4426950408889634
TOL = 2e-5
WARP_ROWS = 16  # query rows of one warp


def tf32_rna(x):
    """fp32 -> the nearest tf32 value (ties away from zero), as the kernel
    rounds: half a tf32 ulp added to the bits, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product_3xtf32(a, b):
    """a @ b as the kernel takes it: a_hi b_hi + a_hi b_lo + a_lo b_hi."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def product_tf32(a, b):
    """The control: one TF32 product, no split."""
    return tf32_rna(a) @ tf32_rna(b)


def k_tile_range(q0, bq, bk, sk, causal, window):
    """The kernel's K-loop bounds [lo, hi) for the query tile at ``q0``."""
    n_kt = -(-sk // bk)
    hi = min(n_kt, (q0 + bq - 1) // bk + 1) if causal else n_kt
    lo = 0
    if window and q0 - window - bk + 1 >= 0:
        lo = (q0 - window - bk + 1) // bk + 1
    return lo, max(lo, hi)


def warp_dead(k0, bk, q_lo, s, causal, window):
    """The kernel's test that no row of the warp at ``q_lo`` sees a key of
    the tile at ``k0`` (the warp skips the tile)."""
    return (q_lo >= s or (causal and k0 > q_lo + WARP_ROWS - 1)
            or bool(window and k0 + bk - 1 <= q_lo - window))


def needs_mask(k0, bk, q_lo, sk, causal, window):
    """The kernel's test that the warp's rows meet a masked pair in the
    tile (else the element mask is skipped)."""
    return (k0 + bk > sk or (causal and k0 + bk - 1 > q_lo)
            or bool(window and k0 <= q_lo + WARP_ROWS - 1 - window))


def _padded(x, start, rows):
    """Rows [start, start + rows) of ``x [..., n, d]``, zeros past n (the
    zero-filled copies)."""
    out = x.new_zeros(x.shape[:-2] + (rows, x.shape[-1]))
    part = x[..., start:start + rows, :]
    out[..., :part.shape[-2], :] = part
    return out


def emulate(q, k, v, causal, window, product=product_3xtf32):
    """The kernel's arithmetic on float32 tensors; returns its output."""
    b, h, s, hd = q.shape
    sk = k.shape[2]
    bq, bk = tfa.F32_TILES[hd]
    scale_log2 = float(np.float32(np.float32(1.0 / math.sqrt(hd)) * np.float32(LOG2E)))
    out = torch.zeros_like(q)
    for q0 in range(0, s, bq):
        lo, hi = k_tile_range(q0, bq, bk, sk, causal, window)
        for q_lo in range(q0, min(q0 + bq, s), WARP_ROWS):
            rows = torch.arange(q_lo, q_lo + WARP_ROWS)[:, None]
            qt = _padded(q, q_lo, WARP_ROWS)
            m = torch.full((b, h, WARP_ROWS), NEG_INF)
            l = torch.zeros((b, h, WARP_ROWS))
            o = torch.zeros((b, h, WARP_ROWS, hd))
            for kt in range(lo, hi):
                k0 = kt * bk
                cols = torch.arange(k0, k0 + bk)[None, :]
                ok = cols < sk
                if causal:
                    ok = ok & (cols <= rows)
                if window:
                    ok = ok & (cols > rows - window)
                if warp_dead(k0, bk, q_lo, s, causal, window):
                    assert not bool(ok.any())
                    continue
                if not needs_mask(k0, bk, q_lo, sk, causal, window):
                    assert bool(ok.all())
                x = product(qt, _padded(k, k0, bk).transpose(-1, -2)) * scale_log2
                x = torch.where(ok, x, NEG_INF)
                m_new = torch.maximum(m, x.amax(-1))
                m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
                corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp2(m - m_safe))
                p = torch.exp2(x - m_safe[..., None])
                l = l * corr + p.sum(-1)
                o = o * corr[..., None] + product(p, _padded(v, k0, bk))
                m = m_new
            res = o / torch.clamp_min(l, 1e-30)[..., None]
            n = min(WARP_ROWS, s - q_lo)
            out[:, :, q_lo:q_lo + n] = res[:, :, :n]
    return out


def _inputs(shape_q, sk, seed):
    rng = np.random.default_rng(seed)
    b, h, _, hd = shape_q
    return tuple(torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                 for sh in (shape_q, (b, h, sk, hd), (b, h, sk, hd)))


def _pallas(q, k, v, causal, window):
    s, sk = q.shape[2], k.shape[2]
    return np.asarray(j_flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                        causal=causal, window=window, block_q=s, block_k=sk,
                                        interpret=True), np.float32)


def f32_cfg(src, name, hd):
    """``F32Cfg<hd>::name`` of the ``.cu``, whose tile sizes are written
    ``static constexpr int NAME = HD == X ? A : B;``."""
    x, a, b = re.search(rf"static constexpr int {name} = HD == (\d+) \? (\d+) : (\d+);",
                        src).groups()
    return int(a) if hd == int(x) else int(b)


def test_tiles_are_the_kernels():
    """``F32_TILES`` (query rows, keys) as ``F32Cfg`` sets them: 16 rows a
    warp, 4 warps a block (8 at hd 256); 64 keys at hd 32, else 32."""
    src = CU.read_text()
    want = {hd: (WARP_ROWS * f32_cfg(src, "WARPS", hd), f32_cfg(src, "BK", hd))
            for hd in (32, 64, 128, 256)}
    assert want == tfa.F32_TILES
    assert want == {32: (64, 64), 64: (64, 32), 128: (64, 32), 256: (128, 32)}


def test_tf32_rounding_is_nearest_ties_away():
    """The kernel's integer rounding against round-half-away on the
    significand, done in float64, over random values and exact ties."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32) * np.float32(2.0) ** rng.integers(
        -20, 20, size=4096).astype(np.float32)
    ties = (rng.integers(1 << 10, 1 << 11, size=256) * 2 + 1).astype(np.float64) * 2.0 ** -11
    x = np.concatenate([x, ties.astype(np.float32), -ties.astype(np.float32)])
    mant, exp = np.frexp(x.astype(np.float64))  # x = mant 2^exp, 0.5 <= |mant| < 1
    want = np.sign(mant) * np.floor(np.abs(mant) * 2.0 ** 11 + 0.5) * 2.0 ** -11 * 2.0 ** exp
    got = tf32_rna(torch.from_numpy(x)).numpy().astype(np.float64)
    np.testing.assert_array_equal(got, want)
    hi, lo = split(torch.from_numpy(x))
    rest = np.abs(x.astype(np.float64) - hi.numpy() - lo.numpy())
    assert bool(np.all(rest <= 2.0 ** -22 * np.abs(x)))


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
@pytest.mark.parametrize("s,sk,causal,window", [(256, 256, True, 100), (200, 300, False, 0)])
def test_emulated_kernel_matches_plain_and_pallas(hd, s, sk, causal, window):
    q, k, v = _inputs((1, 2, s, hd), sk, seed=s + sk + hd)
    got = emulate(q, k, v, causal, window).numpy()
    plain = tfa.flash_attention_plain(q, k, v, causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, plain, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _pallas(q, k, v, causal, window), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("hd", [64, 256])
def test_emulated_kernel_ragged_causal_matches_plain(hd):
    """S and Sk not multiples of the tiles, causal with a window."""
    q, k, v = _inputs((1, 2, 200, hd), 300, seed=hd)
    got = emulate(q, k, v, True, 64).numpy()
    plain = tfa.flash_attention_plain(q, k, v, causal=True, window=64).numpy()
    np.testing.assert_allclose(got, plain, atol=TOL, rtol=TOL)


def test_emulated_kernel_rows_without_keys_are_zero():
    """Sk = 128 < S = 256 under window 16: queries 143.. have no key left."""
    q, k, v = _inputs((1, 2, 256, 64), 128, seed=11)
    got = emulate(q, k, v, True, 16)
    dead = torch.arange(256) >= 128 + 16 - 1
    assert bool((got[:, :, dead] == 0).all()) and bool((got[:, :, ~dead] != 0).any())
    plain = tfa.flash_attention_plain(q, k, v, causal=True, window=16)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), _pallas(q, k, v, True, 16), atol=TOL, rtol=TOL)


def test_single_tf32_product_breaks_the_contract():
    """The control: the same inputs through one TF32 product a product miss
    2e-5, so the split is what holds the contract."""
    q, k, v = _inputs((1, 2, 256, 128), 256, seed=5)
    plain = tfa.flash_attention_plain(q, k, v, causal=True, window=0).numpy()
    three = emulate(q, k, v, True, 0).numpy()
    np.testing.assert_allclose(three, plain, atol=TOL, rtol=TOL)
    one = emulate(q, k, v, True, 0, product=product_tf32).numpy()
    err = np.abs(one - plain) - TOL * np.abs(plain)
    assert err.max() > TOL, err.max()


# ---- fragment layouts ---------------------------------------------------------

def _mma(a_regs, b_regs):
    """mma.sync.m16n8k8 .row.col from the 32 lanes' registers, by the PTX
    fragment rules (g = lane / 4, t = lane % 4): A a0 (g, t), a1 (g + 8, t),
    a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (t, g), b1 (t + 4, g); D d0
    (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).  Returns each
    lane's d0..d3."""
    a, bm = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a_regs[lane]
        bm[t, g], bm[t + 4, g] = b_regs[lane]
    d = a @ bm
    return [(d[g, 2 * t], d[g, 2 * t + 1], d[g + 8, 2 * t], d[g + 8, 2 * t + 1])
            for g, t in (divmod(lane, 4) for lane in range(32))]


def test_fragments_give_q_kt_and_p_v():
    """The kernel's relabelled fragments, lane by lane: S = Q K^T over one
    group of 8 dims (A: Q rows g, g + 8 at dims 2t, 2t + 1; B: K row g at
    dims 2t, 2t + 1), then O = P V over one group of 8 keys with P taken from
    S's accumulator as it lies (a0 = d0, a1 = d2, a2 = d1, a3 = d3) and V
    rows 2t, 2t + 1 at the even and odd dims 2g, 2g + 1 of a 16-dim pair;
    the stored outputs are dims 4t .. 4t + 3 of rows g and g + 8."""
    rng = np.random.default_rng(3)
    q, k = rng.normal(size=(16, 8)), rng.normal(size=(8, 8))  # 16 rows, 8 keys, 8 dims
    p, v = rng.normal(size=(16, 8)), rng.normal(size=(8, 16))  # 8 keys, 16 dims
    qk = _mma([(q[g, 2 * t], q[g + 8, 2 * t], q[g, 2 * t + 1], q[g + 8, 2 * t + 1])
               for g, t in (divmod(lane, 4) for lane in range(32))],
              [(k[g, 2 * t], k[g, 2 * t + 1]) for g, t in (divmod(lane, 4) for lane in range(32))])
    s = q @ k.T
    for lane, d in enumerate(qk):  # sc[i]: rows g, g, g + 8, g + 8; keys 2t, 2t + 1, 2t, 2t + 1
        g, t = divmod(lane, 4)
        np.testing.assert_allclose(d, (s[g, 2 * t], s[g, 2 * t + 1], s[g + 8, 2 * t],
                                       s[g + 8, 2 * t + 1]))
    # P in S's accumulator layout (keys 2t, 2t + 1 of rows g, g + 8)
    sc = [(p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t], p[g + 8, 2 * t + 1])
          for g, t in (divmod(lane, 4) for lane in range(32))]
    a_p = [(x[0], x[2], x[1], x[3]) for x in sc]
    halves = [_mma(a_p, [(v[2 * t, 2 * g + h], v[2 * t + 1, 2 * g + h])
                         for g, t in (divmod(lane, 4) for lane in range(32))]) for h in (0, 1)]
    o = p @ v
    for lane in range(32):
        g, t = divmod(lane, 4)
        even, odd = halves[0][lane], halves[1][lane]  # o[8p + 4h + i]
        stored = [(even[0], odd[0], even[1], odd[1]), (even[2], odd[2], even[3], odd[3])]
        np.testing.assert_allclose(stored[0], o[g, 4 * t:4 * t + 4])
        np.testing.assert_allclose(stored[1], o[g + 8, 4 * t:4 * t + 4])
