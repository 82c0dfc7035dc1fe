"""The CUDA kernels of repro_torch against their plain PyTorch versions on
an NVIDIA GPU.  A CUDA kernel has no CPU mode, so every test here is marked
``cuda`` and skips without a card.  This file imports neither JAX nor the
JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: at f32 rtol 1e-5 / atol 1e-5 (the kernel and cuBLAS sum the
N terms in another order); at bf16/f16 one wire ulp relative to the output
scale (a one-ulp fp32 difference in prec can flip a rounding tie).
Validity is bit-equal; the masked kernel's active rows are bitwise the
network kernel's and its inactive rows bitwise its inputs.  Sample + KL:
theta rtol 1e-5 / atol 1e-6, KL rtol 1e-5, and the KL bitwise the same
from run to run.  Flash attention: 2e-5 at f32, 2e-2 at bf16/f16 (the
output is rounded to the input type), as tests/test_kernels.py holds the
Pallas kernel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.flat import neighbor_tables  # noqa: E402
from repro_torch.gossip.clocks import PoissonClock  # noqa: E402
from repro_torch.kernels import consensus as k  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gauss_vi  # noqa: E402

WIRE_EPS = {"bf16": 2.0 ** -7, "f16": 2.0 ** -10}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, p, seed, dev):
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)).astype(np.float32) + 0.05
    w /= w.sum(axis=1, keepdims=True)
    mean = rng.normal(size=(n, p)).astype(np.float32)
    rho = rng.uniform(-4.5, 0.5, size=(n, p)).astype(np.float32)
    return (torch.from_numpy(a).to(dev) for a in (w, mean, rho))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,p", [(1, 5), (9, 4099), (17, 257), (300, 4099)])
def test_consensus_kernel_matches_plain(dev, n, p, wire):
    W, mean, rho = _inputs(n, p, n + p, dev)
    before = dispatch.launch_counts()["consensus_fused_network"]
    got = k.consensus_fused_network(W, mean, rho, wire_dtype=wire)
    want = k.consensus_network_plain(W, mean, rho, wire)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["consensus_fused_network"] == before + 1
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if wire == "f32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            u = WIRE_EPS[wire]
            np.testing.assert_allclose(g, w, rtol=u, atol=u * np.abs(w).max())


def _assert_close(got, want, wire):
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if wire == "f32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            u = WIRE_EPS[wire]
            np.testing.assert_allclose(g, w, rtol=u, atol=u * np.abs(w).max())


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("mask", ["all", "none", "mixed"])
@pytest.mark.parametrize("n,p", [(1, 5), (9, 4099), (300, 4099)])
def test_masked_kernel_matches_plain_and_network(dev, n, p, mask, wire):
    W, mean, rho = _inputs(n, p, n + p + 1, dev)
    active = {"all": torch.ones(n, dtype=torch.bool), "none": torch.zeros(n, dtype=torch.bool),
              "mixed": torch.arange(n) % 3 != 1}[mask].to(dev)
    before = dispatch.launch_counts()["consensus_fused_masked"]
    got = k.consensus_fused_masked(W, active, mean, rho, wire_dtype=wire)
    want = k.consensus_masked_plain(W, active, mean, rho, wire)
    net = k.consensus_fused_network(W, mean, rho, wire_dtype=wire)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["consensus_fused_masked"] == before + 1
    _assert_close(got, want, wire)
    act = active.cpu()
    for g, x, nt in zip(got, (mean, rho), net):
        g, x, nt = g.cpu(), x.cpu(), nt.cpu()
        assert torch.equal(g[act], nt[act])  # one accumulation loop
        assert torch.equal(g[~act], x[~act])  # passed through untouched


def _tables(name):
    if name == "grid":
        return neighbor_tables(graphs.grid_w(3, 3))
    if name == "window":
        win = PoissonClock(graphs.grid_w(3, 3), rate=0.6, seed=1).window(2)
        return neighbor_tables(win.w_eff)
    if name == "ring300":
        return neighbor_tables(graphs.bidirectional_ring_w(300))
    return graphs.watts_strogatz_sparse(300, 6, 0.2, seed=0).neighbor_tables()


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("tables", ["grid", "window", "ring300", "ws300"])
def test_sparse_kernels_match_plain(dev, tables, wire):
    nbr, wts = (torch.from_numpy(a).to(dev) for a in _tables(tables))
    n, p = nbr.shape[0], 4099
    _, mean, rho = _inputs(n, p, n + 7, dev)
    got = k.consensus_fused_sparse(nbr, wts, mean, rho, wire_dtype=wire)
    want = k.consensus_sparse_plain(nbr, wts, mean, rho, wire)
    _assert_close(got, want, wire)
    active = (torch.arange(n, device=dev) % 4 != 2)
    before = dispatch.launch_counts()["consensus_fused_masked_sparse"]
    got = k.consensus_fused_masked_sparse(nbr, wts, active, mean, rho, wire_dtype=wire)
    want = k.consensus_masked_sparse_plain(nbr, wts, active, mean, rho, wire)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["consensus_fused_masked_sparse"] == before + 1
    _assert_close(got, want, wire)
    idle = ~active
    assert torch.equal(got[0][idle], mean[idle]) and torch.equal(got[1][idle], rho[idle])


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("p", [1, 700, 5000])
def test_payload_validity_kernel_bit_equal(dev, wire, p):
    rng = np.random.default_rng(p)
    mean = rng.normal(size=(6, p)).astype(np.float32)
    rho = rng.uniform(-3.0, 0.5, size=(6, p)).astype(np.float32)
    mean[1, p // 3] = np.nan
    rho[2, p - 1] = np.inf
    rho[3, 0] = -np.inf
    mean[4, p // 2] = 1e30
    rho[5, p // 4] = -6.0
    mean, rho = torch.from_numpy(mean).to(dev), torch.from_numpy(rho).to(dev)
    got = k.payload_validity_fused(mean, rho, bound=1e20, wire_dtype=wire)
    want = k.payload_validity_plain(mean, rho, bound=1e20, wire_dtype=wire)
    assert torch.equal(got.cpu(), want.cpu())
    assert got.cpu().tolist() == [True, False, False, False, False, wire != "f16"]


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    W, mean, rho = _inputs(4, 64, 0, dev)
    with pytest.raises(TypeError):
        k.consensus_fused_network(W, mean.double(), rho.double())
    with pytest.raises(ValueError):
        k.consensus_fused_network(W, mean.t(), rho.t())
    with pytest.raises(ValueError):
        k.consensus_fused_network(W[:3, :3], mean, rho)
    with pytest.raises(ValueError):
        k.payload_validity_fused(mean, rho.cpu(), bound=1e20)
    with pytest.raises(ValueError):
        k.consensus_fused_masked(W, torch.ones(3, device=dev), mean, rho)
    nbr = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):  # host tables are checked
        k.consensus_fused_sparse(nbr + 4, torch.ones((4, 2)), mean, rho)
    nbr[1, 1] = 4  # device tables are not: the kernel sets that agent's row to NaN
    m, r = k.consensus_fused_sparse(nbr.to(dev), torch.full((4, 2), 0.5, device=dev), mean, rho)
    bad = torch.isnan(m).all(dim=1).cpu()
    assert bad.tolist() == [False, True, False, False] and torch.isnan(r[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,p", [(1, 5), (9, 199_210), (300, 4099)])
def test_consensus_row_kernel_matches_plain(dev, n, p, wire):
    W, mean, rho = _inputs(n, p, n + p + 2, dev)
    w = W[n // 2].clone()
    if n > 2:  # zero weights in the row are computed, not skipped
        w[0] = 0.0
        w[-1] = 0.0
        w = w / w.sum()
    before = dispatch.launch_counts()["consensus_fused"]
    got = k.consensus_fused(w, mean, rho, wire_dtype=wire)
    want = k.consensus_row_plain(w, mean, rho, wire)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["consensus_fused"] == before + 1
    assert got[0].shape == (p,)
    _assert_close(got, want, wire)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [5, 2049, 199_210])
def test_sample_and_kl_kernel_matches_plain(dev, p):
    rng = np.random.default_rng(p)
    args = [rng.normal(size=p).astype(np.float32) * s + o
            for s, o in ((1.0, 0.0), (0.3, -1.0), (1.0, 0.0), (0.1, 0.0), (0.1, 0.0))]
    args = [torch.from_numpy(a).to(dev) for a in args]
    before = dispatch.launch_counts()["sample_and_kl_fused"]
    theta, kl = gauss_vi.sample_and_kl_fused(*args)
    theta2, kl2 = gauss_vi.sample_and_kl_fused(*args)
    want_theta, want_kl = gauss_vi.sample_and_kl_plain(*args)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["sample_and_kl_fused"] == before + 2
    np.testing.assert_allclose(theta.cpu().numpy(), want_theta.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)
    assert np.isclose(float(kl), float(want_kl), rtol=1e-5)
    assert torch.equal(kl, kl2) and torch.equal(theta, theta2)  # no atomics: same each run


ATT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}
SWEEP = [  # tests/test_kernels.py's sweep: (s, block_q, block_k, causal, window)
    (128, 64, 64, True, 0),
    (128, 128, 64, False, 0),
    (256, 64, 64, True, 100),
    (256, 128, 128, True, 0),
    (64, 64, 64, True, 16),
]


def _attention_case(dev, dtype, shape_q, sk, causal, window, seed, **blocks):
    g = torch.Generator().manual_seed(seed)
    b, h, s, hd = shape_q
    q = torch.randn(shape_q, generator=g).to(dev, dtype)
    kk = torch.randn((b, h, sk, hd), generator=g).to(dev, dtype)
    vv = torch.randn((b, h, sk, hd), generator=g).to(dev, dtype)
    before = dispatch.launch_counts()["flash_attention"]
    got = fa.flash_attention(q, kk, vv, causal=causal, window=window, **blocks)
    want = fa.flash_attention_plain(q, kk, vv, causal=causal, window=window)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = ATT_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s,bq,bk,causal,window", SWEEP)
def test_flash_attention_kernel_matches_plain_on_the_sweep(dev, dtype, s, bq, bk, causal,
                                                           window):
    _attention_case(dev, dtype, (2, 2, s, 64), s, causal, window, seed=s + bq,
                    block_q=bq, block_k=bk)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s,sk,causal,window", [(100, 100, True, 0), (192, 160, False, 50),
                                                (200, 300, True, 64)])
def test_flash_attention_kernel_head_dims_and_ragged_tiles(dev, hd, dtype, s, sk, causal,
                                                           window):
    _attention_case(dev, dtype, (1, 3, s, hd), sk, causal, window, seed=hd + s,
                    block_q=s, block_k=sk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_attention_kernel_fully_masked_rows_give_zero(dev, dtype):
    out = _attention_case(dev, dtype, (1, 2, 128, 64), 64, True, 16, seed=3,
                          block_q=64, block_k=64)
    dead = torch.arange(128, device=dev) >= 64 + 16 - 1
    assert bool((out[:, :, dead] == 0).all()) and bool((out[:, :, ~dead] != 0).any())


@pytest.mark.cuda
def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q = torch.randn((1, 2, 64, 48), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.randn((1, 2, 64, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q.transpose(2, 3), q)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q.half(), q)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(q, q, q, block_q=48)


@pytest.mark.cuda
def test_flash_attention_routes_by_dtype(dev):
    """bf16/f16 run the tensor-core kernel and f32 the SIMT kernel, both
    under the one counter; a 16-bit head dim outside HEAD_DIMS or a
    misaligned tensor raises instead of falling back."""
    from torch.profiler import ProfilerActivity, profile

    q = torch.randn((1, 2, 64, 48), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    flat = torch.randn(2 * 64 * 64 + 1, device=dev).to(torch.bfloat16)
    q = flat[1:].view(1, 2, 64, 64)  # contiguous, 2 bytes off 16-byte alignment
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(q, q, q)
    for dtype, kernel in ((torch.float32, "flash_attention_kernel"),
                          (torch.bfloat16, "flash_attention_tc_kernel"),
                          (torch.float16, "flash_attention_tc_kernel")):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _attention_case(dev, dtype, (1, 2, 128, 64), 128, True, 0, seed=5)
        names = [e.key for e in prof.key_averages() if "flash_attention" in e.key]
        assert names and all(kernel in n for n in names), names
