"""The CUDA kernels of repro_torch against their plain PyTorch versions on
an NVIDIA GPU.  A CUDA kernel has no CPU mode, so every test here is marked
``cuda`` and skips without a card.  This file imports neither JAX nor the
JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: at f32 rtol 1e-5 / atol 1e-5 (the kernel and cuBLAS sum the
N terms in another order); at bf16/f16 one wire ulp relative to the output
scale (a one-ulp fp32 difference in prec can flip a rounding tie).
Validity is bit-equal; the masked kernel's active rows are bitwise the
network kernel's and its inactive rows bitwise its inputs; the dense
generic path (W's nonzeros walked) is bitwise the small one on dense and
sparse W, with NaN where it has NaN, and its walk counter counts each
merging row's nonzeros; it runs up to GENERIC_N_MAX rows and refuses one
more; the one-agent kernel's instances are bitwise its generic kernel.  Sample + KL:
theta bitwise the plain version's (rtol 1e-5 / atol 1e-6 in the older
test), KL rtol 1e-5, and the KL bitwise the same from run to run, on two
streams and at any pointer alignment (its summation order is fixed).  The
validity check and sample + KL run one device kernel per call.  Flash
attention: 2e-5 at f32, 2e-2 at bf16/f16 (the output is rounded to the
input type), as tests/test_kernels.py holds the Pallas kernel.  The
segments kernel (the delayed and edge-native windows): rtol/atol 1e-5 at
f32 and one wire ulp otherwise against its plain version, and bitwise the
same on a second launch (no atomics).  The shard kernels (the sharded
windows): against their plain versions at the same tolerances, and every
reduced row bitwise the masked kernel's row at both its instances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.flat import neighbor_tables  # noqa: E402
from repro_torch.gossip.clocks import PoissonClock, window_from_events  # noqa: E402
from repro_torch.kernels import consensus as k  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gauss_vi  # noqa: E402
from repro_torch.kernels import launch_plan  # noqa: E402

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


def _pattern_w(pattern, n):
    """A row-stochastic W of ``n`` rows with the named zero pattern; None
    for ``_inputs``' dense one."""
    if pattern == "grid3x3":
        return graphs.grid_w(3, 3).astype(np.float32)
    if pattern == "ring16":
        return graphs.bidirectional_ring_w(16).astype(np.float32)
    if pattern == "random70":  # ~70% zeros, and a zero on the diagonal (row 2)
        rng = np.random.default_rng(70)
        w = np.where(rng.random((n, n)) < 0.3, rng.random((n, n)) + 0.05, 0.0)
        w[np.arange(n), (np.arange(n) + 1) % n] = 0.5  # every row keeps a nonzero
        w[2, 2] = 0.0
        return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    return None


def _poison_sources(mean, rho, W):
    """rho = -inf (prec = inf) and mean = NaN at lanes of sources that some
    rows weigh 0 and others do not, so the walk must keep fmaf(0, x, acc);
    returns that source."""
    n, p = mean.shape
    zero = (W == 0).any(dim=0).cpu()
    j0 = int(zero.nonzero()[0]) if bool(zero.any()) else 0
    rho[j0, p // 2] = float("-inf")
    mean[n - 1, p - 1] = float("nan")
    mean[j0, 0] = float("nan")
    return j0


def _same_bits_and_nans(a, b):
    """NaN where the other has NaN, and every other lane the same bits (the
    sign of a zero included)."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        a.masked_fill(nan, 0.0).view(torch.int32), b.masked_fill(nan, 0.0).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("pattern,n,p", [
    ("dense", 1, 5), ("dense", 5, 4099), ("dense", 9, 199_210), ("dense", 16, 257),
    ("grid3x3", 9, 4099), ("ring16", 16, 4099), ("random70", 13, 4099),
])
def test_small_and_generic_dense_paths_agree_bitwise(dev, pattern, n, p, wire, poison):
    """Both dense paths give the small kernel's bits (fmaf over j ascending
    from 0.0f), so where both can run (N <= 16) they agree, masked and not:
    the generic walk over W's nonzeros skips w = 0 terms, and keeps their
    NaN where a zero weight meets a term that is not finite."""
    W, mean, rho = _inputs(n, p, n + p + 3, dev)
    w = _pattern_w(pattern, n)
    if w is not None:
        W = torch.from_numpy(w).to(dev)
    j0 = _poison_sources(mean, rho, W) if poison else None
    active = torch.arange(n, device=dev) % 3 != 1
    for name, act in (("consensus_fused_network", None), ("consensus_fused_masked", active)):
        small = k._network_launch(name, W, act, mean, rho, wire)
        generic = k._network_launch(name, W, act, mean, rho, wire, instance=0)
        torch.cuda.synchronize()
        assert all(_same_bits_and_nans(s_, g_) for s_, g_ in zip(small, generic)), name
        if poison and pattern != "dense":  # a zero weight over prec = inf: NaN, not skipped
            rows = (W[:, j0] == 0) & (True if act is None else act)
            assert bool(rows.any()) and bool(generic[1][rows, p // 2].isnan().all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("pattern", ["grid32x32", "complete64"])
def test_generic_dense_path_walks_the_nonzeros(dev, pattern, wire):
    """The sync cell's N = 1,024 grid (at most 5 nonzeros a row) and a
    complete W at N = 64, on the generic path: against the plain version at
    the file's tolerances; masked, the active rows bitwise the unmasked
    call's and the idle rows untouched; the card's walk counter reads each
    merging row's nonzeros (4,992 of the grid's 1,048,576 entries, all of a
    complete W's); and a poisoned lane's NaN where the plain W @ prec has
    it."""
    W = torch.from_numpy(graphs.grid_w(32, 32) if pattern == "grid32x32"
                         else graphs.complete_w(64)).to(dev, torch.float32)
    n, p = W.shape[0], 4099
    _, mean, rho = _inputs(n, p, n + 11, dev)
    nonzeros = int((W != 0).sum())
    assert nonzeros == (4_992 if pattern == "grid32x32" else n * n)
    dispatch.reset_launch_counts()
    got = k.consensus_fused_network(W, mean, rho, wire_dtype=wire)
    assert dispatch.walk_counts() == {"walked": nonzeros, "dense": n * n}
    assert dispatch.launch_counts()["consensus_fused_network"] == 1
    _assert_close(got, k.consensus_network_plain(W, mean, rho, wire), wire)
    active = torch.arange(n, device=dev) % 2 == 0
    masked = k.consensus_fused_masked(W, active, mean, rho, wire_dtype=wire)
    walked = nonzeros + int((W[active] != 0).sum())
    assert dispatch.walk_counts() == {"walked": walked, "dense": 2 * n * n}
    for g_, x, nt in zip(masked, (mean, rho), got):
        assert torch.equal(g_[active], nt[active]) and torch.equal(g_[~active], x[~active])
    _poison_sources(mean, rho, W)
    got = k.consensus_fused_network(W, mean, rho, wire_dtype=wire)
    want = k.consensus_network_plain(W, mean, rho, wire)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.isnan(), w_.isnan())


@pytest.mark.cuda
@pytest.mark.parametrize("past", [0, 1])
def test_generic_dense_path_runs_up_to_its_largest_n(dev, past):
    """At GENERIC_N_MAX rows the 4-lane tile's terms fill a block's shared
    memory, and the path matches the plain version; one row more is refused
    before anything is launched."""
    n, p = launch_plan.GENERIC_N_MAX + past, 37
    W = torch.from_numpy(graphs.bidirectional_ring_w(n)).to(dev, torch.float32)
    g = torch.Generator(device=dev).manual_seed(n)
    mean = torch.randn((n, p), generator=g, device=dev)
    rho = torch.rand((n, p), generator=g, device=dev) * 5.0 - 4.5
    dispatch.reset_launch_counts()
    if past:
        with pytest.raises(ValueError, match="consensus_fused_sparse"):
            k.consensus_fused_network(W, mean, rho)
        assert dispatch.launch_counts()["consensus_fused_network"] == 0
        return
    assert launch_plan.generic_smem(n) == launch_plan.SMEM_MAX
    got = k.consensus_fused_network(W, mean, rho)
    _assert_close(got, k.consensus_network_plain(W, mean, rho), "f32")
    assert dispatch.walk_counts() == {"walked": 3 * n, "dense": n * n}


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("tables", ["grid", "window", "ring24"])
def test_staged_and_gather_csr_paths_agree_bitwise(dev, tables, wire):
    if tables == "ring24":
        nbr, wts = neighbor_tables(graphs.bidirectional_ring_w(24))  # STAGE_N_MAX rows
    else:
        nbr, wts = _tables(tables)
    nbr, wts = torch.from_numpy(nbr).to(dev), torch.from_numpy(wts).to(dev)
    n = nbr.shape[0]
    _, mean, rho = _inputs(n, 4099, n + 5, dev)
    mean[1, 7] = float("nan")  # a non-finite lane reaches its readers alike
    for act in (None, torch.arange(n, device=dev) % 4 != 2):
        name = "consensus_fused_sparse" if act is None else "consensus_fused_masked_sparse"
        staged = k._sparse_launch(name, nbr, wts, act, mean, rho, wire)
        gather = k._sparse_launch(name, nbr, wts, act, mean, rho, wire, staged=False)
        torch.cuda.synchronize()
        assert torch.equal(staged[0].isnan(), gather[0].isnan())
        for s_, g_ in zip(staged, gather):
            assert torch.equal(torch.nan_to_num(s_), torch.nan_to_num(g_)), name


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2])  # rows 4 and 8 bytes off 16: 4- and 8-byte loads
def test_eq6_kernels_give_the_same_bits_at_every_load_width(dev, offset):
    n, p = 9, 4096  # aligned rows take 16-byte loads
    W, mean, rho = _inputs(n, p, 21, dev)
    views = [torch.cat([torch.zeros(offset, device=dev), x.reshape(-1)])[offset:].view(n, p)
             for x in (mean, rho)]
    nbr, wts = (torch.from_numpy(a).to(dev) for a in _tables("grid"))
    active = torch.arange(n, device=dev) % 3 != 1
    calls = [
        lambda m, r: k.consensus_fused_network(W, m, r),
        lambda m, r: k.consensus_fused_masked(W, active, m, r),
        lambda m, r: k.consensus_fused_sparse(nbr, wts, m, r),
        lambda m, r: k.consensus_fused_masked_sparse(nbr, wts, active, m, r),
    ]
    for call in calls:
        aligned, shifted = call(mean, rho), call(*views)
        torch.cuda.synchronize()
        assert torch.equal(aligned[0], shifted[0]) and torch.equal(aligned[1], shifted[1])


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_csr_kernels_beyond_65535_agents(dev, wire):
    """N = 70,000 agents on ring tables (D = 3), P = 3: the flat (agent, lane
    group) walk has no grid-dimension limit.  The plain versions build the
    dense 70,000^2 W (19.6 GB)."""
    n, p = 70_000, 3
    nbr, wts = (torch.from_numpy(a).to(dev)
                for a in graphs.bidirectional_ring_sparse(n).neighbor_tables())
    _, mean, rho = _inputs(1, n * p, 70, dev)
    mean, rho = mean.view(n, p), rho.view(n, p)
    active = torch.arange(n, device=dev) % 5 != 3
    got = k.consensus_fused_sparse(nbr, wts, mean, rho, wire_dtype=wire)
    _assert_close(got, k.consensus_sparse_plain(nbr, wts, mean, rho, wire), wire)
    got = k.consensus_fused_masked_sparse(nbr, wts, active, mean, rho, wire_dtype=wire)
    _assert_close(got, k.consensus_masked_sparse_plain(nbr, wts, active, mean, rho, wire), wire)
    idle = ~active
    assert torch.equal(got[0][idle], mean[idle]) and torch.equal(got[1][idle], rho[idle])


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


def _row_inputs(n, p, seed, dev):
    """A row of W with zero weights in it (computed, not skipped) and the
    stacked rows it weighs."""
    W, mean, rho = _inputs(n, p, seed, dev)
    w = W[n // 2].clone()
    if n > 2:
        w[0] = 0.0
        w[-1] = 0.0
        w = w / w.sum()
    return w, mean, rho


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("p", [5, 4_099])  # one ragged tile; many tiles
@pytest.mark.parametrize("n", [1, 2, 5, 9, 16, 17, 300])
def test_consensus_row_instances_agree_bitwise(dev, n, p, wire):
    """The planned instance (small for N <= 16, the generic kernel above)
    and the generic kernel sum each lane over j in the same order, so they
    give the same bits."""
    w, mean, rho = _row_inputs(n, p, n + p + 31, dev)
    planned = k._row_launch(w, mean, rho, wire)
    generic = k._row_launch(w, mean, rho, wire, instance=0)
    torch.cuda.synchronize()
    assert torch.equal(planned[0], generic[0]) and torch.equal(planned[1], generic[1])
    _assert_close(planned, k.consensus_row_plain(w, mean, rho, wire), wire)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2])  # rows 16, 4 and 8 bytes off 16
@pytest.mark.parametrize("n", [9, 16])
def test_consensus_row_same_bits_on_misaligned_views(dev, n, offset):
    p = 4_096
    w, mean, rho = _row_inputs(n, p, 41 + n, dev)
    views = [torch.cat([torch.zeros(offset, device=dev), x.reshape(-1)])[offset:].view(n, p)
             for x in (mean, rho)]
    for instance in (None, 0):
        aligned = k._row_launch(w, mean, rho, "f32", instance)
        shifted = k._row_launch(w, *views, "f32", instance)
        torch.cuda.synchronize()
        assert torch.equal(aligned[0], shifted[0]) and torch.equal(aligned[1], shifted[1])


@pytest.mark.cuda
def test_consensus_row_runs_one_device_kernel_per_call(dev):
    for n, kernel in ((9, "consensus_row_small_kernel"), (17, "consensus_row_kernel")):
        w, mean, rho = _row_inputs(n, 4_099, n, dev)
        names = _device_kernels(lambda: k.consensus_fused(w, mean, rho))
        assert len(names) == 1 and kernel in names[0], names
        names = _device_kernels(lambda: k._row_launch(w, mean, rho, None, instance=0))
        assert len(names) == 1 and "consensus_row_kernel" in names[0], names


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


def _device_kernels(fn):
    """The names of the device activities (kernels, copies, fills) of one
    call of ``fn``, after a warm-up call under a profiler session of its own
    (the call may build the library and a stream's counter)."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    return names


@pytest.mark.cuda
def test_streaming_kernels_run_one_device_kernel_per_call(dev):
    W, mean, rho = _inputs(9, 4099, 11, dev)
    names = _device_kernels(lambda: k.payload_validity_fused(mean, rho, bound=1e20))
    assert len(names) == 1 and "payload_validity_kernel" in names[0], names
    args = [mean[i] for i in range(5)]
    names = _device_kernels(lambda: gauss_vi.sample_and_kl_fused(*args))
    assert len(names) == 1 and "sample_and_kl_kernel" in names[0], names
    # a masked call on a device bool mask: the kernel reads the mask's bytes
    active = torch.arange(9, device=dev) % 3 != 1
    names = _device_kernels(lambda: k.consensus_fused_masked(W, active, mean, rho))
    assert len(names) == 1 and "consensus_small_kernel" in names[0], names
    nbr, wts = (torch.from_numpy(a).to(dev) for a in _tables("grid"))
    names = _device_kernels(lambda: k.consensus_fused_masked_sparse(nbr, wts, active, mean, rho))
    assert len(names) == 1 and "consensus_staged_kernel" in names[0], names


def _poison_edges(mean, rho, chunk):
    """NaN / inf / huge in the first and last lane of every row and on both
    sides of every chunk boundary of the flat buffer, rotating over rows."""
    n, p = mean.shape
    m, r = mean.view(-1), rho.view(-1)
    kinds = [lambda i: m.__setitem__(i, float("nan")), lambda i: r.__setitem__(i, float("inf")),
             lambda i: r.__setitem__(i, float("-inf")), lambda i: m.__setitem__(i, 1e30)]
    lanes = [row * p for row in range(0, n, 3)] + [row * p + p - 1 for row in range(1, n, 3)]
    lanes += [b + d for b in range(chunk, n * p, chunk * 5) for d in (-1, 0)
              if (b + d) // p % 3 != 2]  # rows 2, 5, ... stay valid
    for x, i in enumerate(lanes):
        kinds[x % len(kinds)](i)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,p", [(9, 199_210), (50, 199_210), (70, 4_096), (300, 4_099),
                                 (70_000, 3)])
def test_payload_validity_poison_on_row_and_chunk_edges(dev, wire, n, p):
    from repro_torch.kernels import stream_plan

    rng = np.random.default_rng(n + p)
    mean = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    rho = torch.from_numpy(rng.uniform(-3.0, 0.5, size=(n, p)).astype(np.float32))
    _poison_edges(mean, rho, stream_plan.VALIDITY.chunk)
    mean, rho = mean.to(dev), rho.to(dev)
    before = dispatch.launch_counts()["payload_validity_fused"]
    got = k.payload_validity_fused(mean, rho, bound=1e20, wire_dtype=wire)
    want = k.payload_validity_plain(mean, rho, bound=1e20, wire_dtype=wire)
    assert dispatch.launch_counts()["payload_validity_fused"] == before + 1
    assert got.dtype == torch.bool and got.shape == (n,)
    assert torch.equal(got.cpu(), want.cpu())
    assert 0 < int(want.sum()) < n  # both verdicts occur


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("offset", [1, 2, 3])  # rows of 4 bytes, 8 bytes, 12 bytes off 16
def test_payload_validity_on_misaligned_row_views(dev, wire, offset):
    n, p = 9, 199_210
    rng = np.random.default_rng(offset)
    mean = rng.normal(size=(n + 1) * p).astype(np.float32)
    rho = rng.uniform(-3.0, 0.5, size=(n + 1) * p).astype(np.float32)
    mean[offset + 2 * p + p // 2] = np.nan
    rho[offset + 5 * p] = -np.inf
    mean_t, rho_t = torch.from_numpy(mean).to(dev), torch.from_numpy(rho).to(dev)
    mv = mean_t[offset:offset + n * p].view(n, p)
    rv = rho_t[offset:offset + n * p].view(n, p)
    got = k.payload_validity_fused(mv, rv, bound=1e20, wire_dtype=wire)
    want = k.payload_validity_plain(mv, rv, bound=1e20, wire_dtype=wire)
    assert torch.equal(got.cpu(), want.cpu())
    assert got.cpu().tolist()[2] is False and got.cpu().tolist()[5] is False


def _vi_args(p, seed, dev, starts=(0, 0, 0, 0, 0)):
    """Five [P] buffers, each a view starting ``starts[i]`` floats into a
    buffer of its own (a start of 1, 2, 3 puts it 4, 8, 12 bytes off 16)."""
    rng = np.random.default_rng(seed)
    out = []
    for start, (s_, o) in zip(starts, ((1.0, 0.0), (0.3, -1.0), (1.0, 0.0), (0.1, 0.0),
                                       (0.1, 0.0))):
        a = (rng.normal(size=start + p) * s_ + o).astype(np.float32)
        out.append(torch.from_numpy(a).to(dev)[start:])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("p", [5, 2049, 199_210])
@pytest.mark.parametrize("starts", ["aligned", "4B", "8B", "mixed", "odd_row"])
def test_sample_and_kl_theta_bitwise_on_views(dev, p, starts):
    starts = {"aligned": (0,) * 5, "4B": (1,) * 5, "8B": (2,) * 5, "mixed": (0, 1, 2, 3, 2),
              "odd_row": (p,) * 5}[starts]  # odd_row: row 1 of [2, P], as mean[1]
    args = _vi_args(p, p + sum(starts), dev, starts)
    theta, kl = gauss_vi.sample_and_kl_fused(*args)
    theta2, kl2 = gauss_vi.sample_and_kl_fused(*args)
    want_theta, want_kl = gauss_vi.sample_and_kl_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(theta, want_theta)
    assert abs(float(kl) - float(want_kl)) <= 1e-5 * abs(float(want_kl))
    assert torch.equal(kl, kl2) and torch.equal(theta, theta2)
    aligned = [a.clone() for a in args]  # the same values, 16-byte aligned
    assert torch.equal(gauss_vi.sample_and_kl_fused(*aligned)[1], kl)  # the order is fixed


@pytest.mark.cuda
def test_sample_and_kl_on_two_streams_at_once(dev):
    p = 199_210
    args_a, args_b = _vi_args(p, 1, dev), _vi_args(p, 2, dev, (p, 1, 2, 3, 0))
    want = [gauss_vi.sample_and_kl_plain(*a) for a in (args_a, args_b)]
    ref = [gauss_vi.sample_and_kl_fused(*a) for a in (args_a, args_b)]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):  # interleave launches on both streams
        for i, (s_, a) in enumerate(zip(streams, (args_a, args_b))):
            with torch.cuda.stream(s_):
                outs[i].append(gauss_vi.sample_and_kl_fused(*a))
    torch.cuda.synchronize()
    for i in range(2):
        for theta, kl in outs[i]:
            assert torch.equal(theta, want[i][0]) and torch.equal(theta, ref[i][0])
            assert torch.equal(kl, ref[i][1])
            assert abs(float(kl) - float(want[i][1])) <= 1e-5 * abs(float(want[i][1]))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", [(70_000, 1), (1, 70_000)])
def test_flash_attention_beyond_65535_heads(dev, dtype, b, h):
    """B or H = 70,000 on the flat grid of (b * h, query tile) blocks (made
    and compared on the card: 143M elements a tensor)."""
    g = torch.Generator(device=dev).manual_seed(b + h)
    q, kk, vv = (torch.randn((b, h, 64, 32), generator=g, device=dev).to(dtype)
                 for _ in range(3))
    before = dispatch.launch_counts()["flash_attention"]
    got = fa.flash_attention(q, kk, vv, causal=True).float()
    want = fa.flash_attention_plain(q, kk, vv, causal=True).float()
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["flash_attention"] == before + 1
    tol = ATT_TOL[dtype]
    assert bool(((got - want).abs() <= tol + tol * want.abs()).all())


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
    """bf16/f16 run the tensor-core kernel and f32 the 3xTF32 kernel, both
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


@pytest.mark.cuda
def test_flash_attention_f32_misaligned_raises_and_counts(dev):
    """The f32 kernel copies q, k, v by 16-byte cp.async: a contiguous f32
    view 4 bytes off 16-byte alignment raises (no launch, no fallback); an
    aligned call counts once under ``flash_attention_f32`` too."""
    flat = torch.randn(2 * 64 * 64 + 1, device=dev)
    q = flat[1:].view(1, 2, 64, 64)
    before = dispatch.launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(q, q, q)
    assert dispatch.launch_counts() == before
    _attention_case(dev, torch.float32, (1, 2, 64, 64), 64, True, 0, seed=7)
    after = dispatch.launch_counts()
    assert after["flash_attention_f32"] == before["flash_attention_f32"] + 1


def _ragged_case(n, p, k, seed, dev, ring):
    """A delayed window's term list: a self term first, then 0-3 events a
    row reading the [K N, P] ring, a pad term on row 0, a third of the rows
    idle."""
    from repro_torch.kernels.launch_plan import ragged_terms

    rng = np.random.default_rng(seed)
    x_m, x_r = (torch.from_numpy(a).to(dev) for a in (
        rng.normal(size=(n, p)).astype(np.float32),
        rng.uniform(-4.5, 0.5, (n, p)).astype(np.float32)))
    h_m, h_r = (torch.from_numpy(a).to(dev).to(ring) for a in (
        rng.normal(size=(k * n, p)).astype(np.float32),
        rng.uniform(-4.5, 0.5, (k * n, p)).astype(np.float32)))
    e = 2 * n
    dst = np.concatenate([np.arange(n), rng.integers(0, n, e), [0, 0]])
    src = np.concatenate([np.arange(n), n + rng.integers(0, k * n, e), [n, n]])
    w = np.concatenate([rng.uniform(0.3, 0.7, n), rng.uniform(0.0, 0.2, e), [0.0, 0.0]])
    active = rng.random(n) < 0.67
    active[0] = True
    return ragged_terms(n, dst, src, w.astype(np.float32), active), x_m, x_r, h_m, h_r


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("ring", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("wp_first", [False, True])
@pytest.mark.parametrize("n,p", [(9, 4099), (300, 257), (70_000, 3)])
def test_segments_kernel_matches_plain_and_repeats_its_bits(dev, n, p, ring, wire, wp_first):
    """consensus_fused_segments against its plain version (rtol/atol 1e-5
    at f32: another fp32 order; one wire ulp otherwise), bitwise the same
    on a second launch (no atomics), idle rows bitwise their inputs; N past
    a grid dimension's 65,535."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[ring]
    terms, x_m, x_r, h_m, h_r = _ragged_case(n, p, 4, n + p, dev, dt)
    before = dispatch.launch_counts()["consensus_fused_segments"]
    got = k.consensus_fused_segments(terms, x_m, x_r, h_m, h_r, wire_dtype=wire,
                                     wp_first=wp_first)
    again = k.consensus_fused_segments(terms, x_m, x_r, h_m, h_r, wire_dtype=wire,
                                       wp_first=wp_first)
    assert dispatch.launch_counts()["consensus_fused_segments"] == before + 2
    want = k.consensus_segments_plain(terms, x_m, x_r, h_m, h_r, wire, wp_first)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        if wire == "f32":
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        else:
            u = WIRE_EPS[wire]
            assert bool(torch.all((g - w).abs() <= u * w.abs() + u * w.abs().max()))
    idle = torch.from_numpy(terms.row_ptr[1:] == terms.row_ptr[:-1]).to(dev)
    assert torch.equal(got[0][idle], x_m[idle]) and torch.equal(got[1][idle], x_r[idle])


# -- the tile kernel of csrc/consensus_segments.cu against PR 19's lane kernel --

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _segments_instances(terms, x_m, x_r, h_m, h_r, wire, wp_first, instances):
    """The (mean, rho) of each forced instance, and of the planned one (None)."""
    return {inst: k._segments_launch(terms, x_m, x_r, h_m, h_r, wire, wp_first, inst)
            for inst in instances}


def _same_bits(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("ring", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("wp_first", [False, True])
@pytest.mark.parametrize("n,p", [(9, 4_099), (9, 4_100), (300, 258), (70_000, 4)])
def test_segments_tile_kernel_is_the_lane_kernel_bitwise(dev, n, p, ring, wire, wp_first):
    """The tile kernel (planned, and forced at 1 and, at even P, 4 lanes a
    thread) gives PR 19's lane kernel's bits, and is within 1e-5 (one wire
    ulp) of the plain version."""
    terms, x_m, x_r, h_m, h_r = _ragged_case(n, p, 4, n + p + 3, dev, DTYPES[ring])
    got = _segments_instances(terms, x_m, x_r, h_m, h_r, wire, wp_first,
                              [0, None, 1] + ([4] if p % 2 == 0 else []))
    torch.cuda.synchronize()
    for inst in got:
        assert _same_bits(got[inst], got[0]), inst
    want = k.consensus_segments_plain(terms, x_m, x_r, h_m, h_r, wire, wp_first)
    for g, w in zip(got[None], want):
        if wire == "f32":
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        else:
            u = WIRE_EPS[wire]
            assert bool(torch.all((g - w).abs() <= u * w.abs() + u * w.abs().max()))


def _long_row_case(n, p, dev, ring, offset=0):
    """Row 1 sums 11 terms (more than one chunk of 4), mixing x and ring rows;
    row 2 is idle; the other rows take one to three terms.  x and h are views
    ``offset`` elements into a larger buffer."""
    from repro_torch.kernels.launch_plan import ragged_terms

    rng = np.random.default_rng(n + p + offset)

    def view(rows, dtype, lo, hi):
        a = torch.from_numpy(rng.uniform(lo, hi, (rows * p + offset,)).astype(np.float32))
        return a.to(dev).to(dtype)[offset:].view(rows, p)

    x_m, x_r = view(n, torch.float32, -2, 2), view(n, torch.float32, -4.5, 0.5)
    h_m, h_r = view(2 * n, ring, -2, 2), view(2 * n, ring, -4.5, 0.5)
    dst = [1] * 11 + [i for i in range(n) if i not in (1, 2) for _ in range(1 + i % 3)]
    src = rng.integers(0, 3 * n, len(dst))
    w = rng.uniform(0.05, 0.5, len(dst)).astype(np.float32)
    return ragged_terms(n, dst, src, w), x_m, x_r, h_m, h_r


@pytest.mark.cuda
@pytest.mark.parametrize("ring", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("offset", [0, 1, 2])  # rows 16 (or 8), 4 and 8 bytes off 16
@pytest.mark.parametrize("p", [4_096, 4_099])
def test_segments_tile_kernel_on_views_and_long_rows(dev, p, offset, ring):
    """Misaligned views (the plan falls back to one lane a thread where a
    row is off its pair alignment) and a row of 11 terms, more than one
    chunk at every width: the lane kernel's bits, and the aligned copy's."""
    terms, x_m, x_r, h_m, h_r = _long_row_case(9, p, dev, DTYPES[ring], offset)
    aligned = [a.clone() for a in (x_m, x_r, h_m, h_r)]
    for wire in ("f32", "bf16"):
        got = _segments_instances(terms, x_m, x_r, h_m, h_r, wire, False, [0, None, 1])
        again = k._segments_launch(terms, *aligned, wire, False)
        torch.cuda.synchronize()
        assert _same_bits(got[None], got[0]) and _same_bits(got[1], got[0])
        assert _same_bits(again, got[0])
        assert bool(torch.isfinite(got[None][0]).all())
    if p % 2:  # the plan refuses pairs on odd rows
        with pytest.raises(ValueError, match="even row length"):
            k._segments_launch(terms, x_m, x_r, h_m, h_r, None, False, 4)
    elif offset % 2:
        with pytest.raises(RuntimeError, match="CUDA error"):  # the C++ refuses them off pairs
            k._segments_launch(terms, x_m, x_r, h_m, h_r, None, False, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", [0, None])
def test_segments_non_finite_and_out_of_range_sources_give_nan(dev, instance):
    """A row whose only term reads a NaN source at weight 0 stays NaN
    (0 * NaN, as in the reference); a term reading past the sources sets its
    row to NaN; the other rows are the clean call's bits."""
    from repro_torch.kernels.launch_plan import RaggedTerms

    n, p = 6, 1_030
    rng = np.random.default_rng(3)
    x_m, x_r = (torch.from_numpy(rng.uniform(-2, 0.5, (n, p)).astype(np.float32)).to(dev)
                for _ in range(2))
    row_ptr = np.array([0, 1, 2, 4, 5, 5, 6], np.int32)
    src = np.array([0, 5, 1, 2, 3, 5], np.int32)
    w = np.array([1.0, 0.0, 0.5, 0.5, 1.0, 1.0], np.float32)
    clean = RaggedTerms(row_ptr, src, w).to(dev)
    bad = RaggedTerms(row_ptr, np.array([0, 5, 1, 2, n + 7, 5], np.int32), w).to(dev)
    poisoned_m, poisoned_r = x_m.clone(), x_r.clone()
    poisoned_m[5], poisoned_r[5] = float("nan"), float("nan")
    want = k._segments_launch(clean, x_m, x_r, None, None, None, False, instance)
    nan_src = k._segments_launch(clean, poisoned_m, poisoned_r, None, None, None, False,
                                 instance)
    out_of_range = k._segments_launch(bad, x_m, x_r, None, None, None, False, instance)
    torch.cuda.synchronize()
    for got in nan_src:
        assert bool(torch.isnan(got[1]).all()) and bool(torch.isnan(got[5]).all())
    for got, ref in zip(out_of_range, want):  # row 1 is 0 / 0 = NaN in both
        assert bool(torch.isnan(got[3]).all())
        keep = torch.arange(n, device=dev) != 3
        assert torch.equal(got[keep].view(torch.int32), ref[keep].view(torch.int32))


@pytest.mark.cuda
def test_segments_tile_kernel_pass_through_rows(dev):
    """Idle rows copy their pass-through row bitwise from x or from a
    bf16 h (decoded), at every copy width (rows 16, 8 and 4 bytes aligned);
    a pass-through index past the sources gives NaN."""
    from repro_torch.kernels.launch_plan import RaggedTerms

    n, p = 6, 3_001  # odd P: rows start 0, 4, 8 and 12 bytes off 16
    rng = np.random.default_rng(9)
    x_m, x_r = (torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32)).to(dev)
                for _ in range(2))
    h_m, h_r = (torch.from_numpy(rng.normal(size=(2, p)).astype(np.float32)).to(dev)
                .to(torch.bfloat16) for _ in range(2))
    row_ptr = np.array([0, 1, 1, 1, 1, 1, 1], np.int32)
    # rows 1, 2, 4 copy at 4, 8 and 16 bytes; row 3 decodes h row 1; row 5 reads past h
    terms = RaggedTerms(row_ptr, np.array([0], np.int32), np.array([1.0], np.float32),
                        np.array([0, 3, 2, n + 1, 0, n + 2], np.int32)).to(dev)
    mean, rho = k._segments_launch(terms, x_m, x_r, h_m, h_r, None, False)
    torch.cuda.synchronize()
    for row, s in ((1, 3), (2, 2), (4, 0)):
        assert torch.equal(mean[row], x_m[s]) and torch.equal(rho[row], x_r[s])
    assert torch.equal(mean[3], h_m[1].float()) and torch.equal(rho[3], h_r[1].float())
    assert bool(torch.isnan(mean[5]).all()) and bool(torch.isnan(rho[5]).all())


@pytest.mark.cuda
def test_segments_runs_one_device_kernel_per_call(dev):
    terms, x_m, x_r, h_m, h_r = _ragged_case(9, 4_100, 4, 1, dev, torch.bfloat16)
    terms = terms.to(dev)  # resident: a call is the kernel alone
    names = _device_kernels(lambda: k.consensus_fused_segments(terms, x_m, x_r, h_m, h_r))
    assert len(names) == 1 and "consensus_segments_tile_kernel" in names[0], names
    names = _device_kernels(lambda: k._segments_launch(terms, x_m, x_r, h_m, h_r, None, False, 0))
    assert len(names) == 1 and "consensus_segments_kernel" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(9, 199_210), (300, 5_000), (4_200, 64)])
def test_segments_row_order_does_not_change_the_bits(dev, n, p):
    """The list's order (rows with terms first, heaviest first; idle rows
    then copied in 4096-lane items) against no order (every row tiled
    alike) and PR 19's lane kernel: the same bits; a row with terms that
    an order on the card puts among the idle rows is NaN, not skipped."""
    import dataclasses

    terms, x_m, x_r, h_m, h_r = _ragged_case(n, p, 4, n + p + 5, dev, torch.bfloat16)
    assert terms.order is not None and 0 < terms.n_active < n
    plain = dataclasses.replace(terms, order=None, n_active=None)
    ordered = k._segments_launch(terms, x_m, x_r, h_m, h_r, None, False)
    unordered = k._segments_launch(plain, x_m, x_r, h_m, h_r, None, False)
    lane = k._segments_launch(terms, x_m, x_r, h_m, h_r, None, False, 0)
    torch.cuda.synchronize()
    assert _same_bits(ordered, lane) and _same_bits(unordered, lane)
    wrong = terms.order.copy()
    a = terms.n_active
    wrong[a - 1], wrong[a] = wrong[a], wrong[a - 1]  # a busy row among the idle ones
    bad = dataclasses.replace(terms, order=wrong).to(dev)  # on the card: not checked
    got = k._segments_launch(bad, x_m, x_r, h_m, h_r, None, False)
    torch.cuda.synchronize()
    busy_row = int(terms.order[a - 1])
    assert bool(torch.isnan(got[0][busy_row]).all())
    with pytest.raises(ValueError, match="order"):  # the host's check
        k._segments_launch(dataclasses.replace(terms, order=wrong), x_m, x_r, h_m, h_r,
                           None, False)


# -- the shard kernels of the sharded gossip windows (csrc/consensus_shard.cu) --

_WIRE_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _shard_stats(mean, rho, shards, wire, present=None):
    """Every shard's rows encoded into one [2, N, P] buffer of the wire
    dtype; rows of shards not in ``present`` left zero."""
    n, p = mean.shape
    per = n // shards
    stats = torch.zeros((2, n, p), dtype=_WIRE_DTYPE[wire], device=mean.device)
    for s in range(shards) if present is None else present:
        rows = slice(s * per, (s + 1) * per)
        k.consensus_shard_encode(mean[rows], rho[rows], stats[0], stats[1], row0=s * per)
    return stats


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,shards", [(8, 4), (9, 3), (40, 5)])
def test_shard_kernels_match_plain_and_the_masked_kernel_bitwise(dev, n, shards, wire):
    """Encode then reduce every shard: each active row is bitwise the masked
    kernel's row (its small instance at N = 8, 9 and its generic one at any
    N), each idle row its input; against the plain versions at the
    tolerance above.  Rows of shards left out, with their W entries zero,
    change no bit of a row either."""
    W, mean, rho = _inputs(n, 4099, n + 17, dev)
    active = torch.arange(n, device=dev) % 3 != 1
    per = n // shards
    before = dispatch.launch_counts()
    stats = _shard_stats(mean, rho, shards, wire)
    masked = [k.consensus_fused_masked(W, active, mean, rho, wire_dtype=wire)]
    if n <= 16:
        masked.append(k._network_launch("consensus_fused_masked", W, active, mean, rho, wire,
                                        instance=0))
    for s in range(shards):
        rows = slice(s * per, (s + 1) * per)
        got = k.consensus_fused_shard(W[rows], active[rows], stats[0], stats[1], mean[rows],
                                      rho[rows], row0=s * per)
        plain_stats = [x.to(_WIRE_DTYPE[wire]) for x in k.consensus_shard_encode_plain(
            mean, rho, n, 0, wire)]
        want = k.consensus_shard_plain(W[rows], active[rows], *plain_stats, mean[rows],
                                       rho[rows], row0=s * per)
        torch.cuda.synchronize()
        _assert_close(got, want, wire)
        for ref in masked:
            assert torch.equal(got[0], ref[0][rows]) and torch.equal(got[1], ref[1][rows])
        # only this shard and the next present; W's entries for the rest zero
        keep = {s, (s + 1) % shards}
        cols = torch.tensor([j // per in keep for j in range(n)], device=dev)
        W_part = torch.where(cols[None, :], W, 0.0)
        part = k.consensus_fused_shard(W_part[rows], active[rows],
                                       *_shard_stats(mean, rho, shards, wire, keep),
                                       mean[rows], rho[rows], row0=s * per)
        ref = k.consensus_fused_masked(W_part, active, mean, rho, wire_dtype=wire)
        torch.cuda.synchronize()
        assert torch.equal(part[0], ref[0][rows]) and torch.equal(part[1], ref[1][rows])
    after = dispatch.launch_counts()
    assert after["consensus_shard_encode"] - before["consensus_shard_encode"] >= shards
    assert after["consensus_fused_shard"] - before["consensus_fused_shard"] == 2 * shards


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
def test_shard_encode_matches_plain(dev, wire):
    _, mean, rho = _inputs(6, 4099, 5, dev)
    stats = _shard_stats(mean, rho, 3, wire)
    want = k.consensus_shard_encode_plain(mean, rho, 6, 0, wire)
    torch.cuda.synchronize()
    for g, w in zip(stats, want):
        assert g.dtype == _WIRE_DTYPE[wire]
        _assert_close((g.float(),), (w.float(),), wire)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_window_on_the_card_is_masked_bitwise(dev, shards, wire):
    """The whole sharded window over virtual shards of one card is the
    masked kernel's window bitwise, and a poisoned payload of a shard no
    rotation brought reaches no row."""
    from repro_torch.core.flat import FlatLayout, FlatPosterior, consensus_flat_masked
    from repro_torch.launch.consensus_opt import consensus_ppermute_window
    from repro_torch.launch.mesh import AgentMesh

    _, mean, rho = _inputs(8, 4099, 9, dev)
    layout = FlatLayout.for_pytree({"w": torch.zeros(4099)})
    posts = FlatPosterior(mean, rho, layout)
    mesh = AgentMesh((dev,) * shards)
    clock = PoissonClock(graphs.bidirectional_ring_w(8), rate=0.7, seed=3)
    for r in range(3):
        win = clock.window(r)
        out = consensus_ppermute_window(posts, win, mesh, wire_dtype=wire)
        ref = consensus_flat_masked(posts, win.w_eff, win.active, wire_dtype=wire)
        torch.cuda.synchronize()
        assert torch.equal(out.mean, ref.mean) and torch.equal(out.rho, ref.rho), r
    win = window_from_events(graphs.bidirectional_ring_w(8), [(0, 1)], e_max=2)  # no rotation
    bad = mean.clone()
    bad[7] = float("nan")
    out = consensus_ppermute_window(FlatPosterior(bad, rho, layout), win, AgentMesh((dev,) * 4),
                                    wire_dtype=wire)
    torch.cuda.synchronize()
    assert torch.isfinite(out.mean[0]).all() and torch.isnan(out.mean[7]).all()


@pytest.mark.cuda
def test_sharded_window_over_real_cards(dev):
    """Across cards each rotation is a peer copy; the window is the masked
    one bitwise (needs two cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards for a peer copy; this host has one")
    from repro_torch.core.flat import FlatLayout, FlatPosterior, consensus_flat_masked
    from repro_torch.launch.consensus_opt import consensus_ppermute_window
    from repro_torch.launch.mesh import AgentMesh

    cards = tuple(torch.device("cuda", i) for i in range(2))
    _, mean, rho = _inputs(8, 4099, 11, dev)
    posts = FlatPosterior(mean, rho, FlatLayout.for_pytree({"w": torch.zeros(4099)}))
    win = PoissonClock(graphs.bidirectional_ring_w(8), rate=0.9, seed=5).window(0)
    for wire in ("f32", "bf16"):
        out = consensus_ppermute_window(posts, win, AgentMesh(cards), wire_dtype=wire)
        ref = consensus_flat_masked(posts, win.w_eff, win.active, wire_dtype=wire)
        torch.cuda.synchronize()
        assert torch.equal(out.mean, ref.mean) and torch.equal(out.rho, ref.rho), wire
