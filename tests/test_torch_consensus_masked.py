"""The gossip-window consensus of repro_torch against the JAX package: the
plain versions of ``consensus_fused_masked``, ``consensus_fused_sparse`` and
``consensus_fused_masked_sparse`` (what a CPU tensor runs) and the
``core.flat`` wrappers around them, including the quarantine guard, vs
``repro.core.flat`` in ``mode="xla"`` and ``mode="interpret"`` (the Pallas
kernels interpreted), at every wire dtype.

Tolerances: at f32, rtol 1e-6 / atol 1e-6 — only the fp32 reduction order
differs (the Pallas CSR kernel sums neighbour by neighbour, the plain
versions through a dense product).  At bf16/f16 one wire ulp relative to
the output scale: a one-ulp fp32 difference in prec can flip a rounding
tie.  Inactive rows, the all-active rung and the zero-fault quarantine rung
are bitwise.  The CUDA kernels themselves run only on the card: see
tests/test_torch_kernels_cuda.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import flat as jflat  # noqa: E402
from repro.core.graphs import bidirectional_ring_w, grid_w  # noqa: E402
from repro.core.numerics import softplus as jsoftplus  # noqa: E402
from repro.gossip.clocks import PoissonClock  # noqa: E402
from repro_torch.core import flat as tflat  # noqa: E402
from repro_torch.kernels import consensus as tk  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

WIRE_EPS = {"f32": 0.0, "bf16": 2.0 ** -7, "f16": 2.0 ** -10}
WIRES = ["f32", "bf16", "f16"]
MODES = ["xla", "interpret"]
P = 300


def _posts(n, p, seed):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(n, p)).astype(np.float32)
    rho = rng.uniform(-4.5, 0.5, size=(n, p)).astype(np.float32)  # f16-safe precisions
    return mean, rho


def _jpost(mean, rho):
    layout = jflat.FlatLayout.for_pytree({"w": jnp.zeros((mean.shape[1],))})
    return jflat.FlatPosterior(mean=jnp.asarray(mean), rho=jnp.asarray(rho), layout=layout)


def _tpost(mean, rho):
    layout = tflat.FlatLayout.for_pytree({"w": torch.zeros(mean.shape[1])})
    return tflat.FlatPosterior(torch.from_numpy(mean.copy()), torch.from_numpy(rho.copy()),
                               layout)


def _window(n=6, rate=0.7, seed=2, r=0):
    win = PoissonClock(bidirectional_ring_w(n), rate=rate, seed=seed).window(r)
    assert 0 < win.active.sum() < n  # a mixed mask
    return win


def _close(got, want, wire):
    got, want = np.asarray(got), np.asarray(want)
    if wire == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        u = WIRE_EPS[wire]
        np.testing.assert_allclose(got, want, rtol=u, atol=u * np.abs(want).max())


def _post_close(tout, jout, wire):
    _close(tout.mean.numpy(), jout.mean, wire)
    _close(tout.rho.numpy(), jout.rho, wire)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wire", WIRES)
def test_masked_matches_jax_and_idle_rows_pass_through(wire, mode):
    win = _window()
    mean, rho = _posts(6, P, seed=1)
    W = win.w_eff.astype(np.float32)
    jout = jflat.consensus_flat_masked(_jpost(mean, rho), jnp.asarray(W),
                                       jnp.asarray(win.active), mode=mode, block=128,
                                       wire_dtype=wire)
    tout = tflat.consensus_flat_masked(_tpost(mean, rho), win.w_eff, win.active,
                                       wire_dtype=wire)
    _post_close(tout, jout, wire)
    idle = ~win.active
    np.testing.assert_array_equal(tout.mean.numpy()[idle], mean[idle])
    np.testing.assert_array_equal(tout.rho.numpy()[idle], rho[idle])
    # the plain version and the reference name agree bitwise
    m, r = tflat.consensus_flat_masked_reference(
        torch.from_numpy(mean), torch.from_numpy(rho), torch.from_numpy(W),
        torch.from_numpy(win.active), wire_dtype=wire)
    assert torch.equal(m, tout.mean) and torch.equal(r, tout.rho)


@pytest.mark.parametrize("wire", WIRES)
def test_masked_all_active_is_network_bitwise(wire):
    mean, rho = _posts(9, P, seed=3)
    W = torch.from_numpy(grid_w(3, 3).astype(np.float32))
    m, r = tk.consensus_fused_network(W, torch.from_numpy(mean), torch.from_numpy(rho),
                                      wire_dtype=wire)
    mm, mr = tk.consensus_fused_masked(W, torch.ones(9, dtype=torch.bool),
                                       torch.from_numpy(mean), torch.from_numpy(rho),
                                       wire_dtype=wire)
    assert torch.equal(m, mm) and torch.equal(r, mr)
    mm, mr = tk.consensus_fused_masked(W, torch.zeros(9, dtype=torch.int32),
                                       torch.from_numpy(mean), torch.from_numpy(rho),
                                       wire_dtype=wire)
    assert np.array_equal(mm.numpy(), mean) and np.array_equal(mr.numpy(), rho)


def test_neighbor_tables_match_jax():
    win = _window()
    for W in (grid_w(3, 3), win.w_eff):
        for a, b in zip(tflat.neighbor_tables(W), jflat.neighbor_tables(W)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wire", WIRES)
def test_sparse_matches_jax(wire, mode):
    nbr, wts = jflat.neighbor_tables(grid_w(3, 3))
    assert nbr.shape == (9, 5)
    mean, rho = _posts(9, P, seed=4)
    jout = jflat.consensus_flat_sparse(_jpost(mean, rho), jnp.asarray(nbr),
                                       jnp.asarray(wts), mode=mode, block=128,
                                       wire_dtype=wire)
    tout = tflat.consensus_flat_sparse(_tpost(mean, rho), torch.from_numpy(nbr),
                                       torch.from_numpy(wts), wire_dtype=wire)
    _post_close(tout, jout, wire)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wire", WIRES)
def test_masked_sparse_matches_jax(wire, mode):
    win = _window(seed=5)
    nbr, wts = jflat.neighbor_tables(win.w_eff)
    mean, rho = _posts(6, P, seed=6)
    jout = jflat.consensus_flat_masked_sparse(
        _jpost(mean, rho), jnp.asarray(nbr), jnp.asarray(wts), jnp.asarray(win.active),
        mode=mode, block=128, wire_dtype=wire)
    tout = tflat.consensus_flat_masked_sparse(_tpost(mean, rho), nbr, wts, win.active,
                                              wire_dtype=wire)
    _post_close(tout, jout, wire)
    idle = ~win.active
    np.testing.assert_array_equal(tout.mean.numpy()[idle], mean[idle])
    np.testing.assert_array_equal(tout.rho.numpy()[idle], rho[idle])
    # the CSR form of the window equals its dense masked form
    dense = tflat.consensus_flat_masked(_tpost(mean, rho), win.w_eff, win.active,
                                        wire_dtype=wire)
    _close(tout.mean.numpy(), dense.mean.numpy(), wire)


def test_quarantine_w_matches_jax():
    rng = np.random.default_rng(0)
    W = rng.random((5, 5)) + 0.1
    W = (W / W.sum(1, keepdims=True)).astype(np.float32)
    valid = np.array([True, False, True, True, False])
    got = tflat.quarantine_w(torch.from_numpy(W), torch.from_numpy(valid)).numpy()
    want = np.asarray(jflat.quarantine_w(jnp.asarray(W), jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
    for j in np.nonzero(~valid)[0]:
        assert (np.delete(got[:, j], j) == 0.0).all() and got[j, j] > 0.0
    same = tflat.quarantine_w(torch.from_numpy(W), torch.ones(5, dtype=torch.bool))
    np.testing.assert_array_equal(same.numpy(), W)


def _poisoned_sources(mean, rho):
    """Corrupted transmissions from agents 1 (NaN), 3 (+inf precision) and a
    garbage resident state at agent 4."""
    mean_src, rho_src = mean.copy(), rho.copy()
    mean_src[1, 7] = np.nan
    rho_src[3] = -np.inf
    mean_res = mean.copy()
    mean_res[4, 0] = np.inf  # garbage in the resident posterior
    mean_src[4] = mean_res[4]
    return mean_res, mean_src, rho_src


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wire", WIRES)
def test_quarantined_dense_and_sparse_match_jax(wire, mode):
    win = _window(n=6, rate=1.2, seed=0)  # agent 2 idle, the rest merge
    mean, rho = _posts(6, P, seed=7)
    mean_res, mean_src, rho_src = _poisoned_sources(mean, rho)
    W = win.w_eff.astype(np.float32)
    nbr, wts = jflat.neighbor_tables(win.w_eff)
    jp, tp = _jpost(mean_res, rho), _tpost(mean_res, rho)
    jd, jvd = jflat.consensus_flat_masked_quarantined(
        jp, jnp.asarray(W), jnp.asarray(win.active), mean_src=jnp.asarray(mean_src),
        rho_src=jnp.asarray(rho_src), mode=mode, block=128, wire_dtype=wire)
    td, tvd = tflat.consensus_flat_masked_quarantined(
        tp, win.w_eff, win.active, mean_src=torch.from_numpy(mean_src),
        rho_src=torch.from_numpy(rho_src), wire_dtype=wire)
    js, jvs = jflat.consensus_flat_masked_sparse_quarantined(
        jp, jnp.asarray(nbr), jnp.asarray(wts), jnp.asarray(win.active),
        mean_src=jnp.asarray(mean_src), rho_src=jnp.asarray(rho_src), mode=mode,
        block=128, wire_dtype=wire)
    ts, tvs = tflat.consensus_flat_masked_sparse_quarantined(
        tp, nbr, wts, win.active, mean_src=torch.from_numpy(mean_src),
        rho_src=torch.from_numpy(rho_src), wire_dtype=wire)
    assert tvd.tolist() == tvs.tolist() == np.asarray(jvd).tolist() == np.asarray(jvs).tolist()
    assert tvd.tolist() == [True, False, True, False, False, True]
    for t, j in ((td, jd), (ts, js)):
        # agent 4's garbage resident state passes through, as in the reference
        np.testing.assert_array_equal(t.mean.numpy()[4], mean_res[4])
        keep = np.arange(6) != 4
        _close(t.mean.numpy()[keep], np.asarray(j.mean)[keep], wire)
        _close(t.rho.numpy()[keep], np.asarray(j.rho)[keep], wire)
        assert np.isfinite(t.mean.numpy()[keep]).all()


def test_quarantined_window_hand_computed_three_agents():
    """Agent 2's wire payload is poisoned: receivers 0 and 1 merge with its
    weight moved to self; agent 2 merges from its true resident stats."""
    n, p = 3, 4
    rng = np.random.default_rng(42)
    mean = rng.normal(size=(n, p)).astype(np.float32)
    rho = (rng.normal(size=(n, p)) * 0.4 - 1.0).astype(np.float32)
    W = np.array([[0.6, 0.2, 0.2], [0.3, 0.5, 0.2], [0.25, 0.25, 0.5]], np.float32)
    mean_src = mean.copy()
    mean_src[2] = np.nan
    out, valid = tflat.consensus_flat_masked_quarantined(
        _tpost(mean, rho), torch.from_numpy(W), torch.ones(n, dtype=torch.bool),
        mean_src=torch.from_numpy(mean_src), rho_src=torch.from_numpy(rho))
    assert valid.tolist() == [True, True, False]
    prec = 1.0 / np.asarray(jsoftplus(jnp.asarray(rho)), np.float64) ** 2
    Wq = W.astype(np.float64)
    for i in (0, 1):
        Wq[i, i] += Wq[i, 2]
        Wq[i, 2] = 0.0
    exp_prec = Wq @ prec
    exp_mean = (Wq @ (prec * mean)) / exp_prec
    got_prec = 1.0 / np.asarray(jsoftplus(jnp.asarray(out.rho.numpy())), np.float64) ** 2
    np.testing.assert_allclose(out.mean.numpy(), exp_mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_prec, exp_prec, rtol=1e-4, atol=1e-5)


def test_zero_times_nan_is_contained():
    """Zeroing an invalid source's W column is not enough (0 * NaN = NaN):
    without the sanitized rows the NaN reaches every receiver; the
    quarantined wrapper keeps every output finite."""
    mean, rho = _posts(4, 16, seed=8)
    W = np.full((4, 4), 0.25, np.float32)
    mean_src = mean.copy()
    mean_src[0] = np.nan
    valid = torch.tensor([False, True, True, True])
    Wq = tflat.quarantine_w(torch.from_numpy(W), valid)
    assert float(Wq[1, 0]) == 0.0
    leak = tflat.consensus_flat_masked(_tpost(mean_src, rho), Wq, torch.ones(4, dtype=torch.bool))
    assert torch.isnan(leak.mean[1:]).all(dim=1).any()
    out, v = tflat.consensus_flat_masked_quarantined(
        _tpost(mean, rho), W, np.ones(4, bool), mean_src=torch.from_numpy(mean_src),
        rho_src=torch.from_numpy(rho))
    assert v.tolist() == valid.tolist()
    assert torch.isfinite(out.mean).all() and torch.isfinite(out.rho).all()


@pytest.mark.parametrize("wire", WIRES)
def test_zero_fault_quarantine_is_unguarded_bitwise(wire):
    win = _window()
    mean, rho = _posts(6, P, seed=9)
    nbr, wts = tflat.neighbor_tables(win.w_eff)
    ref = tflat.consensus_flat_masked(_tpost(mean, rho), win.w_eff, win.active,
                                      wire_dtype=wire)
    got, valid = tflat.consensus_flat_masked_quarantined(
        _tpost(mean, rho), win.w_eff, win.active, wire_dtype=wire)
    assert bool(valid.all())
    assert torch.equal(got.mean, ref.mean) and torch.equal(got.rho, ref.rho)
    ref = tflat.consensus_flat_masked_sparse(_tpost(mean, rho), nbr, wts, win.active,
                                             wire_dtype=wire)
    got, valid = tflat.consensus_flat_masked_sparse_quarantined(
        _tpost(mean, rho), nbr, wts, win.active, wire_dtype=wire)
    assert bool(valid.all())
    assert torch.equal(got.mean, ref.mean) and torch.equal(got.rho, ref.rho)


def test_cpu_tensors_launch_no_kernel_and_bad_tables_raise():
    before = dispatch.launch_counts()
    mean, rho = _posts(9, 64, seed=10)
    nbr, wts = tflat.neighbor_tables(grid_w(3, 3))
    post = _tpost(mean, rho)
    tflat.consensus_flat_sparse(post, nbr, wts)
    tflat.consensus_flat_masked(post, grid_w(3, 3), np.ones(9, bool))
    assert dispatch.launch_counts() == before
    bad = nbr.copy()
    bad[0, 0] = 9
    with pytest.raises(ValueError, match="outside"):
        tflat.consensus_flat_sparse(post, bad, wts)
    with pytest.raises(ValueError, match="active mask"):
        tk.consensus_fused_masked(torch.eye(9), torch.ones(8), post.mean, post.rho)


def test_zero_self_weight_row_follows_the_reference():
    """A row with zero self-weight has no real self slot in its CSR tables:
    the reference's sparse guard then moves a dropped source's mass to slot
    0 (``argmax`` of an all-false mask), not to self as the dense guard does.
    The port reproduces the reference; the dense and CSR guards differ here
    (ROADMAP queue C)."""
    W = np.array([[0.0, 0.5, 0.5], [0.25, 0.5, 0.25], [0.25, 0.25, 0.5]])
    nbr, wts = jflat.neighbor_tables(W)
    mean, rho = _posts(3, 4, seed=0)
    mean_src = mean.copy()
    mean_src[1] = np.nan
    act = np.ones(3, bool)
    js, _ = jflat.consensus_flat_masked_sparse_quarantined(
        _jpost(mean, rho), jnp.asarray(nbr), jnp.asarray(wts), jnp.asarray(act),
        mean_src=jnp.asarray(mean_src), rho_src=jnp.asarray(rho))
    ts, _ = tflat.consensus_flat_masked_sparse_quarantined(
        _tpost(mean, rho), nbr, wts, act, mean_src=torch.from_numpy(mean_src),
        rho_src=torch.from_numpy(rho))
    td, _ = tflat.consensus_flat_masked_quarantined(
        _tpost(mean, rho), W, act, mean_src=torch.from_numpy(mean_src),
        rho_src=torch.from_numpy(rho))
    _post_close(ts, js, "f32")
    assert not np.allclose(ts.mean.numpy()[0], td.mean.numpy()[0], atol=1e-3)
    np.testing.assert_allclose(ts.mean.numpy()[1:], td.mean.numpy()[1:], atol=1e-6)
