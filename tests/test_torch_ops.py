"""The public kernel API of repro_torch (``kernels.ops``) and the three
kernels behind it against the JAX package: the plain versions (what a CPU
tensor runs) vs the Pallas kernels in interpret mode, and the ``ops``
wrappers on pytrees vs ``repro.kernels.ops``.

Tolerances, as ``tests/test_kernels.py`` states them for the Pallas kernels:
* ``consensus_fused``: rtol = atol = 1e-5 at f32 (fp32 sum order); at
  bf16/f16 one wire ulp more (2 x ``wire_error_bound``), because a one-ulp
  fp32 difference in prec can flip a rounding tie, with atol relative to the
  output scale;
* ``sample_and_kl_fused``: theta rtol 1e-5 / atol 1e-6, KL rtol 1e-4;
* ``flash_attention``: 2e-5 at f32, 2e-2 at bf16 (output rounded to bf16).

The CUDA kernels themselves run only on the card: see
tests/test_torch_kernels_cuda.py.
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import flat as jflat  # noqa: E402
from repro.core.graphs import grid_w  # noqa: E402
from repro.core.posterior import GaussianPosterior as JGaussianPosterior  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.consensus import consensus_fused as j_consensus_fused  # noqa: E402
from repro.kernels.gauss_vi import sample_and_kl_fused as j_sample_and_kl  # noqa: E402
from repro_torch.core import flat as tflat  # noqa: E402
from repro_torch.core.numerics import wire_error_bound  # noqa: E402
from repro_torch.core.posterior import posterior_from_numpy  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402
from repro_torch.kernels import consensus as tk  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import gauss_vi as tvi  # noqa: E402

j_flash_attention = importlib.import_module("repro.kernels.flash_attention").flash_attention


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_eq6_close(got, want, wire):
    tol = 1e-5 + 2 * wire_error_bound(wire)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(1.0, np.abs(w).max()))


def _row_inputs(n, p, seed):
    rng = np.random.default_rng(seed)
    w = rng.random(n).astype(np.float32) + 0.05
    w /= w.sum()
    mean = rng.normal(size=(n, p)).astype(np.float32)
    # sigma from ~1e-2 to ~1: precisions stay inside f16's range
    rho = rng.uniform(-4.5, 0.5, size=(n, p)).astype(np.float32)
    return w, mean, rho


# -- consensus_fused (eq. 6 for one agent) -----------------------------------


@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("p", [17, 2048, 5000])
@pytest.mark.parametrize("n", [1, 3, 9, 16])
def test_consensus_row_plain_matches_pallas_interpret(n, p, wire):
    w, mean, rho = _row_inputs(n, p, seed=31 * p + n)
    want = j_consensus_fused(jnp.asarray(w), jnp.asarray(mean), jnp.asarray(rho),
                             block=1024, interpret=True, wire_dtype=wire)
    got = tk.consensus_fused(_t(w), _t(mean), _t(rho), wire_dtype=wire)
    assert got[0].shape == (p,) and got[0].dtype == torch.float32
    _assert_eq6_close([g.numpy() for g in got], want, wire)


@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
def test_consensus_row_zero_weights(wire):
    """Zero-weight neighbours (sparse topologies) contribute nothing."""
    _, mean, rho = _row_inputs(4, 300, seed=0)
    w = np.asarray([0.5, 0.5, 0.0, 0.0], np.float32)
    want = j_consensus_fused(jnp.asarray(w), jnp.asarray(mean), jnp.asarray(rho),
                             interpret=True, wire_dtype=wire)
    got = tk.consensus_fused(_t(w), _t(mean), _t(rho), wire_dtype=wire)
    _assert_eq6_close([g.numpy() for g in got], want, wire)
    two = tk.consensus_fused(_t(w[:2]), _t(mean[:2]), _t(rho[:2]), wire_dtype=wire)
    for g, h in zip(got, two):  # the same sums up to the CPU's sum order
        np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=1e-6, atol=1e-6)


def test_consensus_row_plain_matches_both_oracles():
    w, mean, rho = _row_inputs(9, 4099, seed=3)
    got = tk.consensus_fused(_t(w), _t(mean), _t(rho))
    oracle_t = ref.consensus_ref(_t(w), _t(mean), _t(rho))
    oracle_j = jref.consensus_ref(jnp.asarray(w), jnp.asarray(mean), jnp.asarray(rho))
    for g, ot, oj in zip(got, oracle_t, oracle_j):
        np.testing.assert_allclose(g.numpy(), ot.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-5)


def test_consensus_row_differs_from_the_network_kernels_row():
    """Same function, another op order: (w * prec) * mean here, W @ (prec *
    mean) in the network kernel; both within fp32 rounding of each other."""
    w, mean, rho = _row_inputs(9, 2048, seed=5)
    row = tk.consensus_fused(_t(w), _t(mean), _t(rho))
    net = tk.consensus_fused_network(_t(w)[None], _t(mean), _t(rho))
    for r, nt in zip(row, net):
        np.testing.assert_allclose(r.numpy(), nt[0].numpy(), rtol=1e-5, atol=1e-5)


# -- sample_and_kl_fused ----------------------------------------------------


def _vi_inputs(p, seed):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=p).astype(np.float32)
    rho = (rng.normal(size=p) * 0.3 - 1.0).astype(np.float32)
    eps = rng.normal(size=p).astype(np.float32)
    mu_p = (rng.normal(size=p) * 0.1).astype(np.float32)
    rho_p = (rng.normal(size=p) * 0.1).astype(np.float32)
    return mu, rho, eps, mu_p, rho_p


@pytest.mark.parametrize("p", [5, 1000, 4096, 10000])
def test_sample_and_kl_plain_matches_pallas_interpret(p):
    args = _vi_inputs(p, seed=p)
    th_j, kl_j = j_sample_and_kl(*map(jnp.asarray, args), block=512, interpret=True)
    th, kl = tvi.sample_and_kl_fused(*map(_t, args))
    assert th.shape == (p,) and kl.shape == ()
    np.testing.assert_allclose(th.numpy(), np.asarray(th_j), rtol=1e-5, atol=1e-6)
    assert np.isclose(float(kl), float(kl_j), rtol=1e-4)
    th_r, kl_r = ref.sample_and_kl_ref(*map(_t, args))
    np.testing.assert_allclose(th.numpy(), th_r.numpy(), rtol=1e-5, atol=1e-6)
    assert np.isclose(float(kl), float(kl_r), rtol=1e-4)


# -- flash_attention ---------------------------------------------------------

SWEEP = [  # tests/test_kernels.py's sweep: (s, block_q, block_k, causal, window)
    (128, 64, 64, True, 0),
    (128, 128, 64, False, 0),
    (256, 64, 64, True, 100),
    (256, 128, 128, True, 0),
    (64, 64, 64, True, 16),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_q).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s,bq,bk,causal,window", SWEEP)
def test_flash_attention_plain_matches_pallas_interpret(dtype, s, bq, bk, causal, window):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv((2, 2, s, 64), (2, 2, s, 64), seed=s + bq)
    want = j_flash_attention(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)), causal=causal,
                             window=window, block_q=bq, block_k=bk, interpret=True)
    got = tfa.flash_attention(*(_t(x).to(tdt) for x in (q, k, v)), causal=causal,
                              window=window, block_q=bq, block_k=bk)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    oracle = ref.attention_ref(*(_t(x).to(tdt) for x in (q, k, v)), causal=causal,
                               window=window)
    np.testing.assert_allclose(got.float().numpy(), oracle.float().numpy(), atol=tol, rtol=tol)


def test_flash_attention_fully_masked_rows_give_zero():
    """Sk < S under a window: queries 79.. have no key left (keys 0..63,
    window 16).  The Pallas kernel and the port give 0 there; the
    full-materialisation oracle gives the uniform average of V."""
    q, k, v = _qkv((1, 2, 128, 32), (1, 2, 64, 32), seed=9)
    want = np.asarray(j_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                                        window=16, block_q=64, block_k=64, interpret=True))
    got = tfa.flash_attention(*(_t(x) for x in (q, k, v)), causal=True, window=16,
                              block_q=64, block_k=64).numpy()
    dead = np.arange(128) >= 64 + 16 - 1
    assert np.all(want[:, :, dead] == 0.0) and np.all(got[:, :, dead] == 0.0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    oracle = ref.attention_ref(*(_t(x) for x in (q, k, v)), causal=True, window=16).numpy()
    np.testing.assert_allclose(oracle[:, :, dead], np.broadcast_to(
        v.mean(axis=2, keepdims=True), oracle[:, :, dead].shape), atol=1e-5)
    np.testing.assert_allclose(got[:, :, ~dead], oracle[:, :, ~dead], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,sk,bq,bk", [(100, 100, 64, 100), (128, 96, 128, 64)])
def test_flash_attention_rejects_what_the_reference_rejects(s, sk, bq, bk):
    q, k, v = _qkv((1, 1, s, 32), (1, 1, sk, 32), seed=1)
    with pytest.raises(AssertionError):
        j_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), block_q=bq, block_k=bk,
                          interpret=True)
    with pytest.raises(ValueError, match="divide"):
        tfa.flash_attention(*(_t(x) for x in (q, k, v)), block_q=bq, block_k=bk)


# -- the ops wrappers on pytrees vs repro.kernels.ops -----------------------


def _mlp_tree(rng, n=None, widths=(784, 8, 8, 10)):
    lead = () if n is None else (n,)
    tree = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]), start=1):
        tree[f"w{i}"] = rng.normal(size=lead + (a, b)).astype(np.float32) * 0.1
        tree[f"b{i}"] = rng.normal(size=lead + (b,)).astype(np.float32) * 0.1
    return tree


def _stacked_posterior(n, seed, bf16_leaf=False):
    rng = np.random.default_rng(seed)
    mean = _mlp_tree(rng, n)
    rho = {k: rng.uniform(-4.5, 0.5, size=v.shape).astype(np.float32) for k, v in mean.items()}
    if bf16_leaf:
        mean["b2"] = np.asarray(jnp.asarray(mean["b2"]).astype(jnp.bfloat16))
        rho["b2"] = np.asarray(jnp.asarray(rho["b2"]).astype(jnp.bfloat16))
    jpost = JGaussianPosterior(mean=jax.tree.map(jnp.asarray, mean),
                               rho=jax.tree.map(jnp.asarray, rho))
    return jpost, posterior_from_numpy(mean, rho)


def _assert_tree_close(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), key
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32), rtol=rtol,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("bf16_leaf", [False, True])
def test_ops_consensus_posterior_matches_jax(bf16_leaf):
    jpost, tpost = _stacked_posterior(3, seed=4, bf16_leaf=bf16_leaf)
    w = np.asarray([0.5, 0.3, 0.2], np.float32)
    want = jops.consensus_posterior(jpost, jnp.asarray(w), interpret=True)
    got = ops.consensus_posterior(tpost, _t(w))
    tol = 1e-2 if bf16_leaf else 1e-5  # the bf16 leaf is rounded on the way out
    for g, wt in ((got.mean, want.mean), (got.rho, want.rho)):
        _assert_tree_close({k: v for k, v in g.items() if k != "b2"},
                           {k: v for k, v in wt.items() if k != "b2"}, 1e-5, 1e-5)
        _assert_tree_close({"b2": g["b2"]}, {"b2": wt["b2"]}, tol, tol)
    assert got.mean["w1"].shape == (784, 8)


def test_ops_sample_and_kl_takes_jax_noise_through_the_seam():
    rng = np.random.default_rng(8)
    mean = _mlp_tree(rng)
    mean_p = _mlp_tree(rng)
    rho = {k: rng.uniform(-4.0, 0.0, size=v.shape).astype(np.float32) for k, v in mean.items()}
    rho_p = {k: rng.uniform(-3.0, 0.0, size=v.shape).astype(np.float32) for k, v in mean.items()}
    jpost = JGaussianPosterior(jax.tree.map(jnp.asarray, mean), jax.tree.map(jnp.asarray, rho))
    jprior = JGaussianPosterior(jax.tree.map(jnp.asarray, mean_p),
                                jax.tree.map(jnp.asarray, rho_p))
    key = jax.random.key(3)
    theta_j, kl_j = jops.sample_and_kl(jpost, jprior, key, interpret=True)
    p = sum(v.size for v in mean.values())
    eps = np.array(jax.random.normal(key, (p,), jnp.float32))  # what ops.py:122 draws
    theta, kl = ops.sample_and_kl(posterior_from_numpy(mean, rho),
                                  posterior_from_numpy(mean_p, rho_p), eps=eps)
    _assert_tree_close(theta, theta_j, 1e-5, 1e-6)
    assert np.isclose(float(kl), float(kl_j), rtol=1e-5)


def test_ops_sample_and_kl_draws_from_the_generator_in_flat_order():
    rng = np.random.default_rng(2)
    mean = _mlp_tree(rng, widths=(6, 4, 3))
    rho = {k: np.full(v.shape, -2.0, np.float32) for k, v in mean.items()}
    post = posterior_from_numpy(mean, rho)
    theta, _ = ops.sample_and_kl(post, post, torch.Generator().manual_seed(5))
    eps = torch.randn(sum(v.size for v in mean.values()), generator=torch.Generator().manual_seed(5))
    again, kl = ops.sample_and_kl(post, post, eps=eps)
    assert float(kl) == 0.0
    for key in mean:
        assert torch.equal(theta[key], again[key])


def test_ops_consensus_network_and_sparse_match_jax():
    rng = np.random.default_rng(6)
    n, W = 9, grid_w(3, 3).astype(np.float32)
    mean = _mlp_tree(rng, n, widths=(20, 8, 3))
    rho = {k: rng.uniform(-4.5, 0.5, size=v.shape).astype(np.float32) for k, v in mean.items()}
    jlayout = jflat.FlatLayout.for_pytree(jax.tree.map(lambda a: jnp.asarray(a[0]), mean))
    jpost = jflat.FlatPosterior(jlayout.flatten(jax.tree.map(jnp.asarray, mean)),
                                jlayout.flatten(jax.tree.map(jnp.asarray, rho)), jlayout)
    tpost = tflat.flat_posterior_from_pytree(posterior_from_numpy(mean, rho))
    np.testing.assert_array_equal(tpost.mean.numpy(), np.asarray(jpost.mean))
    want = jops.consensus_network(jpost, jnp.asarray(W), interpret=True)
    got = ops.consensus_network(tpost, W)
    _assert_eq6_close((got.mean.numpy(), got.rho.numpy()), (want.mean, want.rho), "f32")
    nbr, wts = jflat.neighbor_tables(W)
    want_s = jops.consensus_network_sparse(jpost, jnp.asarray(nbr), jnp.asarray(wts),
                                           interpret=True)
    got_s = ops.consensus_network_sparse(tpost, nbr, wts)
    _assert_eq6_close((got_s.mean.numpy(), got_s.rho.numpy()), (want_s.mean, want_s.rho), "f32")
    assert got.layout is tpost.layout


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ops_attention_matches_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv((1, 2, 128, 32), (1, 2, 128, 32), seed=12)
    want = jops.attention(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)), causal=True,
                          window=48, block_q=64, block_k=32, interpret=True)
    got = ops.attention(*(_t(x).to(tdt) for x in (q, k, v)), causal=True, window=48,
                        block_q=64, block_k=32)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_ops_flatten_round_trips_every_dtype():
    tree = {"a": torch.randn(3, 5), "b": {"c": torch.randn(7).to(torch.bfloat16),
                                          "d": torch.arange(4, dtype=torch.int32)}}
    flat, paths, shapes, dtypes = ops._flatten(tree)
    assert flat.dtype == torch.float32 and flat.shape == (15 + 7 + 4,)
    assert paths == (("a",), ("b", "c"), ("b", "d"))
    back = ops._unflatten(flat, paths, shapes, dtypes)
    assert torch.equal(back["a"], tree["a"])
    assert back["b"]["c"].dtype == torch.bfloat16 and torch.equal(back["b"]["c"], tree["b"]["c"])
    assert back["b"]["d"].dtype == torch.int32 and torch.equal(back["b"]["d"], tree["b"]["d"])


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    dispatch.reset_launch_counts()
    _, tpost = _stacked_posterior(3, seed=1)
    ops.consensus_posterior(tpost, torch.tensor([0.2, 0.3, 0.5]))
    one = posterior_from_numpy({"w": np.zeros(5, np.float32)}, {"w": np.zeros(5, np.float32)})
    ops.sample_and_kl(one, one, torch.Generator().manual_seed(0))
    q = torch.randn(1, 1, 64, 32)
    ops.attention(q, q, q, block_q=64, block_k=64)
    assert dispatch.launch_counts() == dict.fromkeys(dispatch.KERNELS, 0)


def test_a_tensor_on_another_device_raises_rather_than_falls_back():
    meta = torch.empty((3, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tk.consensus_fused(torch.empty(3, device="meta"), meta, meta)
    row = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tvi.sample_and_kl_fused(row, row, row, row, row)
    q = torch.empty((1, 1, 64, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention(q, q, q)
