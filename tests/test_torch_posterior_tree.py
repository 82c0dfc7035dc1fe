"""The pytree half of repro_torch's ``core.posterior`` against
``repro.core.posterior``: the mean-field posterior over a parameter dict
(sigma, precision, sample with injected noise, n_params), the leafwise KL,
eq. (6) for one agent and for all agents (at every wire dtype), the
delta-posterior average, and ``posterior_from_numpy``.

Tolerance: rtol = atol = 1e-5 (fp32 op order); at bf16/f16 wires one wire
ulp more (2 x ``wire_error_bound``), relative to the output scale, because
a one-ulp fp32 difference in prec can flip a rounding tie.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import posterior as jp  # noqa: E402
from repro.core.graphs import grid_w  # noqa: E402
from repro_torch.core import posterior as tp  # noqa: E402
from repro_torch.core.flat import FlatLayout, FlatPosterior  # noqa: E402
from repro_torch.core.numerics import wire_error_bound  # noqa: E402

TOL = 1e-5


def _tree(rng, lead=(), widths=(784, 8, 8, 10), scale=0.1):
    tree = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]), start=1):
        tree[f"w{i}"] = (rng.normal(size=lead + (a, b)) * scale).astype(np.float32)
        tree[f"b{i}"] = (rng.normal(size=lead + (b,)) * scale).astype(np.float32)
    return tree


def _posteriors(seed, lead=(3,)):
    """The same random posterior as a JAX and a port GaussianPosterior."""
    rng = np.random.default_rng(seed)
    mean = _tree(rng, lead)
    rho = {k: rng.uniform(-4.5, 0.5, size=v.shape).astype(np.float32) for k, v in mean.items()}
    jpost = jp.GaussianPosterior(jax.tree.map(jnp.asarray, mean), jax.tree.map(jnp.asarray, rho))
    return jpost, tp.posterior_from_numpy(mean, rho)


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=tol, atol=tol * max(1.0, np.abs(w).max()))


def test_posterior_from_numpy_round_trips_bitwise():
    rng = np.random.default_rng(0)
    mean = _tree(rng, widths=(5, 4, 3))
    mean["b1"] = np.asarray(jnp.asarray(mean["b1"]).astype(jnp.bfloat16))
    rho = {k: np.full(v.shape, -3.0, v.dtype) for k, v in mean.items()}
    post = tp.posterior_from_numpy(mean, rho)
    assert post.mean["b1"].dtype == torch.bfloat16 and post.mean["w1"].dtype == torch.float32
    for k in mean:
        back = post.mean[k].view(torch.uint16) if k == "b1" else post.mean[k]
        want = mean[k].view(np.uint16) if k == "b1" else mean[k]
        np.testing.assert_array_equal(back.numpy(), want)
    np.testing.assert_array_equal(post.rho["w2"].numpy(), rho["w2"])


def test_sigma_precision_n_params_match():
    jpost, tpost = _posteriors(1, lead=())
    _close(tpost.sigma(), jpost.sigma())
    _close(tpost.precision(), jpost.precision())
    assert tpost.n_params() == jpost.n_params() == 784 * 8 + 8 + 8 * 8 + 8 + 8 * 10 + 10


def test_sample_with_injected_noise_matches_jax():
    jpost, tpost = _posteriors(2, lead=())
    key = jax.random.key(11)
    want = jpost.sample(key)
    leaves, treedef = jax.tree.flatten(jpost.mean)  # the reference's draws, leaf by leaf
    keys = jax.random.split(key, len(leaves))
    noise = jax.tree.unflatten(treedef, [np.array(jax.random.normal(k, l.shape, l.dtype))
                                         for k, l in zip(keys, leaves)])
    got = tp.GaussianPosterior.sample(tpost, noise=jax.tree.map(torch.from_numpy, noise))
    _close(got, want)


def test_sample_draws_leaves_in_sorted_key_order():
    mean = {"z": torch.zeros(3), "a": torch.zeros(2)}
    post = tp.GaussianPosterior(mean, {"z": torch.full((3,), 100.0), "a": torch.full((2,), 100.0)})
    got = post.sample(torch.Generator().manual_seed(4))
    eps = torch.randn(2, generator=torch.Generator().manual_seed(4))  # "a" draws first
    torch.testing.assert_close(got["a"], 100.0 * eps, rtol=1e-6, atol=0.0)


def test_kl_gaussian_pytree_matches_jax_and_the_flat_form():
    jq, tq = _posteriors(3, lead=())
    jpr, tpr = _posteriors(4, lead=())
    want = float(jp.kl_gaussian(jq, jpr))
    got = tp.kl_gaussian(tq, tpr)
    assert got.shape == () and np.isclose(float(got), want, rtol=TOL)
    layout = FlatLayout.for_pytree(tq.mean)
    flat = tp.kl_gaussian(FlatPosterior(layout.flatten(tq.mean), layout.flatten(tq.rho), layout),
                          FlatPosterior(layout.flatten(tpr.mean), layout.flatten(tpr.rho),
                                        layout))
    assert flat.shape == () and np.isclose(float(flat), want, rtol=TOL)


def test_consensus_mean_field_matches_jax():
    jpost, tpost = _posteriors(5)
    w = np.asarray([0.25, 0.5, 0.25], np.float32)
    want = jp.consensus_mean_field(jpost, jnp.asarray(w))
    got = tp.consensus_mean_field(tpost, torch.from_numpy(w))
    _close(got.mean, want.mean)
    _close(got.rho, want.rho)
    assert got.mean["w1"].shape == (784, 8)


@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
def test_consensus_all_agents_pytree_matches_jax(wire):
    rng = np.random.default_rng(7)
    mean = _tree(rng, (9,), widths=(30, 8, 4))
    rho = {k: rng.uniform(-4.5, 0.5, size=v.shape).astype(np.float32) for k, v in mean.items()}
    W = grid_w(3, 3)
    want = jp.consensus_all_agents(
        jp.GaussianPosterior(jax.tree.map(jnp.asarray, mean), jax.tree.map(jnp.asarray, rho)),
        jnp.asarray(W, jnp.float32), wire_dtype=wire)
    got = tp.consensus_all_agents(tp.posterior_from_numpy(mean, rho), W, wire_dtype=wire)
    assert isinstance(got, tp.GaussianPosterior)
    tol = TOL + 2 * wire_error_bound(wire)
    _close(got.mean, want.mean, tol)
    _close(got.rho, want.rho, tol)


def test_consensus_all_agents_still_takes_the_flat_posterior():
    jpost, tpost = _posteriors(8, lead=(3,))
    layout = FlatLayout.for_pytree(tpost.mean, leading_axes=1)
    flat = FlatPosterior(layout.flatten(tpost.mean), layout.flatten(tpost.rho), layout)
    W = np.asarray([[0.5, 0.5, 0.0], [0.25, 0.5, 0.25], [0.0, 0.5, 0.5]], np.float32)
    got = tp.consensus_all_agents(flat, torch.from_numpy(W))
    assert isinstance(got, FlatPosterior)
    tree = tp.consensus_all_agents(tpost, W)
    np.testing.assert_allclose(got.mean.numpy(), layout.flatten(tree.mean).numpy(),
                               rtol=TOL, atol=TOL)
    with pytest.raises(TypeError):
        tp.consensus_all_agents(object(), W)


def test_consensus_mean_only_pytree_matches_jax():
    rng = np.random.default_rng(9)
    params = _tree(rng, (9,), widths=(12, 5, 3))
    W = grid_w(3, 3)
    want = jp.consensus_mean_only(jax.tree.map(jnp.asarray, params), jnp.asarray(W, jnp.float32))
    got = tp.consensus_mean_only(jax.tree.map(torch.from_numpy, params), W)
    _close(got, want)
    x = torch.from_numpy(rng.normal(size=(9, 6)).astype(np.float32))  # the flat form
    torch.testing.assert_close(tp.consensus_mean_only(x, torch.from_numpy(W).float()),
                               torch.from_numpy(W).float() @ x)
