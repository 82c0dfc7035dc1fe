"""Paper Example 1 in repro_torch (``ConjugateLinregEngine``,
``FullCovGaussian``, ``linreg_bayes_update``, ``consensus_full_cov``)
against the JAX package, on the CPU.

The sampler's per-round numpy seed is the one draw of a conjugate round; the
port cannot replay JAX's threefry stream, so the tests replay the JAX
session's key chain (``split(key, 3)`` -> ``randint(k_batch, (), 0,
2**31 - 1)``, repro/api/session.py:195, repro/api/data.py:94) and inject the
seed through ``Session.round(batch_seed=)``.  The batches are then equal
bit for bit, and what differs is fp32 summation order.

Tolerances: the mean to ``rtol=1e-5, atol=1e-6``.  The precision, at the
default gaussian consensus, to the same elementwise; under every consensus
mode, ``|dprec_ij| <= 1e-6 * sqrt(prec_ii * prec_jj)``: an fp32 sum of
``phi_i phi_j`` rounds in proportion to ``sum |phi_i phi_j| <= sqrt(prec_ii
prec_jj)``, not to ``|prec_ij|``, which cancels in the off-diagonal entries
(measured over the 60 rounds: 4.4e-7 of that scale; elementwise, an
off-diagonal entry of -0.0041 without consensus is 1.1e-6 off).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.core import posterior as jpost  # noqa: E402
from repro_torch.core import FullCovGaussian, consensus_full_cov, linreg_bayes_update  # noqa: E402

N_ROUNDS = 60


def _spec(mod, consensus="gaussian", n_rounds=N_ROUNDS, seed=0):
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.complete(4),
        data=mod.DataSpec(dataset="linreg", batch_size=10),
        inference=mod.InferenceSpec(method="conjugate_linreg", consensus=consensus),
        run=mod.RunSpec(n_rounds=n_rounds, seed=seed),
    )


def _next_batch_seed(js) -> int:
    _, k_batch, _ = jax.random.split(js.key, 3)
    return int(jax.random.randint(k_batch, (), 0, np.iinfo(np.int32).max))


def _assert_prec_close(got, want, elementwise):
    got, want = np.asarray(got), np.asarray(want)
    diag = np.sqrt(np.einsum("...ii->...i", want))
    scale = diag[..., :, None] * diag[..., None, :]
    assert np.all(np.abs(got - want) <= 1e-6 * scale), np.max(np.abs(got - want) / scale)
    if elementwise:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("consensus", ["gaussian", "none"])
def test_conjugate_rounds_match_jax_with_injected_seeds(consensus):
    js = japi.build_session(_spec(japi, consensus))
    ts = tapi.build_session(_spec(tapi, consensus), device="cpu")
    assert isinstance(ts.engine, tapi.ConjugateLinregEngine)
    np.testing.assert_array_equal(ts.state.prec.numpy(), np.asarray(js.state.prec))
    for _ in range(N_ROUNDS):
        seed = _next_batch_seed(js)
        jrec = js.round()
        trec = ts.round(batch_seed=seed)
        np.testing.assert_allclose(ts.state.mean.numpy(), np.asarray(js.state.mean),
                                   rtol=1e-5, atol=1e-6)
        _assert_prec_close(ts.state.prec, js.state.prec, consensus == "gaussian")
        assert trec["loss"] == pytest.approx(jrec["loss"], rel=1e-5, abs=1e-6)
    jev, tev = js.evaluate(), ts.evaluate()
    np.testing.assert_allclose(tev["mse"], jev["mse"], rtol=1e-5)
    assert ts.health() == js.health()


def test_the_sampler_is_jaxs_on_the_same_seed():
    js = japi.build_session(_spec(japi))
    ts = tapi.build_session(_spec(tapi), device="cpu")
    jb = js.data.sampler(jax.random.key(3), 0)
    seed = int(jax.random.randint(jax.random.key(3), (), 0, np.iinfo(np.int32).max))
    tb = ts.data.sampler(ts.generator, 0, seed=seed)
    for k in ("phi", "y"):
        assert tb[k].dtype == torch.float32
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    np.testing.assert_array_equal(ts.data.test_phi, js.data.test_phi)
    np.testing.assert_array_equal(ts.data.test_y, js.data.test_y)


def test_conjugate_linreg_session_reaches_noise_floor():
    """tests/test_api.py:262 in the port, on its own generator's seeds."""
    s = tapi.build_session(_spec(tapi), device="cpu")
    s.run()
    ev = s.evaluate()
    noise_floor = float(s.data.dataset.noise_std) ** 2
    assert ev["avg_mse"] < noise_floor * 1.2, ev
    assert len(ev["mse"]) == 4 and s.health()["all_ok"]
    again = tapi.build_session(_spec(tapi), device="cpu")
    again.run()
    assert torch.equal(again.state.mean, s.state.mean)  # a seed fixes the run


def test_linreg_requires_conjugate_method():
    """tests/test_api.py:276 in the port."""
    with pytest.raises(ValueError, match="conjugate_linreg"):
        tapi.ExperimentSpec(data=tapi.DataSpec(dataset="linreg")).validate()


def test_linreg_session_refuses_predictive_and_keeps_its_axes():
    s = tapi.build_session(_spec(tapi), device="cpu")
    s.round()
    with pytest.raises(ValueError, match="classification model"):
        s.predictive(0, np.zeros((2, 5), np.float32))
    one = s.agent_posterior(2)
    assert isinstance(one, FullCovGaussian)
    assert tuple(one.mean.shape) == (5,) and tuple(one.prec.shape) == (5, 5)


def test_health_flags_a_non_finite_agent():
    s = tapi.build_session(_spec(tapi), device="cpu")
    s.round()
    s.state.prec[1, 2, 3] = float("nan")
    h = s.health()
    assert h["ok"] == [True, False, True, True] and h["n_healthy"] == 3


def _spd(rng, n, d):
    a = rng.normal(0, 1, (n, d, d)).astype(np.float32)
    return (np.einsum("nij,nkj->nik", a, a) + d * np.eye(d, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linreg_bayes_update_matches_jax(seed):
    rng = np.random.default_rng(seed)
    d, b = 5, 12
    prec = _spd(rng, 1, d)[0]
    mean = rng.normal(0, 1, d).astype(np.float32)
    phi = rng.normal(0, 1, (b, d)).astype(np.float32)
    y = rng.normal(0, 1, b).astype(np.float32)
    want = jpost.linreg_bayes_update(jpost.FullCovGaussian(jnp.asarray(mean), jnp.asarray(prec)),
                                     jnp.asarray(phi), jnp.asarray(y), 0.64)
    got = linreg_bayes_update(FullCovGaussian(torch.from_numpy(mean), torch.from_numpy(prec)),
                              torch.from_numpy(phi), torch.from_numpy(y), 0.64)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-6)
    _assert_prec_close(got.prec, want.prec, elementwise=True)
    # the batched form is the reference's vmap over agents
    stacked = linreg_bayes_update(
        FullCovGaussian(torch.from_numpy(np.stack([mean, mean])),
                        torch.from_numpy(np.stack([prec, prec]))),
        torch.from_numpy(np.stack([phi, phi])), torch.from_numpy(np.stack([y, y])), 0.64)
    assert torch.equal(stacked.mean[1], got.mean) and torch.equal(stacked.prec[0], got.prec)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consensus_full_cov_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    n, d = 4, 5
    prec = _spd(rng, n, d)
    mean = rng.normal(0, 1, (n, d)).astype(np.float32)
    w = rng.random((n, n)).astype(np.float32) + 0.1
    w = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    want = jpost.consensus_full_cov(jpost.FullCovGaussian(jnp.asarray(mean), jnp.asarray(prec)),
                                    jnp.asarray(w))
    got = consensus_full_cov(FullCovGaussian(torch.from_numpy(mean), torch.from_numpy(prec)),
                             torch.from_numpy(w))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-6)
    _assert_prec_close(got.prec, want.prec, elementwise=True)


def test_full_cov_cov_and_sample():
    rng = np.random.default_rng(5)
    prec = torch.from_numpy(_spd(rng, 1, 5)[0])
    post = FullCovGaussian(torch.zeros(5), prec)
    np.testing.assert_allclose((post.cov() @ prec).numpy(), np.eye(5), atol=1e-5)
    eps = torch.from_numpy(rng.normal(0, 1, 5).astype(np.float32))
    jsample = jpost.FullCovGaussian(jnp.zeros(5), jnp.asarray(prec.numpy()))
    chol = np.linalg.cholesky(np.asarray(jsample.cov()))
    np.testing.assert_allclose(post.sample(eps=eps).numpy(), chol @ eps.numpy(), rtol=1e-4,
                               atol=1e-6)
    draws = post.sample(torch.Generator().manual_seed(0))
    assert draws.shape == (5,) and torch.isfinite(draws).all()
