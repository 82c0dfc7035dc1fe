"""The public helpers the port adds beside its vi/optim/numerics modules,
each against its JAX counterpart on the same inputs, on the CPU:
``vi.free_energy_and_grad`` (JAX's own MC noise through the ``eps`` seam)
and ``vi.predictive_confidence``; ``optim.global_norm`` and
``optim.clip_by_global_norm`` (tests/test_steps_and_substrate.py:211);
``core.numerics.wire_cast_pair`` (its f32 identity: the same objects).
Tolerances: rtol/atol 1e-5 where fp32 sums run in another order; bitwise
where the arithmetic is one cast or one comparison."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.numerics as jnum  # noqa: E402
import repro.optim as joptim  # noqa: E402
import repro.vi as jvi  # noqa: E402
import repro_torch.core.numerics as tnum  # noqa: E402
import repro_torch.optim as toptim  # noqa: E402
import repro_torch.vi as tvi  # noqa: E402
from repro.api.models import build_model as jmodel  # noqa: E402
from repro.core.flat import FlatPosterior as JFlat  # noqa: E402
from repro.core.flat import init_flat_posterior as jinit  # noqa: E402
from repro_torch.api.models import build_model as tmodel  # noqa: E402
from repro_torch.core.flat import FlatPosterior as TFlat  # noqa: E402
from repro_torch.core.flat import init_flat_posterior as tinit  # noqa: E402
from repro_torch.core.flat import make_flat_nll  # noqa: E402
from repro_torch.optim import AdamState  # noqa: E402

DIM, HIDDEN, C, BATCH = 6, 5, 3, 7


def _pair(seed):
    """One agent's posterior and a prior in both packages, same numbers."""
    rng = np.random.default_rng(seed)
    params = jmodel("mlp", DIM, C, hidden=HIDDEN, depth=1).init_fn(jax.random.key(seed))
    jpost = jinit(params)
    p = jpost.layout.n_params
    bufs = [rng.normal(0, s, p).astype(np.float32) for s in (0.5, 0.3, 0.5, 0.3)]
    bufs[1] += -2.5
    bufs[3] += -2.0
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    tlayout = tinit(tparams).layout
    j = [JFlat(jnp.asarray(bufs[i]), jnp.asarray(bufs[i + 1]), jpost.layout) for i in (0, 2)]
    t = [TFlat(torch.from_numpy(bufs[i])[None], torch.from_numpy(bufs[i + 1])[None], tlayout)
         for i in (0, 2)]
    batch = {"x": rng.normal(size=(BATCH, DIM)).astype(np.float32),
             "y": rng.integers(0, C, BATCH).astype(np.int32)}
    return j, t, batch


@pytest.mark.parametrize("n_samples,kl_scale", [(1, 1.0), (3, 1e-3), (4, 0.0)])
def test_free_energy_and_grad_matches_jax(n_samples, kl_scale):
    (jpost, jprior), (tpost, tprior), batch = _pair(n_samples)
    jm = jmodel("mlp", DIM, C, hidden=HIDDEN, depth=1)
    key = jax.random.key(11)
    jval, jgrad = jvi.free_energy_and_grad(
        jpost, jprior, lambda th, b: jm.nll_fn(jpost.layout.unflatten(th), b),
        {k: jnp.asarray(v) for k, v in batch.items()}, key, n_samples, kl_scale)
    p = jpost.layout.n_params
    eps = np.stack([np.asarray(jax.random.normal(k, (p,), jnp.float32))
                    for k in jax.random.split(key, n_samples)])
    tm = tmodel("mlp", DIM, C, hidden=HIDDEN, depth=1)
    before = tpost.mean.clone()
    tval, tgrad = tvi.free_energy_and_grad(
        tpost, tprior, make_flat_nll(tm.nll_fn, tpost.layout),
        {k: torch.from_numpy(v)[None] for k, v in batch.items()},
        torch.from_numpy(eps)[None], kl_scale)
    assert isinstance(tgrad, TFlat) and tgrad.layout is tpost.layout
    assert tval.shape == (1,) and not tval.requires_grad
    np.testing.assert_allclose(tval.numpy()[0], float(jval), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgrad.mean[0].numpy(), np.asarray(jgrad.mean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgrad.rho[0].numpy(), np.asarray(jgrad.rho), rtol=1e-5, atol=1e-5)
    assert torch.equal(tpost.mean, before) and not tpost.mean.requires_grad
    # the value is vi.free_energy's, bitwise
    again = tvi.free_energy(tpost, tprior, make_flat_nll(tm.nll_fn, tpost.layout),
                            {k: torch.from_numpy(v)[None] for k, v in batch.items()},
                            torch.from_numpy(eps)[None], kl_scale)
    assert torch.equal(tval, again.detach())


def test_free_energy_and_grad_is_per_agent():
    """Agents are independent: a batch of two agents' gradients are each
    one agent's alone."""
    (_, _), (tpost, tprior), batch = _pair(5)
    tm = tmodel("mlp", DIM, C, hidden=HIDDEN, depth=1)
    nll = make_flat_nll(tm.nll_fn, tpost.layout)
    two = TFlat(torch.cat([tpost.mean, tprior.mean]), torch.cat([tpost.rho, tprior.rho]),
                tpost.layout)
    prior2 = TFlat(two.mean.flip(0), two.rho.flip(0), two.layout)
    b2 = {k: torch.from_numpy(np.stack([v, v[::-1].copy()])) for k, v in batch.items()}
    eps = torch.randn((2, 2, tpost.layout.n_params), generator=torch.Generator().manual_seed(0))
    val, grad = tvi.free_energy_and_grad(two, prior2, nll, b2, eps)
    for a in range(2):
        one = TFlat(two.mean[a:a + 1], two.rho[a:a + 1], two.layout)
        pa = TFlat(prior2.mean[a:a + 1], prior2.rho[a:a + 1], two.layout)
        v1, g1 = tvi.free_energy_and_grad(one, pa, nll, {k: v[a:a + 1] for k, v in b2.items()},
                                          eps[a:a + 1])
        np.testing.assert_allclose(val[a].numpy(), v1[0].numpy(), rtol=1e-6)
        np.testing.assert_allclose(grad.mean[a].numpy(), g1.mean[0].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(5, 3), (2, 7, 4), (1, 10)])
def test_predictive_confidence_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    probs = rng.dirichlet(np.ones(shape[-1]), size=shape[:-1]).astype(np.float32)
    probs[..., 0] = probs[..., 1]  # a tie: both take the first maximum
    jp, jc = jvi.predictive_confidence(jnp.asarray(probs))
    tp, tc = tvi.predictive_confidence(torch.from_numpy(probs))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _adam_like(seed):
    rng = np.random.default_rng(seed)
    bufs = [rng.normal(0, 3, (3, 17)).astype(np.float32) for _ in range(4)]
    (jpost, _), (tpost, _), _ = _pair(0)
    jt = joptim.adam().init(jnp.zeros(1))  # AdamState type of the JAX package
    jstate = type(jt)(mu=JFlat(jnp.asarray(bufs[0]), jnp.asarray(bufs[1]), jpost.layout),
                      nu=JFlat(jnp.asarray(bufs[2]), jnp.asarray(bufs[3]), jpost.layout))
    tstate = AdamState(mu=TFlat(*(torch.from_numpy(b) for b in bufs[:2]), tpost.layout),
                       nu=TFlat(*(torch.from_numpy(b) for b in bufs[2:]), tpost.layout))
    return jstate, tstate


@pytest.mark.parametrize("tree", ["tensor", "flat_posterior", "adam_state"])
def test_global_norm_matches_jax(tree):
    jstate, tstate = _adam_like(1)
    j, t = {"tensor": (jstate.mu.mean, tstate.mu.mean),
            "flat_posterior": (jstate.nu, tstate.nu),
            "adam_state": (jstate, tstate)}[tree]
    np.testing.assert_allclose(float(toptim.global_norm(t)), float(joptim.global_norm(j)),
                               rtol=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e4])
def test_clip_by_global_norm_matches_jax(max_norm):
    jstate, tstate = _adam_like(2)
    jc = joptim.clip_by_global_norm(jstate, max_norm)
    tc = toptim.clip_by_global_norm(tstate, max_norm)
    assert isinstance(tc, AdamState) and tc.mu.layout is tstate.mu.layout
    for jl, tl in zip(jax.tree.leaves(jc), (tc.mu.mean, tc.mu.rho, tc.nu.mean, tc.nu.rho)):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-7)
    if max_norm == 1e4:  # under the cap: unchanged
        assert torch.equal(tc.nu.rho, tstate.nu.rho)


def test_clip_pins_the_reference_test():
    """tests/test_steps_and_substrate.py:211 on the port."""
    clipped = toptim.clip_by_global_norm(torch.full((4,), 10.0), 1.0)
    assert np.isclose(float(toptim.global_norm(clipped)), 1.0, rtol=1e-5)


@pytest.mark.parametrize("wire", ["f32", "bf16", "f16", None])
def test_wire_cast_pair_matches_jax(wire):
    rng = np.random.default_rng(0)
    prec = (rng.random((3, 9)) * 1e3 + 1e-3).astype(np.float32)
    pm = rng.normal(size=(3, 9)).astype(np.float32) * 50
    tp, tq = torch.from_numpy(prec), torch.from_numpy(pm)
    jp, jq = jnum.wire_cast_pair(jnp.asarray(prec), jnp.asarray(pm), wire)
    cp, cq = tnum.wire_cast_pair(tp, tq, wire)
    if wire in ("f32", None):
        assert cp is tp and cq is tq  # the structural identity
    assert str(cp.dtype).removeprefix("torch.") == jnp.dtype(jp.dtype).name
    np.testing.assert_array_equal(cp.float().numpy(), np.asarray(jp.astype(jnp.float32)))
    np.testing.assert_array_equal(cq.float().numpy(), np.asarray(jq.astype(jnp.float32)))
