"""The synchronous BbB round of repro_torch against the JAX package, through
the front door (``build_session`` -> ``Session.round/evaluate/health``) on
the quickstart spec (examples/quickstart.py) at hidden 8, on the CPU.

The port cannot replay JAX's threefry streams, so the tests replay the JAX
session's key chain here and inject the draws through the port's noise seam:

* batch indices: session key -> k_batch -> one key per agent ->
  ``randint(k_a, (u*B,), 0, n_a)`` (repro/data/pipeline.py:68-72);
* BbB noise: k_round -> one key per agent -> one per local step -> one per
  MC sample -> ``normal(k, (P,))`` (simulated.py:128 -> bayes_by_backprop.py
  :98 -> :59 -> flat.py:223);
* evaluate(): ``split(key(99), n_mc)`` -> ``normal(k, (P,))`` (session.py:546).

Tolerance atol 1e-5 (rtol 1e-5 on values of order 10 and more): fp32 matmul
order differs, and Adam divides by sqrt(v), which magnifies differences of
tiny gradients.  The compared rounds start from a JAX state that has run one
round: from the zero Adam state of round 0, the KL gradient of a unit that
no sample activates is pure rounding noise (q == prior at the first step),
which Adam scales to a +-lr step whose sign depends on each framework's
autodiff op order.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api.spec as jspec  # noqa: E402
import repro_torch.api.spec as tspec  # noqa: E402
from repro.api import build_session as jbuild  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.api import build_session as tbuild  # noqa: E402
from repro_torch.core.simulated import network_state_from_numpy, run_rounds  # noqa: E402

DATA = dict(n_classes=4, dim=32, n_train_per_class=150)
PART = dict(center_labels=[1, 2, 3], edge_labels=[0], n_edge=3)
U, B = 4, 16


def _spec(mod, consensus="gaussian", n_mc_samples=1):
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.star(n_edge=3, a=0.5),
        data=mod.DataSpec(dataset_params=DATA, partition="star", partition_params=PART,
                          batch_size=B, local_updates=U),
        inference=mod.InferenceSpec(hidden=8, depth=1, lr=5e-3, kl_scale=1e-3,
                                    consensus=consensus, n_mc_samples=n_mc_samples),
        run=mod.RunSpec(n_rounds=3, seed=0),
    )


def _shard_sizes():
    ds = jsyn.make_synthetic_classification(**DATA)
    return [len(y) for _, y in jpart.star_partition(ds.x_train, ds.y_train, **PART)]


def _replay_round_draws(session, n_samples):
    """The batch indices [N, U*B] and BbB noise [N, U, S, P] the JAX session's
    next round() will draw."""
    n, p = session.state.posterior.mean.shape
    _, k_batch, k_round = jax.random.split(session.key, 3)
    idx = np.stack([
        np.asarray(jax.random.randint(k, (U * B,), 0, n_a))
        for k, n_a in zip(jax.random.split(k_batch, n), _shard_sizes())
    ])
    eps = np.empty((n, U, n_samples, p), np.float32)
    for a, k_a in enumerate(jax.random.split(k_round, n)):
        for t, k_t in enumerate(jax.random.split(k_a, U)):
            for s, k_s in enumerate(jax.random.split(k_t, n_samples)):
                eps[a, t, s] = np.asarray(jax.random.normal(k_s, (p,), jnp.float32))
    return idx, eps


def _carry(jstate, layout):
    post, opt = jstate.posterior, jstate.opt_state
    return network_state_from_numpy(
        np.asarray(post.mean), np.asarray(post.rho), layout=layout,
        mu=(np.asarray(opt.mu.mean), np.asarray(opt.mu.rho)),
        nu=(np.asarray(opt.nu.mean), np.asarray(opt.nu.rho)),
        step=np.asarray(jstate.step), round=np.asarray(jstate.round), device="cpu",
    )


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.numpy() if hasattr(got, "numpy") else got,
                               np.asarray(want), rtol=1e-5, atol=atol)


def _sessions(consensus="gaussian", n_mc_samples=1):
    js = jbuild(_spec(jspec, consensus, n_mc_samples))
    ts = tbuild(_spec(tspec, consensus, n_mc_samples), device="cpu")
    return js, ts


def test_layout_columns_match_jax():
    js, ts = _sessions()
    jl, tl = js.state.posterior.layout, ts.posterior().layout
    assert [(s.path, s.shape, s.offset, s.size) for s in tl.specs] == [
        (s.path, s.shape, s.offset, s.size) for s in jl.specs
    ]
    assert [s.path for s in tl.specs] == ["['b1']", "['b2']", "['w1']", "['w2']"]
    assert tl.n_params == jl.n_params


def test_network_state_from_numpy_carries_a_jax_state():
    js, ts = _sessions()
    js.round()
    state = _carry(js.state, ts.posterior().layout)
    jpost = js.state.posterior
    np.testing.assert_array_equal(state.posterior.mean.numpy(), np.asarray(jpost.mean))
    np.testing.assert_array_equal(state.opt_state.nu.rho.numpy(),
                                  np.asarray(js.state.opt_state.nu.rho))
    assert state.step.tolist() == np.asarray(js.state.step).tolist() == [U] * 4
    assert int(state.round) == 1
    # per-leaf views land in the JAX columns: w1 of agent 2 is the same matrix
    want = np.asarray(jpost.layout.unflatten(jpost.mean)["w1"])
    got = state.posterior.layout.unflatten(state.posterior.mean)["w1"]
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="layout"):
        network_state_from_numpy(np.zeros((4, 3)), np.zeros((4, 3)),
                                 layout=state.posterior.layout)


def test_injected_init_matches_jax_init():
    js, _ = _sessions()
    _, k_init = jax.random.split(jax.random.key(0))
    params = {k: torch.from_numpy(np.array(v)) for k, v in js.model.init_fn(k_init).items()}
    ts = tbuild(_spec(tspec), device="cpu", init_params=params)
    np.testing.assert_array_equal(ts.posterior().mean.numpy(), np.asarray(js.state.posterior.mean))
    np.testing.assert_array_equal(ts.posterior().rho.numpy(), np.asarray(js.state.posterior.rho))


@pytest.mark.parametrize("consensus,n_mc_samples", [
    ("gaussian", 1), ("gaussian", 2), ("mean_only", 1), ("none", 1),
])
def test_round_matches_jax_with_injected_draws(consensus, n_mc_samples):
    js, ts = _sessions(consensus, n_mc_samples)
    js.round()  # leave the zero Adam state (module docstring)
    ts.state = _carry(js.state, ts.posterior().layout)
    ts.round_idx = js.round_idx
    for _ in range(2):  # the port runs on from its own state
        idx, eps = _replay_round_draws(js, n_mc_samples)
        jrec = js.round()
        trec = ts.round(batch_idx=idx, eps=eps)
        jst, tst = js.state, ts.state
        assert abs(trec["loss"] - jrec["loss"]) <= 1e-5 * max(1.0, abs(jrec["loss"]))
        _close(tst.posterior.mean, jst.posterior.mean)
        _close(tst.posterior.rho, jst.posterior.rho)
        _close(tst.opt_state.mu.mean, jst.opt_state.mu.mean)
        _close(tst.opt_state.mu.rho, jst.opt_state.mu.rho)
        _close(tst.opt_state.nu.mean, jst.opt_state.nu.mean)
        _close(tst.opt_state.nu.rho, jst.opt_state.nu.rho)
        assert tst.step.tolist() == np.asarray(jst.step).tolist()
        assert int(tst.round) == int(jst.round)


def test_per_agent_losses_match_jax():
    js, ts = _sessions()
    js.round()
    ts.state = _carry(js.state, ts.posterior().layout)
    idx, eps = _replay_round_draws(js, 1)
    _, k_batch, k_round = jax.random.split(js.key, 3)
    batches = js.data.sampler(k_batch, js.round_idx)
    W = jnp.asarray(js.spec.topology.w_schedule()(0))
    _, jlosses = js.engine.run_round(js.state, batches, W, k_round)
    trec = ts.round(batch_idx=idx, eps=eps)
    np.testing.assert_allclose(trec["losses"], np.asarray(jlosses), rtol=1e-5, atol=1e-5)


def _mc_noise(n_mc, p, key=99):
    return np.stack([np.asarray(jax.random.normal(k, (p,), jnp.float32))
                     for k in jax.random.split(jax.random.key(key), n_mc)])


def test_evaluate_and_predictive_match_jax_with_injected_noise():
    js, ts = _sessions()
    for _ in range(2):
        js.round()
    ts.state = _carry(js.state, ts.posterior().layout)
    p = ts.posterior().n_params()
    jev = js.evaluate(n_mc=4)
    tev = ts.evaluate(n_mc=4, eps=_mc_noise(4, p))
    assert tev["acc"] == jev["acc"]
    assert tev["avg_acc"] == pytest.approx(jev["avg_acc"], abs=1e-12)
    x = np.asarray(js.data.x_test[:32])
    jprobs = js.predictive(2, x, n_mc=3, key=jax.random.key(5))
    tprobs = ts.predictive(2, x, n_mc=3, eps=_mc_noise(3, p, key=5))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.predictive(1, x, n_mc=0).numpy(),
                               np.asarray(js.predictive(1, x, n_mc=0)), rtol=1e-5, atol=1e-6)


def test_health_matches_jax_including_a_poisoned_agent():
    js, ts = _sessions()
    js.round()
    ts.state = _carry(js.state, ts.posterior().layout)
    assert ts.health() == js.health()
    mean = np.asarray(js.state.posterior.mean).copy()
    mean[2, 7] = np.nan
    js.state.posterior.mean = jnp.asarray(mean)
    ts.state.posterior.mean = torch.from_numpy(mean)
    h = ts.health()
    assert h == js.health()
    assert h["ok"] == [True, True, False, True] and h["n_healthy"] == 3


def test_port_session_trains_on_its_own_draws():
    """Without injection the port draws from its own generator: a seed fixes
    the run, and ``run_rounds`` drives the same transition as ``Session``."""
    a = tbuild(_spec(tspec), device="cpu")
    b = tbuild(_spec(tspec), device="cpu")
    ha = a.run(eval_every=1, eval_fn=lambda s: s.evaluate(n_mc=2))
    hb = b.run(eval_every=1, eval_fn=lambda s: s.evaluate(n_mc=2))
    assert [r["loss"] for r in ha] == [r["loss"] for r in hb]
    assert [r["avg_acc"] for r in ha] == [r["avg_acc"] for r in hb]
    assert len(ha) == 3 and np.isfinite([r["loss"] for r in ha]).all()
    assert torch.equal(a.posterior().mean, b.posterior().mean)
    assert a.round_idx == 3 and a.health()["all_ok"]

    c = tbuild(_spec(tspec), device="cpu")
    state, hist = run_rounds(
        c.engine.run_round, c.state, c.data.sampler, c.spec.topology.w_schedule(),
        n_rounds=3, generator=c.generator, eval_every=1,
    )
    assert [r["loss"] for r in hist] == pytest.approx([r["loss"] for r in ha], abs=0)
    assert torch.equal(state.posterior.mean, a.posterior().mean)


def test_build_session_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbuild(_spec(tspec))


def test_later_slices_raise_not_implemented():
    """The launch engine's slice arrived: it builds, as the sharded ppermute
    execution does (tests/test_torch_gossip.py, tests/test_torch_sharded.py)."""
    spec = _spec(tspec)
    launch = tbuild(dataclasses.replace(spec, run=tspec.RunSpec(engine="launch")), device="cpu")
    assert launch.engine.name == "launch" and type(launch.state).__name__ == "BayesTrainState"
    lin = tspec.ExperimentSpec(
        topology=tspec.TopologySpec.complete(4),
        data=tspec.DataSpec(dataset="linreg"),
        inference=tspec.InferenceSpec(method="conjugate_linreg"),
    )
    assert tbuild(lin, device="cpu").engine.name == "conjugate_linreg"  # its slice arrived


def test_agent_blocks_size_the_local_step():
    from repro_torch.vi.bayes_by_backprop import agent_blocks

    assert [(b.start, b.stop) for b in agent_blocks(4_200, 199_210)] == \
        [(0, 1050), (1050, 2100), (2100, 3150), (3150, 4200)]
    assert agent_blocks(9, 199_210) == [slice(0, 9)]
    assert agent_blocks(10_000, 90) == [slice(0, 10_000)]


@pytest.mark.parametrize("agents_per_block", [1, 2, 3])
def test_agent_blocks_match_one_block(monkeypatch, agents_per_block):
    """Two rounds whose local steps run over agent blocks agree with the
    one-block rounds within atol 1e-6 (every op is per agent; the CPU's
    batched matmul sums in another fp32 order for another batch size), and
    the blocked rounds are the same bits run to run."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.vi import bayes_by_backprop as bbb

    def run():
        s = tbuild(_spec(tspec), device="cpu")
        s.run(n_rounds=2)
        return s.state

    whole = run()
    p = whole.posterior.mean.shape[1]
    monkeypatch.setattr(bbb, "AGENT_BLOCK_BYTES", agents_per_block * 4 * p)
    assert len(bbb.agent_blocks(4, p)) == -(-4 // agents_per_block)
    blocked, again = run(), run()
    for a, b, c in zip(tree_leaves(whole), tree_leaves(blocked), tree_leaves(again)):
        a, b, c = (torch.as_tensor(x) for x in (a, b, c))
        assert torch.equal(b, c)
        torch.testing.assert_close(b.double(), a.double(), rtol=1e-5, atol=1e-6)
