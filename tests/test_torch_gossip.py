"""The gossip runtime of repro_torch (``TopologySpec.gossip`` ->
``build_session`` -> ``GossipEngine``) against the JAX package on the CPU,
on examples/async_gossip.py's spec at hidden 8: strict, chaos + quarantine,
and ``local_policy="active"``.

The port cannot replay JAX's threefry streams, so, as in
tests/test_torch_round.py, the tests replay the JAX session's key chain and
inject the draws (batch indices and BbB noise) through the port's seams.
The compared windows start from a JAX state carried across once every agent
has trained (a first local step from a zero Adam state at q == prior turns
rounding-noise gradients into +-lr steps whose sign is each framework's
own; tests/test_torch_round.py says more).  Tolerance atol 1e-5 (rtol 1e-5):
fp32 reduction order.  Telemetry, step counters and the quarantine counts
are equal.  The bitwise rungs of the equivalence ladder are asserted inside
the port only, never across the packages.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api.spec as jspec  # noqa: E402
import repro_torch.api.spec as tspec  # noqa: E402
from repro.api import build_session as jbuild  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.api import build_session as tbuild  # noqa: E402
from repro_torch.gossip import GossipEngine, gossip_state_from_numpy  # noqa: E402
from repro_torch.gossip.clocks import _directed_edges  # noqa: E402
from repro_torch.core.graphs import bidirectional_ring_w  # noqa: E402

N = 8
U, B = 4, 16
DATA = dict(n_classes=4, dim=32, n_train_per_class=120)
LABELS = [[c] for c in range(4) for _ in range(2)]
UNRELIABLE = {"kind": "failure_injected", "inner": {"kind": "poisson", "rate": 0.8, "seed": 0},
              "drop_rate": 0.1}
CHAOS = dict(UNRELIABLE, faults={"crash_rate": 0.15, "recover_rate": 0.5, "corrupt_rate": 0.2,
                                 "corrupt_kind": "mix", "seed": 7})
CASES = {
    "strict": (UNRELIABLE, "strict"),
    "chaos_quarantine": (CHAOS, "quarantine"),
    "chaos_strict": (CHAOS, "strict"),
    "active_policy": (dict(UNRELIABLE, local_policy="active"), "strict"),
}


def _data(mod, n=N):
    labels = LABELS if n == N else [[c % 4] for c in range(n)]
    return mod.DataSpec(dataset_params=DATA, partition="by_label",
                        partition_params=dict(label_sets=labels), batch_size=B,
                        local_updates=U)


def _spec(mod, clock, policy="strict", base="bidirectional_ring", n=N, **inf):
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.gossip(base, {"n": n}, clock=clock),
        data=_data(mod, n),
        inference=mod.InferenceSpec(hidden=8, depth=1, lr=5e-3, kl_scale=1e-3,
                                    fault_policy=policy, **inf),
        run=mod.RunSpec(n_rounds=3, seed=0),
    )


def _shard_sizes():
    ds = jsyn.make_synthetic_classification(**DATA)
    return [len(y) for _, y in jpart.partition_by_label(ds.x_train, ds.y_train, LABELS)]


def _replay_round_draws(session):
    """The batch indices [N, U*B] and BbB noise [N, U, 1, P] the JAX
    session's next round() draws (repro/data/pipeline.py:68-72,
    simulated.py:128 -> bayes_by_backprop.py:98 -> :59)."""
    n, p = session.state.posterior.mean.shape
    _, k_batch, k_round = jax.random.split(session.key, 3)
    idx = np.stack([
        np.asarray(jax.random.randint(k, (U * B,), 0, n_a))
        for k, n_a in zip(jax.random.split(k_batch, n), _shard_sizes())
    ])
    eps = np.empty((n, U, 1, p), np.float32)
    for a, k_a in enumerate(jax.random.split(k_round, n)):
        for t, k_t in enumerate(jax.random.split(k_a, U)):
            (k_s,) = jax.random.split(k_t, 1)
            eps[a, t, 0] = np.asarray(jax.random.normal(k_s, (p,), jnp.float32))
    return idx, eps


def _carry(js, ts):
    st, opt = js.state, js.state.opt_state
    ts.state = gossip_state_from_numpy(
        np.asarray(st.posterior.mean), np.asarray(st.posterior.rho),
        layout=ts.posterior().layout,
        mu=(np.asarray(opt.mu.mean), np.asarray(opt.mu.rho)),
        nu=(np.asarray(opt.nu.mean), np.asarray(opt.nu.rho)),
        step=np.asarray(st.step), round=np.asarray(st.round),
        last_merge=np.asarray(st.last_merge), n_merges=np.asarray(st.n_merges),
        n_quarantined=(None if st.n_quarantined is None else np.asarray(st.n_quarantined)),
        device="cpu",
    )
    ts.round_idx = js.round_idx


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _assert_states_close(tst, jst):
    _close(tst.posterior.mean, jst.posterior.mean)
    _close(tst.posterior.rho, jst.posterior.rho)
    for m in ("mu", "nu"):
        for f in ("mean", "rho"):
            _close(getattr(getattr(tst.opt_state, m), f), getattr(getattr(jst.opt_state, m), f))
    for f in ("step", "last_merge", "n_merges"):
        assert getattr(tst, f).tolist() == np.asarray(getattr(jst, f)).tolist(), f
    assert int(tst.round) == int(jst.round)
    if jst.n_quarantined is None:
        assert tst.n_quarantined is None
    else:
        assert tst.n_quarantined.tolist() == np.asarray(jst.n_quarantined).tolist()


@pytest.mark.parametrize("case", sorted(CASES))
def test_gossip_windows_match_jax_with_injected_draws(case):
    clock, policy = CASES[case]
    js = jbuild(_spec(jspec, clock, policy))
    ts = tbuild(_spec(tspec, clock, policy), device="cpu")
    assert isinstance(ts.engine, GossipEngine)
    assert ts.spec.to_doc() == js.spec.to_doc()
    while int(np.asarray(js.state.step).min()) == 0:  # every agent has trained
        js.round()
    _carry(js, ts)
    for _ in range(2):
        idx, eps = _replay_round_draws(js)
        jrec = js.round()
        trec = ts.round(batch_idx=idx, eps=eps)
        for k in ("round", "n_trained", "n_crashed"):
            assert trec.get(k) == jrec.get(k), k
        if jrec["loss"] is None:
            assert trec["loss"] is None
        else:
            assert trec["loss"] == pytest.approx(jrec["loss"], rel=1e-5, abs=1e-5)
        _assert_states_close(ts.state, js.state)
    assert ts.engine.telemetry(ts.state) == js.engine.telemetry(js.state)
    p = ts.posterior().n_params()
    eps = np.stack([np.asarray(jax.random.normal(k, (p,), jnp.float32))
                    for k in jax.random.split(jax.random.key(99), 2)])
    jev, tev = js.evaluate(n_mc=2), ts.evaluate(n_mc=2, eps=eps)
    assert tev["engine"] == jev["engine"]
    assert tev["acc"] == jev["acc"]
    assert ts.health() == js.health()


def test_chaos_quarantine_contains_what_strict_spreads():
    """Under quarantine the injected NaN/Inf never reaches a resident
    posterior and the guard counts its drops; the same chaos under strict
    poisons agents."""
    q = tbuild(_spec(tspec, CHAOS, "quarantine"), device="cpu")
    s = tbuild(_spec(tspec, CHAOS, "strict"), device="cpu")
    recs = [q.round() for _ in range(5)]
    for _ in range(5):
        s.round()
    assert q.health()["all_ok"] and torch.isfinite(q.posterior().mean).all()
    assert s.health()["n_healthy"] < N
    tel = q.evaluate(n_mc=1)["engine"]["faults"]
    assert tel["policy"] == "quarantine" and tel["quarantined"]["total"] > 0
    assert sum(r["n_crashed"] for r in recs) > 0
    assert len(tel["uptime"]["per_agent"]) == N


def _ring_spec(mod, clock, n=4, **inf):
    return mod.ExperimentSpec(
        topology=mod.TopologySpec(kind="gossip", params={"base": "bidirectional_ring",
                                                         "base_params": {"n": n}},
                                  clock=clock),
        data=_data(mod, n), inference=mod.InferenceSpec(hidden=8, depth=1, lr=1e-2, **inf),
        run=mod.RunSpec(n_rounds=2, seed=0),
    )


def _assert_bitwise(a, b):
    assert torch.equal(a.posterior().mean, b.posterior().mean)
    assert torch.equal(a.posterior().rho, b.posterior().rho)
    assert torch.equal(a.state.opt_state.nu.rho, b.state.opt_state.nu.rho)
    assert torch.equal(a.state.step, b.state.step)


def test_all_edges_gossip_is_synchronous_bitwise():
    n = 4
    edges = [[int(i), int(j)] for i, j in _directed_edges(bidirectional_ring_w(n))]
    g = tbuild(_ring_spec(tspec, {"kind": "trace", "trace": [edges]}), device="cpu")
    sync_spec = dataclasses.replace(
        _ring_spec(tspec, {"kind": "trace", "trace": [edges]}),
        topology=tspec.TopologySpec(kind="bidirectional_ring", params={"n": n}))
    s = tbuild(sync_spec, device="cpu")
    g.run()
    s.run()
    _assert_bitwise(g, s)
    tel = g.evaluate(n_mc=1)["engine"]
    assert tel["staleness"]["max"] == 0 and tel["merges"]["min"] == 2


@pytest.mark.parametrize("policy", ["all", "active"])
def test_zero_fault_quarantine_is_strict_bitwise(policy):
    clock = {"kind": "poisson", "rate": 0.8, "seed": 3, "local_policy": policy}
    a = tbuild(_ring_spec(tspec, clock, n=5, fault_policy="strict"), device="cpu")
    b = tbuild(_ring_spec(tspec, clock, n=5, fault_policy="quarantine"), device="cpu")
    ra, rb = a.run(n_rounds=3, eval_every=1), b.run(n_rounds=3, eval_every=1)
    assert [r["loss"] for r in ra] == [r["loss"] for r in rb]
    _assert_bitwise(a, b)
    assert b.state.n_quarantined.tolist() == [0] * 5


def test_zero_event_window_is_bitwise_passthrough():
    n = 4
    edges = [[int(i), int(j)] for i, j in _directed_edges(bidirectional_ring_w(n))]
    s = tbuild(_ring_spec(tspec, {"kind": "trace", "trace": [edges, []],
                                  "local_policy": "active"}), device="cpu")
    rec0 = s.round()
    assert rec0["n_trained"] == n and np.isfinite(rec0["loss"])
    before = s.state.to("cpu")
    rec1 = s.round()
    assert rec1["n_trained"] == 0 and rec1["loss"] is None
    for x, y in [(s.posterior().mean, before.posterior.mean),
                 (s.posterior().rho, before.posterior.rho),
                 (s.state.opt_state.mu.mean, before.opt_state.mu.mean),
                 (s.state.opt_state.nu.rho, before.opt_state.nu.rho),
                 (s.state.step, before.step), (s.state.n_merges, before.n_merges)]:
        assert torch.equal(x, y)
    assert int(s.state.round) == 2


def test_active_mask_survives_subresolution_weight():
    """A fired in-edge of weight 1e-8 leaves the float32 diagonal at 1.0; the
    engine must use the clock's host-exact mask, so agent 0 trains and
    merges."""
    eps = 1e-8
    W = np.array([[1.0 - eps, eps], [0.4, 0.6]])
    assert np.float32(W[0, 0]) == np.float32(1.0)
    spec = tspec.ExperimentSpec(
        topology=tspec.TopologySpec.gossip(
            "explicit", w=W, clock={"kind": "trace", "trace": [[[0, 1]], [[1, 0]]],
                                    "local_policy": "active"}),
        data=_data(tspec, 2), inference=tspec.InferenceSpec(hidden=8, depth=1, lr=1e-2),
        run=tspec.RunSpec(n_rounds=1, seed=0),
    )
    s = tbuild(spec, device="cpu")
    rec = s.round()
    assert rec["n_trained"] == 1
    assert s.state.n_merges.tolist() == [1, 0]
    assert s.state.last_merge.tolist() == [0, -1]
    assert s.state.step.tolist() == [U, 0]


def test_later_executions_raise_not_implemented():
    """Only the sharded ppermute execution is still refused: the delayed and
    edge-native executions build (tests/test_torch_delayed.py,
    tests/test_torch_segments.py)."""
    delayed = {"kind": "delayed", "inner": {"kind": "poisson", "rate": 0.8},
               "latency": {"kind": "constant", "delay": 1}}
    assert tbuild(_spec(tspec, delayed), device="cpu").engine.hist_slots == 2
    with pytest.raises(NotImplementedError, match="sharded"):
        tbuild(_spec(tspec, UNRELIABLE, consensus_impl="ppermute"), device="cpu")
    sparse = tspec.ExperimentSpec(
        topology=tspec.TopologySpec.sparse("watts_strogatz", n=N, k=4, beta=0.2,
                                           clock={"kind": "poisson", "rate": 0.5}),
        data=_data(tspec), inference=tspec.InferenceSpec(hidden=8, depth=1),
    )
    assert tbuild(sparse, device="cpu").engine.consensus_impl == "segments"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tbuild(_spec(tspec, UNRELIABLE))
