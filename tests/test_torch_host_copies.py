"""The numpy-only host modules that repro_torch keeps its own copies of
(graphs, synthetic data, partitions, the spec) give bitwise-equal results to
the JAX package's for the same parameters and seeds, and spec docs cross
between the packages in both directions."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.api.spec as jspec  # noqa: E402
import repro_torch.api.spec as tspec  # noqa: E402
from repro.core import graphs as jg  # noqa: E402
from repro.data import partition as jp  # noqa: E402
from repro.data import synthetic as js  # noqa: E402
from repro_torch.core import graphs as tg  # noqa: E402
from repro_torch.data import partition as tp  # noqa: E402
from repro_torch.data import synthetic as ts  # noqa: E402

GRAPHS = [
    ("star_w", dict(n_edge=3, a=0.5)),
    ("grid_w", dict(rows=3, cols=3)),
    ("ring_w", dict(n=5)),
    ("bidirectional_ring_w", dict(n=6)),
    ("torus_w", dict(rows=3, cols=4)),
    ("complete_w", dict(n=4)),
    ("erdos_w", dict(n=8, p=0.5, seed=3)),
    ("watts_strogatz_w", dict(n=10, k=4, beta=0.2, seed=1)),
    ("barabasi_albert_w", dict(n=10, m=2, seed=2)),
]


@pytest.mark.parametrize("name,params", GRAPHS, ids=[g[0] for g in GRAPHS])
def test_graph_builders_bitwise(name, params):
    np.testing.assert_array_equal(getattr(tg, name)(**params), getattr(jg, name)(**params))


def test_time_varying_star_and_theory_helpers_bitwise():
    a = tg.time_varying_star_schedule(n_agents=6, n_active=2, a=0.5)
    b = jg.time_varying_star_schedule(n_agents=6, n_active=2, a=0.5)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("maker", ["make_synthetic_classification", "mnist_like", "fmnist_like"])
def test_synthetic_datasets_bitwise(maker):
    kw = dict(n_classes=10, dim=16, n_train_per_class=20, n_test_per_class=5, seed=4)
    a, b = getattr(ts, maker)(**kw), getattr(js, maker)(**kw)
    for f in ("x_train", "y_train", "x_test", "y_test", "prototypes"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


PARTITIONS = [
    ("partition_iid", dict(n_agents=4, seed=1)),
    ("partition_by_label", dict(label_sets=[[0, 1], [1, 2], [3]], seed=2)),
    ("star_partition", dict(center_labels=[1, 2, 3], edge_labels=[0], n_edge=3)),
    ("grid_partition", dict(type1_labels=list(range(2, 10)), type2_labels=[0, 1],
                            type1_position=4)),
]


@pytest.mark.parametrize("name,params", PARTITIONS, ids=[p[0] for p in PARTITIONS])
def test_partitions_bitwise(name, params):
    ds = js.mnist_like(dim=8, n_train_per_class=30, n_test_per_class=2)
    a = getattr(tp, name)(ds.x_train, ds.y_train, **params)
    b = getattr(jp, name)(ds.x_train, ds.y_train, **params)
    assert len(a) == len(b)
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def _spec(mod):
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.grid(3, 3),
        data=mod.DataSpec(
            dataset="mnist_like", dataset_params=dict(dim=784, n_classes=10),
            partition="grid",
            partition_params=dict(type1_labels=list(range(2, 10)), type2_labels=[0, 1],
                                  type1_position=4),
            batch_size=16, local_updates=4,
        ),
        inference=mod.InferenceSpec(hidden=200, depth=2, wire_dtype="bf16"),
        run=mod.RunSpec(n_rounds=3, seed=7),
    )


def test_spec_docs_cross_both_ways():
    jd, td = _spec(jspec).to_doc(), _spec(tspec).to_doc()
    assert jd == td
    assert tspec.ExperimentSpec.from_doc(jd).to_doc() == jd
    assert jspec.ExperimentSpec.from_doc(td).to_doc() == td
    explicit = tspec.TopologySpec.explicit(jg.star_w(3, 0.5))
    jexplicit = jspec.TopologySpec.explicit(jg.star_w(3, 0.5))
    a = tspec.ExperimentSpec(topology=explicit).to_doc()
    assert a == jspec.ExperimentSpec(topology=jexplicit).to_doc()


def test_spec_validation_and_w_schedule_match():
    for mod in (jspec, tspec):
        _spec(mod).validate()
    w_t = _spec(tspec).topology.w_schedule()(0)
    np.testing.assert_array_equal(w_t, _spec(jspec).topology.w_schedule()(0))
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        tspec.InferenceSpec(wire_dtype="f8").validate()


def test_gossip_topologies_wait_for_their_slice():
    """Gossip topologies build their clocks in the port now; the gossip
    executions of later slices (delayed delivery) still raise."""
    from repro_torch.api import build_session

    topo = tspec.TopologySpec.gossip("ring", {"n": 4})
    topo.validate()
    assert topo.gossip_clock().window(0).w_eff.shape == (4, 4)
    sched = tspec.TopologySpec.gossip_from_schedule(
        jg.time_varying_star_schedule(n_agents=4, n_active=2, a=0.5))
    sched.validate()
    delayed = tspec.TopologySpec.gossip(
        "ring", {"n": 4}, clock={"kind": "delayed", "inner": {"kind": "poisson"},
                                 "latency": {"kind": "constant", "delay": 1}})
    spec = tspec.ExperimentSpec(
        topology=delayed,
        data=tspec.DataSpec(dataset_params=dict(n_classes=4, dim=8, n_train_per_class=20),
                            partition="iid", partition_params=dict(n_agents=4)),
        inference=tspec.InferenceSpec(hidden=4, depth=1))
    with pytest.raises(NotImplementedError, match="delayed"):
        build_session(spec, device="cpu")


def test_linreg_task_sampling_bitwise():
    from repro.data import linreg as jl
    from repro_torch.data import linreg as tl

    for kw in (dict(), dict(d=4, n_agents=3), dict(d=5, n_agents=2),
               dict(d=2, n_agents=2, theta_star=[1.0, -2.0])):
        a, b = tl.make_linreg_task(**kw), jl.make_linreg_task(**kw)
        assert a.agent_coords == b.agent_coords and a.d == b.d and a.noise_std == b.noise_std
        np.testing.assert_array_equal(a.theta_star, b.theta_star)
        np.testing.assert_array_equal(a.agent_ranges, b.agent_ranges)
        for agent in range(a.n_agents):
            ra, rb = np.random.default_rng(agent), np.random.default_rng(agent)
            for x, y in zip(a.sample_local(ra, agent, 17), b.sample_local(rb, agent, 17)):
                np.testing.assert_array_equal(x, y)
        for x, y in zip(a.sample_global(np.random.default_rng(9), 33),
                        b.sample_global(np.random.default_rng(9), 33)):
            np.testing.assert_array_equal(x, y)


_THEORY_WS = {
    "star": jg.star_w(3, 0.5), "ring": jg.ring_w(5), "complete": jg.complete_w(4),
    "torus": jg.torus_w(3, 4), "disconnected": np.eye(3),
}


@pytest.mark.parametrize("w", sorted(_THEORY_WS))
def test_theory_functions_bitwise(w):
    from repro.core import theory as jt
    from repro_torch.core import theory as tt

    W = _THEORY_WS[w]
    for fn in ("lambda_max", "spectral_gap", "consensus_contraction_rate"):
        assert getattr(tt, fn)(W) == getattr(jt, fn)(W), fn
    if w != "disconnected":
        v = tt.stationary_distribution(W)
        np.testing.assert_array_equal(v, jt.stationary_distribution(W))
        I = np.random.default_rng(len(W)).normal(1.0, 0.5, (len(W), 2, 3))
        assert tt.rate_K(v, I) == jt.rate_K(v, I)
    args = (len(W), 7, 0.05, 0.1, 2.5, W)
    assert tt.sample_complexity(*args) == jt.sample_complexity(*args)
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=50), rng.normal(size=50)
    assert tt.gaussian_divergence_gap(a, b, 0.3) == jt.gaussian_divergence_gap(a, b, 0.3)
    n = np.arange(0, 40)
    np.testing.assert_array_equal(tt.predicted_decay_curve(0.2, n, 0.01),
                                  jt.predicted_decay_curve(0.2, n, 0.01))
