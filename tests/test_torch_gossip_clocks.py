"""repro_torch keeps its own copies of the numpy-only gossip clocks and fault
model.  For the same doc and seed they must emit, bit for bit, the JAX
package's window stream (every field of ``EventWindow`` and
``SparseWindow``) and fault streams (``up``, ``corrupted``, ``fills``,
``uptime``), over 20 windows for every clock kind."""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

import repro.api.spec as jspec  # noqa: E402
import repro_torch.api.spec as tspec  # noqa: E402
from repro.core import graphs as jgraphs  # noqa: E402
from repro.gossip import clocks as jclocks  # noqa: E402
from repro.gossip import faults as jfaults  # noqa: E402
from repro_torch.core import graphs as tgraphs  # noqa: E402
from repro_torch.gossip import clocks as tclocks  # noqa: E402
from repro_torch.gossip import faults as tfaults  # noqa: E402

N_WINDOWS = 20
FAULTS = {"crash_rate": 0.15, "recover_rate": 0.5, "corrupt_rate": 0.2,
          "corrupt_kind": "mix", "seed": 7}
POISSON = {"kind": "poisson", "rate": 0.8, "seed": 3}
TRACE = {"kind": "trace", "trace": [[[0, 1], [2, 1]], [[1, 0]], [], [[3, 2], [0, 3], [2, 3]]]}

DENSE = {
    "poisson": POISSON,
    "poisson_emax": dict(POISSON, e_max=12),
    "round_robin": {"kind": "round_robin", "edges_per_window": 3, "seed": 1},
    "trace": TRACE,
    "failure_injected": {"kind": "failure_injected", "inner": POISSON, "drop_rate": 0.3,
                         "seed": 2},
    "delayed_constant": {"kind": "delayed", "inner": POISSON,
                         "latency": {"kind": "constant", "delay": 2}},
    "delayed_geometric": {"kind": "delayed", "inner": POISSON,
                          "latency": {"kind": "geometric", "p": 0.5, "max": 3},
                          "seed": 5},
    "delayed_per_edge": {"kind": "delayed", "inner": {"kind": "round_robin",
                                                      "edges_per_window": 2},
                         "latency": {"kind": "per_edge",
                                     "delays": (np.arange(36).reshape(6, 6) % 3).tolist()}},
    "faults": {"kind": "failure_injected", "inner": POISSON, "drop_rate": 0.1,
               "faults": FAULTS},
    "faults_round_robin": {"kind": "round_robin", "edges_per_window": 4,
                           "faults": dict(FAULTS, corrupt_kind="nan", seed=11)},
}

SPARSE = {
    "poisson": {"kind": "poisson", "rate": 0.5, "seed": 4},
    "all_edges": {"kind": "all_edges"},
    "failure_injected": {"kind": "failure_injected",
                         "inner": {"kind": "poisson", "rate": 0.7, "seed": 1},
                         "drop_rate": 0.25, "seed": 9},
    "faults": {"kind": "poisson", "rate": 0.6, "seed": 2, "faults": FAULTS},
}


def _assert_windows_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_clock_streams_bitwise(name):
    doc = DENSE[name]
    base = "complete_w" if name == "trace" else "bidirectional_ring_w"
    n = 4 if name == "trace" else 6
    jc = jclocks.build_clock(doc, getattr(jgraphs, base)(n))
    tc = tclocks.build_clock(doc, getattr(tgraphs, base)(n))
    assert getattr(tc, "max_delay", 0) == getattr(jc, "max_delay", 0)
    for r in range(N_WINDOWS):
        a, b = tc.window(r), jc.window(r)
        _assert_windows_equal(a, b)
        assert a.w_eff.dtype == np.float64
    if "faults" in doc:
        assert tc.faults is not None and jc.faults is not None


@pytest.mark.parametrize("name", sorted(SPARSE))
def test_sparse_clock_streams_bitwise(name):
    doc = SPARSE[name]
    jg = jgraphs.watts_strogatz_sparse(12, 4, 0.3, seed=1)
    tg = tgraphs.watts_strogatz_sparse(12, 4, 0.3, seed=1)
    jc, tc = jclocks.build_sparse_clock(doc, jg), tclocks.build_sparse_clock(doc, tg)
    for r in range(N_WINDOWS):
        a, b = tc.window(r), jc.window(r)
        _assert_windows_equal(a, b)
        np.testing.assert_array_equal(a.w_eff, b.w_eff)


@pytest.mark.parametrize("kind", ["nan", "inf", "huge", "mix"])
def test_fault_streams_bitwise(kind):
    doc = dict(FAULTS, corrupt_kind=kind)
    jm, tm = jfaults.build_faults(doc, 9), tfaults.build_faults(doc, 9)
    assert tm.to_doc() == jm.to_doc()
    for r in reversed(range(N_WINDOWS)):  # replay order must not matter
        np.testing.assert_array_equal(tm.up(r), jm.up(r))
        np.testing.assert_array_equal(tm.crashed(r), jm.crashed(r))
        np.testing.assert_array_equal(tm.corrupted(r), jm.corrupted(r))
        for x, y in zip(tm.fills(r), jm.fills(r)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tm.uptime(N_WINDOWS), jm.uptime(N_WINDOWS))


def test_edge_keep_mask_bitwise():
    jm, tm = jfaults.build_faults(FAULTS, 12), tfaults.build_faults(FAULTS, 12)
    rng = np.random.default_rng(0)
    dst, src = rng.integers(0, 12, 40), rng.integers(0, 12, 40)
    for r in range(N_WINDOWS):
        np.testing.assert_array_equal(tfaults.edge_keep_mask(tm, r, dst, src),
                                      jfaults.edge_keep_mask(jm, r, dst, src))


def test_gossip_specs_build_the_same_stream_in_both_packages():
    """``TopologySpec.gossip``/``gossip_from_schedule`` specs give the same
    ``ExperimentSpec.to_doc()`` and ``w_schedule`` values in both packages."""
    def doc(mod, topo):
        return mod.ExperimentSpec(topology=topo).to_doc()

    jt = jspec.TopologySpec.gossip("grid", {"rows": 3, "cols": 3}, clock=DENSE["faults"])
    tt = tspec.TopologySpec.gossip("grid", {"rows": 3, "cols": 3}, clock=DENSE["faults"])
    assert doc(tspec, tt) == doc(jspec, jt)
    assert tspec.ExperimentSpec.from_doc(doc(jspec, jt)).topology == tt
    tt.validate()
    js, ts = jt.w_schedule(), tt.w_schedule()
    for r in range(N_WINDOWS):
        np.testing.assert_array_equal(ts(r), js(r))
    sched = jgraphs.time_varying_star_schedule(n_agents=6, n_active=2, a=0.5)
    jt = jspec.TopologySpec.gossip_from_schedule(sched)
    tt = tspec.TopologySpec.gossip_from_schedule(
        tgraphs.time_varying_star_schedule(n_agents=6, n_active=2, a=0.5))
    assert doc(tspec, tt) == doc(jspec, jt)
    js, ts = jt.w_schedule(), tt.w_schedule()
    for r in range(N_WINDOWS):
        np.testing.assert_array_equal(ts(r), js(r))
    assert tt.gossip_clock() is tt.gossip_clock()  # memoized
