"""The observability layer of repro_torch (``repro_torch.obs``,
``Session.obs``/``dashboard``, the engines' and the server's hooks) on the
CPU: each contract of tests/test_obs.py on the port, and the port against
the JAX package:

* the same registry calls give byte-identical Prometheus text;
* ``network_stats`` on the same seeded ``[N, P]`` buffers matches JAX's
  within rtol 1e-5, with the column-chunked reduction forced to several
  chunks (it sums in another order);
* the tracker fed the JAX session's own per-round posteriors gives JAX's
  overlay rows and ``measured_rate`` within rtol 1e-5; the quickstart's
  lr = 0 ring, run in the port from the JAX session's init
  (``build_session(init_params=)``), gives the same ``theory_rate`` and its
  overlay rows within rtol 1e-5, or within the fp32 rounding of the
  posterior itself (eq. (6)'s ~1 ulp a round, summed over the rounds) where
  the disagreement has decayed to a few ulps of the posterior;
* on tests/test_obs.py's specs the port's ``dashboard()`` has the
  reference's line templates (numbers masked), span names and counter
  values;
* the port's gossip ``n_traces`` is 1 on every spec where the reference
  pins one trace (tests/test_gossip.py:346, :672, :752, :914,
  tests/test_wire_dtype.py:509, tests/test_obs.py:408).

Observability is a pure observer: a run with it on is bitwise the run with
it off (posterior, optimizer state, every checkpoint leaf), with the same
tree structure, on every engine and window path.  The card's side is in
tests/test_torch_obs_cuda.py.
"""
import pytest

torch = pytest.importorskip("torch")

import collections  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import time  # noqa: E402
import weakref  # noqa: E402

import numpy as np  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.obs.convergence import network_stats as jnetwork_stats  # noqa: E402
from repro.obs.metrics import JsonlSink as JSink  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro_torch.core.flat import FlatPosterior  # noqa: E402
from repro_torch.core.numerics import softplus_inv_py  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.gossip.clocks import _directed_edges  # noqa: E402
from repro_torch.core.graphs import bidirectional_ring_w  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.obs.convergence import ConvergenceTracker, network_stats  # noqa: E402
from repro_torch.obs.metrics import (  # noqa: E402
    JsonlSink,
    MetricsRegistry,
    escape_label_value,
    sanitize_name,
)
from repro_torch.obs.roofline import (  # noqa: E402
    attainment,
    consensus_attainment,
    window_attainment,
)
from repro_torch.obs.trace import Tracer, current_obs, made_current  # noqa: E402

NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")
RTOL = 1e-5


def _template(line):
    return " ".join(NUMBER.sub("#", line).split())


# -- metrics registry (tests/test_obs.py:42-141) ------------------------------------


def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    c = reg.counter("c")
    c.inc()
    c.inc(2.5)
    assert c.value() == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("g")
    g.set(1.0)
    g.set(4.0)
    assert g.value() == 4.0
    h = reg.histogram("h", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    s = h.summary()
    assert s["count"] == 3 and s["min"] == 0.5 and s["max"] == 50.0
    assert s["sum"] == pytest.approx(55.5)
    assert reg.histogram("h").summary(mc="8") == {"count": 0}


def test_labels_are_independent_series():
    reg = MetricsRegistry()
    c = reg.counter("req")
    c.inc(1, mc="1")
    c.inc(5, mc="8")
    assert c.value(mc="1") == 1 and c.value(mc="8") == 5
    assert c.value() == 0


def test_instrument_kind_collision_raises():
    reg = MetricsRegistry()
    reg.counter("x")
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x")


def test_ingest_flattens_telemetry_vocabulary():
    reg = MetricsRegistry()
    reg.ingest("engine", {"staleness": {"p50": 1.0, "p90": 3}, "per_agent": [2, 4],
                          "wire_dtype": "bf16", "ok": True, "skipped": None})
    got = reg.collect()
    assert got["engine.staleness.p50"] == 1.0
    assert got["engine.staleness.p90"] == 3.0
    assert got["engine.per_agent.0"] == 2.0 and got["engine.per_agent.1"] == 4.0
    assert got["engine.ok"] == 1.0
    assert got["engine.wire_dtype"] == "bf16"
    assert "engine.skipped" not in got


def test_prometheus_export_deterministic_and_sane():
    def build(order):
        reg = MetricsRegistry()
        for name in order:
            reg.counter(name).inc(1)
        reg.gauge("z.gauge").set(2.5)
        return reg.to_prometheus()

    a, b = build(["b.n", "a.n"]), build(["a.n", "b.n"])
    assert a == b
    assert "a_n_total 1\n" in a and "z_gauge 2.5\n" in a


def test_sanitize_name_and_escape_label_value():
    assert sanitize_name("gossip.window-time") == "gossip_window_time"
    assert sanitize_name("0bad") == "_0bad"
    assert escape_label_value("plain") == "plain"
    assert escape_label_value('a"b') == 'a\\"b'
    assert escape_label_value("a\\b") == "a\\\\b"
    assert escape_label_value("a\nb") == "a\\nb"
    assert escape_label_value('\\"') == '\\\\\\"'


def test_prometheus_label_values_escaped():
    reg = MetricsRegistry()
    reg.counter("req").inc(3, path='say "hi"\n@C:\\tmp')
    reg.ingest("build", {"flags": 'x="1"\\y'})
    text = reg.to_prometheus()
    assert 'req_total{path="say \\"hi\\"\\n@C:\\\\tmp"} 3\n' in text
    assert 'build_flags_info{value="x=\\"1\\"\\\\y"} 1\n' in text
    assert "\nsay" not in text


def test_jsonl_sink_records_events(tmp_path):
    path = str(tmp_path / "events.jsonl")
    sink = JsonlSink(path)
    reg = MetricsRegistry(sink=sink)
    reg.counter("c").inc(2, mc="8")
    reg.gauge("g").set(1.5)
    sink.close()
    lines = [json.loads(x) for x in open(path)]
    assert sink.n_events == len(lines) == 2
    assert lines[0] == {"kind": "counter", "name": "c", "labels": {"mc": "8"}, "value": 2}


def _registry_calls(reg, case):
    """One sequence of registry calls; ``case`` picks which."""
    if case == "counters_gauges":
        reg.counter("session.rounds", "communication rounds run").inc()
        reg.counter("session.rounds").inc(2)
        reg.gauge("session.loss", "mean trained-agent loss").set(1.2345678901234567)
        reg.gauge("session.n_trained").set(9)
        reg.gauge("big").set(1e16)
        reg.gauge("neg").set(-0.1)
        reg.gauge("tiny").set(3e-300)
        reg.gauge("inf").set(float("inf"))
        reg.gauge("ninf").set(float("-inf"))
    elif case == "labels_histograms":
        h = reg.histogram("serve.latency_us", "per-call serve latency")
        for v, mc in [(141.79, "8"), (254.0, "8"), (0.5, "0"), (2e7, "0"), (1e3, "8")]:
            h.observe(v, mc=mc)
        reg.histogram("custom", buckets=(0.1, 1.5, 2.5)).observe(2.0, agent="a\nb")
        reg.counter("serve.requests").inc(3, mc="8", path='say "hi"')
    elif case == "ingest":
        reg.ingest("engine", {"staleness": {"p50": 0.5, "p90": 3, "max": 7, "mean": 1 / 3},
                              "merges": {"per_agent_mean": 2.25, "min": 0, "total": 27},
                              "faults": {"policy": "quarantine",
                                         "uptime": {"per_agent": [4, 3, 4]}},
                              "wire_dtype": "bf16", "ok": True, "none": None})
        reg.ingest("convergence", {"disagreement": 0.0019251150808303006,
                                   "kl_to_mean": 0.03784709423780441})
        reg.info("build", 'x="1"\\y')


@pytest.mark.parametrize("case", ["counters_gauges", "labels_histograms", "ingest"])
def test_prometheus_text_is_byte_identical_across_packages(case, tmp_path):
    texts, events, collected = [], [], []
    for i, (reg_cls, sink_cls) in enumerate([(JRegistry, JSink), (MetricsRegistry, JsonlSink)]):
        path = tmp_path / f"{i}.jsonl"
        sink = sink_cls(str(path))
        reg = reg_cls(sink=sink)
        _registry_calls(reg, case)
        texts.append(reg.to_prometheus())
        collected.append(reg.collect())
        sink.close()
        events.append(path.read_bytes())
    assert texts[0] == texts[1]
    assert events[0] == events[1]
    assert collected[0] == collected[1]


# -- tracer (tests/test_obs.py:146-211) ---------------------------------------------


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU: ``record`` reads the
    host clock; ``elapsed_time`` is in ms, as CUDA's."""

    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        _FakeEvent.made.append(weakref.ref(self))

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_card(monkeypatch):
    """``torch.cuda``'s events, streams and synchronise faked on the CPU, so
    that a ``Tracer(device="cuda")`` runs here; yields the synchronise
    calls."""
    syncs = []
    _FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    return syncs


def test_disabled_tracer_records_nothing_and_reuses_null_span(fake_card):
    tr = Tracer(enabled=False, device="cuda")
    s1, s2 = tr.span("a"), tr.span("b", k=1)
    assert s1 is s2
    with s1:
        pass
    assert tr.spans == [] and tr.summary() == {} and fake_card == [] and _FakeEvent.made == []


def test_live_span_synchronises_before_each_clock_read(fake_card):
    """The old contract's name; the contract now: a live span calls no
    synchronise on entry or exit, it records one timing event at each end,
    and ``resolve()`` makes the one synchronise."""
    tr = Tracer(enabled=True, device="cuda")
    with tr.span("outer"):
        assert fake_card == [] and len(_FakeEvent.made) == 2
    assert fake_card == [] and [s.name for s in tr.spans] == ["outer"]
    assert tr.spans[0].device_us is None
    tr.resolve()
    assert fake_card == [torch.device("cuda")] and tr.spans[0].device_us >= 0


def test_live_span_calls_no_synchronise_and_on_the_cpu_its_device_time_is_its_host_time(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronised"))
    tr = Tracer(enabled=True, device="cpu")
    t_before = time.perf_counter()
    with tr.span("outer"):
        with tr.span("inner"):
            time.sleep(0.002)
    t_after = time.perf_counter()
    inner, outer = tr.spans
    for s in (inner, outer):
        assert s.device_us == s.dur_us > 0
        assert t_before <= s.t0_s and s.t0_s + s.dur_us * 1e-6 <= t_after
        assert s.t0_s - tr._epoch == pytest.approx(s.t0_us * 1e-6, abs=1e-9)
    assert inner.dur_us >= 2000 and outer.t0_s <= inner.t0_s
    tr.resolve()  # nothing pending on the CPU
    assert tr.summary()["outer"]["warm"]["device_total_us"] == outer.dur_us
    assert tr.spans[0].to_event()["device_us"] == round(inner.dur_us, 3)


def test_resolve_is_idempotent_and_releases_its_events(fake_card):
    tr = Tracer(enabled=True, device="cuda")
    for i in range(3):
        with tr.span("step", compile=i == 0):
            time.sleep(0.001)
    assert len(tr._pending) == 3 and all(s.device_us is None for s in tr.spans)
    tr.resolve()
    assert len(fake_card) == 1 and tr._pending == []
    gc.collect()
    assert len(_FakeEvent.made) == 6 and all(ref() is None for ref in _FakeEvent.made)
    got = [s.device_us for s in tr.spans]
    assert all(d >= 1000 for d in got)
    tr.resolve()
    assert len(fake_card) == 1 and [s.device_us for s in tr.spans] == got
    summ = tr.summary()["step"]  # the summary resolves too: nothing left to do
    assert len(fake_card) == 1
    assert summ["warm"]["device_total_us"] == pytest.approx(sum(got[1:]))
    assert summ["compile"]["device_p50_us"] == got[0]


def test_tracer_nesting_depth_and_order():
    tr = Tracer(enabled=True)
    with tr.span("outer"):
        with tr.span("inner"):
            pass
    assert [(s.name, s.depth) for s in tr.spans] == [("inner", 1), ("outer", 0)]
    assert tr.spans[1].dur_us >= tr.spans[0].dur_us


def test_tracer_summary_splits_compile_from_warm():
    tr = Tracer(enabled=True)
    with tr.span("round", compile=True):
        pass
    for _ in range(3):
        with tr.span("round"):
            pass
    summ = tr.summary()["round"]
    assert summ["compile"]["n"] == 1 and summ["warm"]["n"] == 3
    assert summ["warm"]["p50_us"] <= summ["warm"]["max_us"]


def test_tracer_flush_is_incremental(tmp_path):
    sink = JsonlSink(str(tmp_path / "t.jsonl"))
    tr = Tracer(enabled=True, sink=sink)
    with tr.span("a"):
        pass
    assert tr.flush() == 1
    assert tr.flush() == 0
    with tr.span("b"):
        pass
    assert tr.flush() == 1


# -- convergence tracking (tests/test_obs.py:216-271) -------------------------------


def test_network_stats_hand_computed():
    mean = np.array([[1.0], [-1.0]], np.float32)
    rho = np.full((2, 1), softplus_inv_py(1.0), np.float32)
    got = network_stats(mean, rho)
    assert got["disagreement"] == pytest.approx(1.0, rel=1e-6)
    assert got["rho_disagreement"] == pytest.approx(0.0, abs=1e-7)
    assert got["kl_to_mean"] == pytest.approx(0.5, rel=1e-5)
    assert set(network_stats(mean)) == {"disagreement"}


@pytest.mark.parametrize("n,p,chunk_cols", [(9, 1000, 97), (4, 257, 1), (37, 4099, 600),
                                            (9, 1000, None)])
def test_network_stats_match_jax_over_column_chunks(n, p, chunk_cols, monkeypatch):
    from repro_torch.obs import convergence

    rng = np.random.default_rng(n * 7 + p)
    mean = rng.normal(0.0, 0.5, (n, p)).astype(np.float32)
    rho = rng.uniform(-6.0, 1.0, (n, p)).astype(np.float32)
    if chunk_cols is not None:
        monkeypatch.setattr(convergence, "CHUNK_BYTES", 4 * n * chunk_cols)
        assert len(convergence._chunks(n, p)) == -(-p // chunk_cols) > 1
    got = network_stats(torch.from_numpy(mean), torch.from_numpy(rho))
    want = jnetwork_stats(mean, rho)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=RTOL), k
    got = network_stats(torch.from_numpy(mean))
    assert got["disagreement"] == pytest.approx(jnetwork_stats(mean)["disagreement"], rel=RTOL)


def test_network_stats_chunks_bound_the_temporaries(monkeypatch):
    from repro_torch.obs import convergence

    assert convergence.CHUNK_BYTES == 64 << 20
    assert convergence._chunks(4200, 199_210) == [
        (a, min(a + 3994, 199_210)) for a in range(0, 199_210, 3994)]
    assert convergence._chunks(9, 199_210) == [(0, 199_210)]
    monkeypatch.setattr(convergence, "CHUNK_BYTES", 4)
    assert convergence._chunks(3, 5) == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]


def test_tracker_measures_synthetic_decay_rate():
    class _P:
        def __init__(self, d):
            self.mean = torch.tensor([[d], [-d]], dtype=torch.float32)

    tracker = ConvergenceTracker(K=0.7)
    for r in range(8):
        tracker.update(_P(math.exp(-0.7 * r)), r)
    rep = tracker.report()
    assert rep["measured_rate"] == pytest.approx(0.7, rel=1e-2)
    assert rep["rate_attainment"] == pytest.approx(1.0, rel=1e-2)
    first = rep["overlay"][0]
    assert first["predicted"] == pytest.approx(first["measured"])
    assert len(rep["overlay"]) == rep["n_rounds"] == 8


def test_tracker_explicit_K_wins_over_W():
    W = np.full((3, 3), 1.0 / 3.0)
    assert ConvergenceTracker(W=W, K=2.0).theory_rate == 2.0
    assert ConvergenceTracker().theory_rate is None
    assert ConvergenceTracker().measured_rate() is None


def test_tracker_series_columns():
    tracker = ConvergenceTracker()
    tracker.update(torch.zeros((2, 3)))
    tracker.update(np.zeros((2, 3), np.float32))
    cols = tracker.series()
    assert cols["round"] == [0, 1]
    assert cols["disagreement"] == [0.0, 0.0]


# -- roofline attainment (tests/test_obs.py:276-296) ---------------------------------


def test_attainment_ratio_and_degenerate():
    assert attainment(100.0, 50e-6) == pytest.approx(0.5)
    assert attainment(0.0, 1.0) == 0.0
    assert attainment(1.0, 0.0) == 0.0


def test_consensus_and_window_attainment():
    a = consensus_attainment(1e4, n_agents=8, n_params=1 << 16)
    assert 0.0 < a["attainment"] < 1.0
    assert a["modeled_us"] == pytest.approx(a["attainment"] * 1e4)
    assert a["modeled_bytes"] == 16 * 8 * (1 << 16)
    w = window_attainment(1e4, n_agents=8, n_params=1 << 16, n_participating=4)
    assert 0.0 < w["attainment"] < 1.0
    assert w["participating_fraction"] == pytest.approx(0.5)
    with pytest.raises(ValueError, match="unknown"):
        window_attainment(1e4, n_agents=8, n_params=1 << 16, n_participating=4,
                          strategy="nope")


# -- specs ---------------------------------------------------------------------------


def _tiny_spec(mod, obs=None, n_rounds=3, engine="simulated"):
    """tests/test_obs.py:301's spec: a 4-agent bidirectional ring."""
    kw = {} if obs is None else {"obs": obs}
    return mod.ExperimentSpec(
        topology=mod.TopologySpec(kind="bidirectional_ring", params={"n": 4}),
        data=mod.DataSpec(dataset_params=dict(n_classes=3, dim=8, n_train_per_class=20),
                          partition="iid", partition_params=dict(n_agents=4),
                          batch_size=4, local_updates=1),
        inference=mod.InferenceSpec(hidden=4, depth=1, lr=1e-2),
        run=mod.RunSpec(n_rounds=n_rounds, seed=0, engine=engine),
        **kw,
    )


def _gossip_spec(mod, obs=None, clock=None, n=4, n_rounds=3, **inf):
    """tests/test_obs.py:390's gossip spec (tests/test_gossip.py:75's data)."""
    kw = {} if obs is None else {"obs": obs}
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.gossip(
            "bidirectional_ring", {"n": n},
            clock=clock or {"kind": "poisson", "rate": 0.8, "seed": 0}),
        data=mod.DataSpec(dataset_params=dict(n_classes=3, dim=8, n_train_per_class=20),
                          partition="iid", partition_params=dict(n_agents=n),
                          batch_size=4, local_updates=1),
        inference=mod.InferenceSpec(**{"hidden": 4, "depth": 1, "lr": 1e-2, **inf}),
        run=mod.RunSpec(n_rounds=n_rounds, seed=0),
        **kw,
    )


CHAOS = {"crash_rate": 0.2, "recover_rate": 0.5, "corrupt_rate": 0.3, "corrupt_kind": "mix",
         "seed": 3}
DELAYED = {"kind": "delayed", "inner": {"kind": "poisson", "rate": 0.9, "seed": 2},
           "latency": {"kind": "geometric", "p": 0.5, "max": 3}}


def _sparse_spec(mod, obs=None):
    kw = {} if obs is None else {"obs": obs}
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.sparse("watts_strogatz", n=8, k=4, beta=0.1, seed=1,
                                         clock={"kind": "poisson", "rate": 0.8, "seed": 0,
                                                "faults": CHAOS}),
        data=mod.DataSpec(dataset_params=dict(n_classes=3, dim=8, n_train_per_class=20),
                          partition="iid", partition_params=dict(n_agents=8),
                          batch_size=4, local_updates=1),
        inference=mod.InferenceSpec(hidden=4, depth=1, lr=1e-2, fault_policy="quarantine"),
        run=mod.RunSpec(n_rounds=3, seed=0),
        **kw,
    )


def _linreg_spec(mod, obs=None):
    kw = {} if obs is None else {"obs": obs}
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.complete(4),
        data=mod.DataSpec(dataset="linreg", batch_size=10),
        inference=mod.InferenceSpec(method="conjugate_linreg"),
        run=mod.RunSpec(n_rounds=3, seed=0),
        **kw,
    )


PURE_OBSERVER_SPECS = {
    "simulated": lambda obs: _tiny_spec(tapi, obs),
    "launch": lambda obs: _tiny_spec(tapi, obs, engine="launch"),
    "gossip_masked": lambda obs: _gossip_spec(tapi, obs),
    "gossip_chaos_quarantine": lambda obs: _gossip_spec(
        tapi, obs, clock={"kind": "poisson", "rate": 0.8, "seed": 0, "faults": CHAOS},
        fault_policy="quarantine"),
    "gossip_active_policy": lambda obs: _gossip_spec(
        tapi, obs, clock={"kind": "poisson", "rate": 0.5, "seed": 0, "local_policy": "active"}),
    "delayed_quarantine": lambda obs: _gossip_spec(
        tapi, obs, clock=dict(DELAYED, faults=CHAOS), fault_policy="quarantine"),
    "segments_quarantine": lambda obs: _sparse_spec(tapi, obs),
    "conjugate_linreg": lambda obs: _linreg_spec(tapi, obs),
}


# -- sessions: a pure observer -------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PURE_OBSERVER_SPECS))
def test_obs_enabled_is_bitwise_identical(name, tmp_path):
    """tests/test_obs.py:338 and :426 on every engine and window path: the
    posterior, the optimizer state, the generator and every checkpoint leaf
    are bitwise those of the run with observability off, and the state's
    tree is unchanged."""
    make = PURE_OBSERVER_SPECS[name]
    runs = {}
    for on in (False, True):
        obs = tapi.ObsSpec(enabled=True, jsonl_path=str(tmp_path / "t.jsonl")) if on else None
        s = tapi.build_session(make(obs), device="cpu")
        s.run()
        s.evaluate()
        if s.model is not None:
            s.snapshot()
            s.attach_server(mc_samples=2).query(s.data.x_test[:3].numpy())
        s.run(n_rounds=1)
        s.save(str(tmp_path / f"{on}.ckpt"))
        runs[on] = s
    off, on = runs[False], runs[True]
    assert on.obs is not None and off.obs is None
    a, b = tree_leaves(off.state), tree_leaves(on.state)
    assert len(a) == len(b) and type(off.state) is type(on.state)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.reshape(-1).view(torch.uint8) if x.is_floating_point() else x,
                           y.reshape(-1).view(torch.uint8) if y.is_floating_point() else y)
    assert torch.equal(off.generator.get_state(), on.generator.get_state())
    loaded = [tapi.Session.load(str(tmp_path / f"{v}.ckpt"), device="cpu") for v in (False, True)]
    assert loaded[1].obs is not None and loaded[0].obs is None
    for x, y in zip(tree_leaves(loaded[0].state), tree_leaves(loaded[1].state)):
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(x.isnan(), y.isnan()))


def test_obs_disabled_session_records_nothing():
    s = tapi.build_session(_tiny_spec(tapi), device="cpu")
    s.run()
    assert s.obs is None
    assert "observability disabled" in s.dashboard()


def test_obs_session_counters_convergence_and_dashboard():
    s = tapi.build_session(_tiny_spec(tapi, tapi.ObsSpec(enabled=True)), device="cpu")
    s.run()
    assert isinstance(s.obs, Observability)
    assert s.obs.tracer.device == torch.device("cpu")  # the host's clock alone
    reg = s.obs.registry
    assert reg.counter("session.rounds").value() == 3
    rep = s.obs.convergence.report()
    assert rep["n_rounds"] == 3
    assert rep["theory_rate"] is not None and rep["theory_rate"] > 0
    names = {sp.name for sp in s.obs.tracer.spans}
    assert {"session.run", "session.round", "session.batches", "obs.convergence"} <= names
    summ = s.obs.tracer.summary()["session.round"]
    assert summ["compile"]["n"] == 1 and summ["warm"]["n"] == 2
    assert "session.w_build" not in names  # run() hands each round its W
    s.round()  # builds its W from the spec's schedule
    assert "session.w_build" in {sp.name for sp in s.obs.tracer.spans}
    dash = s.dashboard()
    assert "convergence:" in dash and "span session.round" in dash


def test_convergence_every_samples_every_kth_round():
    obs = tapi.ObsSpec(enabled=True, convergence_every=2, trace=False)
    s = tapi.build_session(_tiny_spec(tapi, obs, n_rounds=5), device="cpu")
    s.run()
    assert s.obs.convergence.rounds == [1, 3, 5]
    assert s.obs.tracer.spans == []  # trace=False: the tracer is off


def test_obs_gossip_engine_counters_and_spans():
    s = tapi.build_session(_gossip_spec(tapi, tapi.ObsSpec(enabled=True)), device="cpu")
    s.run()
    reg = s.obs.registry
    assert reg.counter("gossip.windows").value() == 3
    assert reg.gauge("gossip.jit_traces").value() == s.engine.n_traces == 1
    spans = [sp for sp in s.obs.tracer.spans if sp.name == "gossip.window"]
    assert len(spans) == 3 and {sp.attrs["impl"] for sp in spans} == {"masked"}
    assert "gossip.window_build" in {sp.name for sp in s.obs.tracer.spans}
    summ = s.obs.tracer.summary()["session.round"]  # the first window grew n_traces
    assert summ["compile"]["n"] == 1 and summ["warm"]["n"] == 2


@pytest.mark.parametrize("make,impl", [
    (lambda obs: _gossip_spec(tapi, obs, clock=DELAYED), "delayed"),
    (lambda obs: _sparse_spec(tapi, obs), "segments"),
])
def test_window_spans_name_their_execution(make, impl):
    s = tapi.build_session(make(tapi.ObsSpec(enabled=True)), device="cpu")
    s.run()
    spans = [sp for sp in s.obs.tracer.spans if sp.name == "gossip.window"]
    assert [sp.attrs["impl"] for sp in spans] == [impl] * 3
    assert [sp.attrs["round"] for sp in spans] == [0, 1, 2]
    assert s.obs.registry.counter("gossip.windows").value() == 3
    assert s.obs.registry.gauge("gossip.jit_traces").value() == s.engine.n_traces == 1


def _spans(s, since=0):
    return [(sp.name, sp.depth) for sp in s.obs.tracer.spans[since:]]


LOCAL = ["local.forward", "local.backward", "local.optimizer"]


def _one_agent_blocks(monkeypatch):
    """Every agent a block of its own (``agent_blocks``' byte cap at 1)."""
    from repro_torch.vi import bayes_by_backprop

    monkeypatch.setattr(bayes_by_backprop, "AGENT_BLOCK_BYTES", 1)


@pytest.mark.parametrize("case", ["sync", "masked", "segments"])
def test_span_lists_of_a_round_and_of_a_window(case, monkeypatch):
    """One round's spans in the order they close, with their depths: the
    local step's three spans once a block (4 agents, one a block) and
    step (u = 2) inside the round's or the window's local phase, then its
    consensus."""
    _one_agent_blocks(monkeypatch)
    obs = tapi.ObsSpec(enabled=True, convergence=False)
    spec = {"sync": lambda: _tiny_spec(tapi, obs), "masked": lambda: _gossip_spec(tapi, obs),
            "segments": lambda: _sparse_spec(tapi, obs)}[case]()
    n = spec.data.partition_params["n_agents"]
    spec = dataclasses.replace(spec, data=dataclasses.replace(spec.data, local_updates=2))
    s = tapi.build_session(spec, device="cpu")
    s.round()
    local = [(name, 3 if case != "sync" else 2) for name in LOCAL] * (2 * n)
    head = [("session.w_build", 1), ("session.batches", 1)]
    if case == "sync":
        body = local + [("round.local_phase", 1), ("round.consensus", 1)]
    else:
        body = [("gossip.window_build", 1)] + local + [("gossip.local_phase", 2), ("gossip.consensus", 2),
                                ("gossip.window", 1)]
    assert _spans(s) == head + body + [("session.round", 0)]
    assert all(sp.device_us == sp.dur_us for sp in s.obs.tracer.spans)


def _lm_pair(monkeypatch):
    """A tiny repro-100m (2 agents, one a block), its Adam, schedule, state
    and one batch on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch_sampler
    from repro_torch.launch.steps import init_train_state
    from repro_torch.optim import adam
    from repro_torch.optim.schedules import exponential_decay

    _one_agent_blocks(monkeypatch)
    cfg = dataclasses.replace(get_config("repro-100m"), n_layers=1, d_model=32, n_heads=2,
                              n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
                              dtype="float32")
    g = torch.Generator().manual_seed(0)
    opt = adam()
    state = init_train_state(cfg, 2, opt, generator=g, device="cpu")
    batch = make_lm_batch_sampler(cfg.vocab_size, 2, 8, n_agents=2, device="cpu")(g, 0)
    return cfg, opt, exponential_decay(1e-3, 1.0), state, batch


def test_span_lists_of_the_launch_steps(monkeypatch):
    """The launch steps open their spans in the bundle current at the
    call (``made_current``): a local step, the three local spans once a
    block (2 agents, one a block); eq. (6), none.  With nothing current
    they record nothing."""
    from repro_torch.launch.steps import make_consensus_step, make_local_step
    from repro_torch.obs import Observability

    cfg, opt, sched, state, batch = _lm_pair(monkeypatch)
    obs = Observability(tapi.ObsSpec(enabled=True), device="cpu")
    step = make_local_step(cfg, opt, sched, remat=False)
    merge = make_consensus_step(cfg, W=torch.full((2, 2), 0.5))
    g = torch.Generator().manual_seed(1)
    prior = merge(state.posterior)
    step(state, prior, batch, generator=g)
    assert obs.tracer.spans == []
    with made_current(obs):
        prior = merge(state.posterior)
        assert obs.tracer.spans == []
        for _ in range(2):
            state, loss = step(state, prior, batch, generator=g)
    assert current_obs() is None
    assert [(sp.name, sp.depth) for sp in obs.tracer.spans] == [
        (name, 0) for name in LOCAL] * 2 * 2
    assert torch.isfinite(loss)


def test_current_bundle_nests_and_is_cleared_after_a_round(monkeypatch):
    s = tapi.build_session(_tiny_spec(tapi, tapi.ObsSpec(enabled=True)), device="cpu")
    seen = []
    run_round = s.engine.run_round

    def spy(*a, **k):
        seen.append(current_obs())
        return run_round(*a, **k)

    monkeypatch.setattr(s.engine, "run_round", spy)
    assert current_obs() is None
    s.round()
    assert seen == [s.obs] and current_obs() is None
    outer, inner = object(), object()
    with made_current(outer):
        with made_current(inner):
            assert current_obs() is inner
        assert current_obs() is outer
        s.round()
        assert seen[-1] is s.obs and current_obs() is outer
    assert current_obs() is None
    with pytest.raises(RuntimeError), made_current(outer):
        raise RuntimeError
    assert current_obs() is None


def test_spans_are_record_function_ranges_while_the_profiler_records():
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    spec = _sparse_spec(tapi, tapi.ObsSpec(enabled=True, convergence=False))
    s = tapi.build_session(spec, device="cpu")
    s.round()
    n0 = len(s.obs.tracer.spans)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.round()
    assert not autograd_profiler._is_profiler_enabled
    ranges = collections.Counter(e.name for e in prof.events())
    spans = collections.Counter(sp.name for sp in s.obs.tracer.spans[n0:])
    assert {"local.forward", "gossip.consensus", "session.round"} <= set(spans)
    assert all(ranges[name] == n for name, n in spans.items()), (ranges, spans)


def test_serving_hooks_record_requests_and_publishes():
    s = tapi.build_session(_gossip_spec(tapi, tapi.ObsSpec(enabled=True)), device="cpu")
    s.run()
    snap = s.snapshot(dtype="bf16")
    server = s.attach_server(mc_samples=4, bucket_sizes=(2, 8), max_staleness=0,
                             staleness_policy="flag")
    assert server.obs is s.obs
    x = s.data.x_test.numpy()
    server.query(x[:3])
    server.serve([x[:1], x[:5]], agents=[0, 1], mc_samples=0)
    s.run(n_rounds=1)
    server.query(x[:2])  # one window stale: flagged
    reg = s.obs.registry
    assert reg.counter("serve.published").value() == 1
    assert reg.gauge("serve.snapshot_bytes").value() == snap.nbytes()
    assert reg.counter("serve.requests").value() == 4
    assert reg.counter("serve.rows").value() == 11
    assert reg.counter("serve.slo_breaches").value() == 1
    assert reg.histogram("serve.latency_us").summary(mc="4")["count"] == 2
    assert reg.histogram("serve.latency_us").summary(mc="0")["count"] == 1
    reqs = [sp for sp in s.obs.tracer.spans if sp.name == "serve.request"]
    assert [sp.attrs["slo_ok"] for sp in reqs] == [True, True, False]
    assert [sp.dur_us for sp in reqs] == server._lat_us
    assert "serve.publish" in {sp.name for sp in s.obs.tracer.spans}
    ev = s.evaluate(n_mc=1)
    assert reg.gauge("serving.slo.breaches").value() == ev["serving"]["slo"]["breaches"] == 1
    assert "serving: published 1" in s.dashboard()


def test_evaluate_namespaces_engine_telemetry():
    s = tapi.build_session(_tiny_spec(tapi), device="cpu")
    s.run()
    s.engine.telemetry = lambda state: {"acc": "CLOBBER", "avg_acc": -1.0}
    out = s.evaluate(n_mc=1)
    assert isinstance(out["acc"], list) and out["avg_acc"] >= 0.0
    assert out["engine"] == {"acc": "CLOBBER", "avg_acc": -1.0}


def test_evaluate_ingests_blocks_and_eval_gauges():
    s = tapi.build_session(_gossip_spec(tapi, tapi.ObsSpec(enabled=True)), device="cpu")
    s.run()
    ev = s.evaluate(n_mc=1)
    got = s.obs.registry.collect()
    assert got["engine.merges.total"] == ev["engine"]["merges"]["total"]
    assert got["engine.staleness.p90"] == ev["engine"]["staleness"]["p90"]
    assert got["eval.avg_acc"] == ev["avg_acc"]
    lin = tapi.build_session(_linreg_spec(tapi, tapi.ObsSpec(enabled=True)), device="cpu")
    lin.run()
    mse = lin.evaluate()["avg_mse"]
    assert lin.obs.registry.gauge("eval.avg_mse").value() == mse
    assert lin.obs.convergence.stats and set(lin.obs.convergence.stats[0]) == {"disagreement"}


def test_obs_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "obs.ckpt")
    s = tapi.build_session(_tiny_spec(tapi, tapi.ObsSpec(enabled=True)), device="cpu")
    plain = tapi.build_session(_tiny_spec(tapi), device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(s.state)] == [
        tuple(x.shape) for x in tree_leaves(plain.state)]
    s.run()
    s.save(path)
    back = tapi.Session.load(path, device="cpu")
    assert back.spec.obs.enabled and isinstance(back.obs, Observability)
    assert torch.equal(back.posterior().mean, s.posterior().mean)
    assert back.round_idx == s.round_idx
    back.round()
    assert back.obs.registry.counter("session.rounds").value() == 1


def test_jax_checkpoint_with_obs_on_loads_with_its_bundle(tmp_path):
    """A JAX checkpoint whose spec has observability on rebuilds the bundle
    in the port (the silent ``ObsSpec`` fault: it used to load without one)."""
    path = str(tmp_path / "jax.ckpt")
    js = japi.build_session(_tiny_spec(japi, japi.ObsSpec(enabled=True)))
    js.run()
    js.save(path)
    back = tapi.Session.load(path, device="cpu")
    assert isinstance(back.obs, Observability) and callable(back.dashboard)
    back.run(n_rounds=2)
    assert back.obs.registry.counter("session.rounds").value() == 2


def test_obs_jsonl_path_writes_trace(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    s = tapi.build_session(_tiny_spec(tapi, tapi.ObsSpec(enabled=True, jsonl_path=path)),
                           device="cpu")
    s.run()
    s.dashboard()  # flushes
    events = [json.loads(x) for x in open(path)]
    kinds = {e["kind"] for e in events}
    assert "span" in kinds and ("counter" in kinds or "gauge" in kinds)


# -- against the JAX package ---------------------------------------------------------


# the port's spans inside a round, window or step, which the reference does not open
PORT_ONLY_SPANS = {"local.forward", "local.backward", "local.optimizer", "round.local_phase",
                   "round.consensus", "gossip.local_phase", "gossip.consensus"}


def _dashboard_pair(make, serve):
    sessions = []
    for mod, kw in ((japi, {}), (tapi, {"device": "cpu"})):
        s = mod.build_session(make(mod, mod.ObsSpec(enabled=True)), **kw)
        s.run()
        if serve:
            s.snapshot()
            server = s.attach_server(mc_samples=2, bucket_sizes=(4,))
            x = np.asarray(s.data.x_test[:3])
            server.query(x)
            server.query(x, agent=1)
        s.evaluate(n_mc=2)
        sessions.append(s)
    return sessions


@pytest.mark.parametrize("case", ["synchronous", "gossip", "gossip_served"])
def test_dashboard_matches_the_reference(case):
    make = {"synchronous": _tiny_spec, "gossip": _gossip_spec,
            "gossip_served": _gossip_spec}[case]
    js, ts = _dashboard_pair(make, serve=case == "gossip_served")
    jd, td = js.dashboard().splitlines(), ts.dashboard().splitlines()
    td = [x for x in td if not (x.startswith("span ") and x.split()[1] in PORT_ONLY_SPANS)]
    assert [_template(x) for x in td] == [_template(x) for x in jd]
    assert td[0] == jd[0]
    names = {sp.name for sp in ts.obs.tracer.spans}
    assert names - PORT_ONLY_SPANS == {sp.name for sp in js.obs.tracer.spans}
    assert ts.obs.tracer.summary().keys() - PORT_ONLY_SPANS == js.obs.tracer.summary().keys()
    for name, modes in js.obs.tracer.summary().items():
        got = ts.obs.tracer.summary()[name]
        assert {m: v["n"] for m, v in got.items()} == {m: v["n"] for m, v in modes.items()}
    jreg, treg = js.obs.registry, ts.obs.registry
    assert sorted(treg._instruments) == sorted(jreg._instruments)
    for name, inst in jreg._instruments.items():
        mine = treg._instruments[name]
        assert mine.kind == inst.kind and sorted(mine.series) == sorted(inst.series)
        if inst.kind == "counter":
            assert {k: s.value for k, s in mine.series.items()} == {
                k: s.value for k, s in inst.series.items()}, name
        if inst.kind == "histogram":
            assert {k: s.count for k, s in mine.series.items()} == {
                k: s.count for k, s in inst.series.items()}, name
    counts = ("session.n_trained", "gossip.jit_traces", "serve.snapshot_bytes",
              "engine.merges.total", "engine.staleness.max", "serving.requests")
    for name in counts:
        if name in jreg._instruments:
            assert treg.gauge(name).value() == jreg.gauge(name).value(), name
    assert treg._info == jreg._info


def _quickstart_ring(mod):
    """examples/quickstart.py:59's convergence demo."""
    return mod.ExperimentSpec(
        topology=mod.TopologySpec(kind="bidirectional_ring", params={"n": 4}),
        data=mod.DataSpec(dataset_params=dict(n_classes=3, dim=8, n_train_per_class=30),
                          partition="iid", partition_params=dict(n_agents=4),
                          batch_size=4, local_updates=1),
        inference=mod.InferenceSpec(hidden=8, depth=1, lr=0.0, shared_init=False),
        run=mod.RunSpec(n_rounds=10, seed=0),
        obs=mod.ObsSpec(enabled=True),
    )


@pytest.fixture(scope="module")
def quickstart_pair():
    """The quickstart's lr = 0 ring in both packages from the JAX init; the
    JAX session's posterior after each round kept as numpy."""
    js = japi.build_session(_quickstart_ring(japi))
    jp = js.state.posterior
    params = {k: torch.from_numpy(np.array(v)) for k, v in jp.layout.unflatten(jp.mean).items()}
    ts = tapi.build_session(_quickstart_ring(tapi), device="cpu", init_params=params)
    assert torch.equal(ts.posterior().mean, torch.from_numpy(np.array(jp.mean)))
    posts = []
    for _ in range(10):
        js.round()
        posts.append((np.asarray(js.posterior().mean), np.asarray(js.posterior().rho)))
    ts.run()
    return js, ts, posts


def test_tracker_on_jax_posteriors_gives_jax_overlay(quickstart_pair):
    js, ts, posts = quickstart_pair
    W = np.asarray(_quickstart_ring(tapi).topology.w_schedule()(0))
    mine = ConvergenceTracker(W=W)
    for r, (mean, rho) in enumerate(posts, start=1):
        mine.update(FlatPosterior(torch.from_numpy(mean), torch.from_numpy(rho),
                                  ts.posterior().layout), r)
    want, got = js.obs.convergence.report(), mine.report()
    assert got["theory_rate"] == want["theory_rate"]
    assert got["measured_rate"] == pytest.approx(want["measured_rate"], rel=RTOL)
    assert [r["round"] for r in got["overlay"]] == [r["round"] for r in want["overlay"]]
    for g, w in zip(got["overlay"], want["overlay"]):
        assert g["measured"] == pytest.approx(w["measured"], rel=RTOL)
        assert g["predicted"] == pytest.approx(w["predicted"], rel=RTOL)


def test_quickstart_overlay_matches_jax(quickstart_pair):
    js, ts, _ = quickstart_pair
    want, got = js.obs.convergence.report(), ts.obs.convergence.report()
    assert got["theory_rate"] == want["theory_rate"] == pytest.approx(math.log(3.0))
    assert got["measured_rate"] == pytest.approx(want["measured_rate"], rel=RTOL)
    # eq. (6) rounds each lane about once a round in either package: past
    # the rows where the disagreement is well above that, the two agree
    # to the posterior's own fp32 rounding, summed over the rounds
    floor = 10 * 2.0 ** -24 * float(np.abs(np.asarray(js.posterior().mean)).max())
    assert [r["round"] for r in got["overlay"]] == list(range(1, 11))
    for g, w in zip(got["overlay"], want["overlay"]):
        assert g["measured"] == pytest.approx(w["measured"], rel=RTOL, abs=floor)
        assert g["predicted"] == pytest.approx(w["predicted"], rel=RTOL, abs=floor)
    assert sum(abs(g["measured"] - w["measured"]) <= RTOL * w["measured"]
               for g, w in zip(got["overlay"], want["overlay"])) >= 8


# -- the reference's pinned one-trace specs --------------------------------------------


def _pinned(mod, topo, n, n_rounds, local_updates=2, **inf):
    """tests/test_gossip.py:75's spec."""
    return mod.ExperimentSpec(
        topology=topo,
        data=mod.DataSpec(dataset_params=dict(n_classes=3, dim=8, n_train_per_class=30),
                          partition="iid", partition_params=dict(n_agents=n), batch_size=4,
                          local_updates=local_updates),
        inference=mod.InferenceSpec(**{"hidden": 8, "depth": 1, "lr": 1e-2, **inf}),
        run=mod.RunSpec(n_rounds=n_rounds, seed=0),
    )


def _delayed_doc(delay, inner=None):
    return {"kind": "delayed", "inner": inner or {"kind": "poisson", "rate": 0.8, "seed": 1},
            "latency": {"kind": "constant", "delay": delay}}


def _all_edges_then_empty(n):
    edges = [[int(i), int(j)] for i, j in _directed_edges(bidirectional_ring_w(n))]
    return {"kind": "trace", "trace": [edges, []], "local_policy": "active"}


PINNED_ONE_TRACE = {
    "test_gossip_346_poisson": lambda: _pinned(
        tapi, tapi.TopologySpec.gossip("bidirectional_ring", {"n": 4},
                                       clock={"kind": "poisson", "rate": 0.7}), 4, 5),
    "test_gossip_672_latency0": lambda: _pinned(
        tapi, tapi.TopologySpec.gossip("bidirectional_ring", {"n": 6}, clock=_delayed_doc(
            0, {"kind": "poisson", "rate": 0.8, "seed": 1})), 6, 4),
    "test_gossip_914_empty_window": lambda: _pinned(
        tapi, tapi.TopologySpec(kind="gossip",
                                params={"base": "bidirectional_ring", "base_params": {"n": 4}},
                                clock=_all_edges_then_empty(4)), 4, 2),
    "test_wire_dtype_509_bf16": lambda: _pinned(
        tapi, tapi.TopologySpec.gossip("bidirectional_ring", {"n": 4},
                                       clock={"kind": "poisson", "rate": 0.8, "seed": 0}),
        4, 3, wire_dtype="bf16"),
    "test_obs_408": lambda: _gossip_spec(tapi, tapi.ObsSpec(enabled=True)),
}


@pytest.mark.parametrize("name", sorted(PINNED_ONE_TRACE))
def test_n_traces_is_one_where_the_reference_pins_one(name):
    s = tapi.build_session(PINNED_ONE_TRACE[name](), device="cpu")
    s.run()
    assert s.engine.n_traces == 1


def test_n_traces_is_one_across_a_delayed_save_and_load(tmp_path):
    """tests/test_gossip.py:752: both the resumed and the running session
    count one trace."""
    clock = {"kind": "delayed", "inner": {"kind": "poisson", "rate": 0.9, "seed": 2},
             "latency": {"kind": "geometric", "p": 0.5, "max": 3}}
    spec = _pinned(tapi, tapi.TopologySpec.gossip("bidirectional_ring", {"n": 6}, clock=clock),
                   6, 6)
    spec = dataclasses.replace(spec, run=dataclasses.replace(spec.run, seed=2))
    s = tapi.build_session(spec, device="cpu")
    s.run(3)
    path = str(tmp_path / "delayed.ckpt")
    s.save(path)
    s2 = tapi.Session.load(path, device="cpu")
    s.run(3)
    s2.run(3)
    assert s.engine.n_traces == s2.engine.n_traces == 1


def test_n_traces_counts_a_new_signature():
    """A window of another shape is another signature: the reference's jit
    would trace again (here a batch of five rows in place of four)."""
    s = tapi.build_session(_gossip_spec(tapi), device="cpu")
    s.run(n_rounds=2)
    assert s.engine.n_traces == 1
    for _ in range(2):
        r = s.round_idx
        batches = s.data.sampler(s.generator, r)
        wider = {k: torch.cat([v, v[:, :, :1]], dim=2) for k, v in batches.items()}
        W = s.spec.topology.w_schedule()(r)
        s.state, _ = s.engine.run_round(s.state, wider, W, generator=s.generator)
        s.round_idx += 1
        assert s.engine.n_traces == 2
