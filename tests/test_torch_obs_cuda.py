"""The observability layer of repro_torch on an NVIDIA GPU.  Every test is
marked ``cuda`` and skips without a card.  This file imports neither JAX
nor the JAX package, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_obs_cuda.py

On the card a run with observability on is bitwise the run with it off (the
spans' timing events and the convergence reduction write no training
state); a span calls no synchronise, so it returns on the host long before
the work queued inside it is done, and its device time, once resolved,
covers that work's CUDA-event time; under ``torch.profiler`` a span's
range on the card is a user annotation, never a device operation; the
first observed round is the compile bucket's; and ``network_stats`` on the
card agrees with the CPU's within rtol 1e-5 (another order of the fp32
sums).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (  # noqa: E402
    DataSpec,
    ExperimentSpec,
    InferenceSpec,
    ObsSpec,
    RunSpec,
    TopologySpec,
    build_session,
)
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.obs import Tracer, network_stats  # noqa: E402

CHAOS = {"crash_rate": 0.2, "recover_rate": 0.5, "corrupt_rate": 0.3, "corrupt_kind": "mix",
         "seed": 3}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans record CUDA events, the kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spec(kind, obs=None):
    data = DataSpec(dataset_params=dict(n_classes=4, dim=16, n_train_per_class=40),
                    partition="iid", partition_params=dict(n_agents=4), batch_size=8,
                    local_updates=2)
    if kind == "synchronous":
        topo = TopologySpec.grid(2, 2)
        inf = InferenceSpec(hidden=16, depth=2, lr=1e-2)
    else:
        clock = {"kind": "poisson", "rate": 0.8, "seed": 0}
        if kind == "delayed":
            clock = {"kind": "delayed", "inner": clock,
                     "latency": {"kind": "geometric", "p": 0.5, "max": 3}}
        clock = dict(clock, faults=CHAOS)  # on the outermost clock doc
        topo = TopologySpec.gossip("grid", {"rows": 2, "cols": 2}, clock=clock)
        inf = InferenceSpec(hidden=16, depth=2, lr=1e-2, fault_policy="quarantine")
    kw = {} if obs is None else {"obs": obs}
    return ExperimentSpec(topology=topo, data=data, inference=inf,
                          run=RunSpec(n_rounds=3, seed=0), **kw)


def _bits(x):
    x = x.detach().cpu().reshape(-1)
    return x.view(torch.uint8) if x.is_floating_point() else x


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["synchronous", "gossip", "delayed"])
def test_obs_on_is_bitwise_obs_off_on_the_card(dev, kind, tmp_path):
    runs = {}
    for on in (False, True):
        obs = ObsSpec(enabled=True, jsonl_path=str(tmp_path / "t.jsonl")) if on else None
        s = build_session(_spec(kind, obs), device=dev)
        s.run()
        s.evaluate()
        s.snapshot()
        s.attach_server(mc_samples=4).query(s.data.x_test[:5].cpu().numpy())
        s.run(n_rounds=1)
        runs[on] = s
    a, b = tree_leaves(runs[False].state), tree_leaves(runs[True].state)
    assert len(a) == len(b)
    assert all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
               for x, y in zip(a, b))
    assert torch.equal(runs[False].generator.get_state(), runs[True].generator.get_state())
    summ = runs[True].obs.tracer.summary()["session.round"]
    assert summ["compile"]["n"] == 1 and summ["warm"]["n"] == 3
    assert runs[True].obs.tracer.device.type == "cuda"
    assert all(sp.device_us is not None for sp in runs[True].obs.tracer.spans)


def _matmul_chain(x, n=8):
    for _ in range(n):
        x = (x @ x).clamp_(-1.0, 1.0)
    return x


@pytest.mark.cuda
def test_span_lasts_at_least_the_device_work_inside_it(dev):
    """Its device time does, once resolved: a span around a queued matmul
    chain (32 products, ~85 ms on the card) calls no synchronise, so every
    span returns on the host before its chain is done and the median span
    in under a tenth of its device time; that device time covers the
    chain's CUDA-event time.  (A test process's host stalls now and then,
    up to ~45 ms measured, so no single span's host time is held to the
    tenth; a synchronising span lasts its whole chain.)  A first span and
    chain, not measured, take the process's first calls' host costs."""
    tr = Tracer(enabled=True, device=dev)
    with tr.span("warm-up"):
        x = _matmul_chain(torch.randn(4096, 4096, device=dev))
    torch.cuda.synchronize(dev)
    chains, done_at_exit = [], []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with tr.span("matmuls"):
            start.record()
            x = _matmul_chain(x, 32)
            end.record()
        done_at_exit.append(end.query())
        chains.append((start, end))
    spans = tr.spans[1:]
    assert all(sp.device_us is None for sp in tr.spans)
    tr.resolve()
    assert len(spans) == 5 and not any(done_at_exit)
    for sp, (start, end) in zip(spans, chains):
        assert sp.device_us >= start.elapsed_time(end) * 1e3 > 0
    ratios = sorted(sp.dur_us / sp.device_us for sp in spans)
    assert ratios[2] < 0.1, ratios


@pytest.mark.cuda
def test_span_is_a_user_annotation_on_the_card_under_the_profiler(dev):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr = Tracer(enabled=True, device=dev)
    x = _matmul_chain(torch.randn(1024, 1024, device=dev))
    torch.cuda.synchronize(dev)
    for acts in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=acts) as prof:
            with tr.span("matmuls"):
                x = _matmul_chain(x)
            torch.cuda.synchronize(dev)
        events = prof.events()
        assert any(e.device_type == DeviceType.CUDA and not e.is_user_annotation
                   for e in events)  # the chain's kernels
        named = [e for e in events if e.name == "matmuls" and e.device_type == DeviceType.CUDA]
        assert all(e.is_user_annotation for e in named), named


@pytest.mark.cuda
def test_network_stats_on_the_card_match_the_cpu(dev, monkeypatch):
    from repro_torch.obs import convergence

    g = torch.Generator().manual_seed(0)
    mean = torch.randn((37, 40_000), generator=g) * 0.5
    rho = torch.rand((37, 40_000), generator=g) * 7.0 - 6.0
    got = network_stats(mean.to(dev), rho.to(dev))  # one chunk
    monkeypatch.setattr(convergence, "CHUNK_BYTES", 4 * 37 * 4_096)
    want = network_stats(mean, rho)  # ten chunks
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
