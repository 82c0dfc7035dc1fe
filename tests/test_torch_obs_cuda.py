"""The observability layer of repro_torch on an NVIDIA GPU.  Every test is
marked ``cuda`` and skips without a card.  This file imports neither JAX
nor the JAX package, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_obs_cuda.py

On the card a run with observability on is bitwise the run with it off (the
spans' synchronises and the convergence reduction write no training state);
a span synchronises before each clock read, so it lasts at least as long
as the device work inside it by CUDA events; the first observed round is
the compile bucket's; and ``network_stats`` on the card agrees with the
CPU's within rtol 1e-5 (another order of the fp32 sums).
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
        pytest.skip("needs an NVIDIA GPU: the spans synchronise CUDA, the kernels have no "
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
    assert runs[True].obs.tracer.sync is not None


@pytest.mark.cuda
def test_span_lasts_at_least_the_device_work_inside_it(dev):
    tr = Tracer(enabled=True, sync=lambda: torch.cuda.synchronize(dev))
    x = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize(dev)
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with tr.span("matmuls"):
            start.record()
            for _ in range(8):
                x = (x @ x).clamp_(-1.0, 1.0)
            end.record()
        device_us = start.elapsed_time(end) * 1e3
        assert tr.spans[-1].dur_us >= device_us > 0


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
