"""The serving tier and the launch engine of repro_torch on an NVIDIA GPU.
Every test is marked ``cuda`` and skips without a card.  This file imports
neither JAX nor the JAX package, so it runs where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_serve_cuda.py

The server captures one CUDA graph per key it meets (bucket, request row
shape, mc, layout, resident dtype): the count equals the distinct keys a
stream touches, and replays, other agents and republished snapshots add
none.  The card's served probabilities equal the CPU server's on the same
noise within 1e-5 (fp32 sums in another order), and a run with a server
attached is bitwise the run without.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (  # noqa: E402
    DataSpec,
    ExperimentSpec,
    InferenceSpec,
    RunSpec,
    TopologySpec,
    build_session,
)
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.serve import PredictiveServer, SnapshotStore  # noqa: E402

BUCKETS = (1, 2, 4, 8, 16, 32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: CUDA graphs and the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spec(engine="simulated", n_rounds=2):
    return ExperimentSpec(
        topology=TopologySpec.grid(2, 2),
        data=DataSpec(dataset_params=dict(n_classes=4, dim=16, n_train_per_class=40),
                      partition="iid", partition_params=dict(n_agents=4), batch_size=8,
                      local_updates=2),
        inference=InferenceSpec(hidden=16, depth=2, lr=1e-2),
        run=RunSpec(n_rounds=n_rounds, seed=0, engine=engine),
    )


def _noise(counter, mc, p):
    return torch.randn((mc, p), generator=torch.Generator().manual_seed(counter))


@pytest.mark.cuda
def test_captures_equal_the_distinct_keys_and_replays_add_none(dev):
    s = build_session(_spec(), device=dev)
    s.run()
    s.snapshot()
    server = s.attach_server(mc_samples=8, bucket_sizes=BUCKETS)
    x = s.data.x_test[:80].cpu().numpy()
    sizes = [1, 3, 7, 12, 33, 64, 5, 2]
    keys = set()
    for mc in (8, 0):
        for i, n in enumerate(sizes):
            server.query(x[:n], agent=i % 4, mc_samples=mc)
            keys |= {(b, mc) for b in server._bucket_plan(n)}
    assert server.n_traces == len(keys) == len(server._programs)
    assert all(p.graph is not None for p in server._programs.values())
    before = server.n_traces
    s.snapshot()  # republish
    for mc in (8, 0):
        for i, n in enumerate(sizes):
            probs, _ = server.query(x[:n], agent=(i + 1) % 4, mc_samples=mc)
            assert probs.is_cuda and tuple(probs.shape) == (n, 4)
            np.testing.assert_allclose(probs.sum(-1).cpu().numpy(), 1.0, atol=1e-5)
    assert server.n_traces == before
    s.snapshot(dtype="bf16")  # another resident dtype: new keys
    server.query(x[:5], agent=0)
    assert server.n_traces == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mc", [0, 8])
def test_card_serves_the_cpus_probabilities(dev, dtype, mc):
    s = build_session(_spec(), device=dev)
    s.run()
    snap = s.snapshot(dtype=dtype)
    cpu_store = SnapshotStore()
    cpu_store.publish(type(snap.posterior)(snap.posterior.mean.float().cpu(),
                                           snap.posterior.rho.float().cpu(),
                                           snap.posterior.layout), window=0, dtype=dtype)
    card = s.attach_server(mc_samples=mc, bucket_sizes=BUCKETS, noise_fn=_noise)
    cpu = PredictiveServer(cpu_store, s.model.logits_fn, mc_samples=mc, bucket_sizes=BUCKETS,
                           noise_fn=_noise)
    x = s.data.x_test[:50].cpu().numpy()
    reqs, agents = [x[:3], x[3:40], x[40:50]], [1, 3, 1]
    got, _ = card.serve(reqs, agents=agents)
    want, _ = cpu.serve(reqs, agents=agents)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_serving_attached_run_is_bitwise_on_the_card(dev):
    plain, served = build_session(_spec(), device=dev), build_session(_spec(), device=dev)
    server = None
    for r in range(3):
        plain.round()
        served.round()
        served.snapshot(dtype="bf16" if r % 2 else "f32")
        server = server or served.attach_server(mc_samples=4, bucket_sizes=(2, 8))
        server.query(served.data.x_test[:5].cpu().numpy(), agent=r % 4)
    assert torch.equal(plain.posterior().mean, served.posterior().mean)
    assert torch.equal(plain.posterior().rho, served.posterior().rho)
    assert torch.equal(plain.generator.get_state(), served.generator.get_state())


@pytest.mark.cuda
def test_launch_engine_runs_the_consensus_kernel_and_agrees_with_simulated(dev):
    sim = build_session(_spec("simulated", 3), device=dev)
    lau = build_session(_spec("launch", 3), device=dev)
    sim.run()
    dispatch.reset_launch_counts()
    lau.run()
    assert dispatch.launch_counts()["consensus_fused_network"] == 3
    for f in ("mean", "rho"):
        np.testing.assert_allclose(getattr(lau.posterior(), f).cpu().numpy(),
                                   getattr(sim.posterior(), f).cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert lau.health()["all_ok"]
