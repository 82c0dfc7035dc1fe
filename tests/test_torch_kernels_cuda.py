"""The CUDA kernels of repro_torch against their plain PyTorch versions on
an NVIDIA GPU.  A CUDA kernel has no CPU mode, so every test here is marked
``cuda`` and skips without a card.  This file imports neither JAX nor the
JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: at f32 rtol 1e-5 / atol 1e-5 (the kernel and cuBLAS sum the
N terms in another order); at bf16/f16 one wire ulp relative to the output
scale (a one-ulp fp32 difference in prec can flip a rounding tie).
Validity is bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import consensus as k  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

WIRE_EPS = {"bf16": 2.0 ** -7, "f16": 2.0 ** -10}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, p, seed, dev):
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)).astype(np.float32) + 0.05
    w /= w.sum(axis=1, keepdims=True)
    mean = rng.normal(size=(n, p)).astype(np.float32)
    rho = rng.uniform(-4.5, 0.5, size=(n, p)).astype(np.float32)
    return (torch.from_numpy(a).to(dev) for a in (w, mean, rho))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,p", [(1, 5), (9, 4099), (17, 257), (300, 4099)])
def test_consensus_kernel_matches_plain(dev, n, p, wire):
    W, mean, rho = _inputs(n, p, n + p, dev)
    before = dispatch.launch_counts()["consensus_fused_network"]
    got = k.consensus_fused_network(W, mean, rho, wire_dtype=wire)
    want = k.consensus_network_plain(W, mean, rho, wire)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["consensus_fused_network"] == before + 1
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if wire == "f32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            u = WIRE_EPS[wire]
            np.testing.assert_allclose(g, w, rtol=u, atol=u * np.abs(w).max())


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("p", [1, 700, 5000])
def test_payload_validity_kernel_bit_equal(dev, wire, p):
    rng = np.random.default_rng(p)
    mean = rng.normal(size=(6, p)).astype(np.float32)
    rho = rng.uniform(-3.0, 0.5, size=(6, p)).astype(np.float32)
    mean[1, p // 3] = np.nan
    rho[2, p - 1] = np.inf
    rho[3, 0] = -np.inf
    mean[4, p // 2] = 1e30
    rho[5, p // 4] = -6.0
    mean, rho = torch.from_numpy(mean).to(dev), torch.from_numpy(rho).to(dev)
    got = k.payload_validity_fused(mean, rho, bound=1e20, wire_dtype=wire)
    want = k.payload_validity_plain(mean, rho, bound=1e20, wire_dtype=wire)
    assert torch.equal(got.cpu(), want.cpu())
    assert got.cpu().tolist() == [True, False, False, False, False, wire != "f16"]


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    W, mean, rho = _inputs(4, 64, 0, dev)
    with pytest.raises(TypeError):
        k.consensus_fused_network(W, mean.double(), rho.double())
    with pytest.raises(ValueError):
        k.consensus_fused_network(W, mean.t(), rho.t())
    with pytest.raises(ValueError):
        k.consensus_fused_network(W[:3, :3], mean, rho)
    with pytest.raises(ValueError):
        k.payload_validity_fused(mean, rho.cpu(), bound=1e20)
