"""The pod consensus and expert parallelism on an NVIDIA GPU, against the
port's own forms.  Marked ``cuda``: every test skips without a card.  This
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_sharding_cuda.py

* ``consensus_ppermute_pod`` over a ragged three-leaf dict on a
  ``("pod", "data", "model")`` mesh of virtual shards of the card (and of
  the real cards where there are two or more) is bitwise
  ``consensus_ppermute_ring_flat`` on the same posterior flattened, at
  wire f32, bf16 and f16: on the card every lane of an elementwise kernel
  takes one path, whatever its place in the buffer.
* ``moe_ffn_expert_parallel`` at OLMoE's ``reduced()`` width with 8
  experts, float32 (TF32 off), on the card within 1e-5 of its CPU run on
  the same mesh shape, and two calls the same bits; over the real cards too.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.flat import flat_posterior_from_pytree  # noqa: E402
from repro_torch.core.posterior import GaussianPosterior  # noqa: E402
from repro_torch.launch import consensus_opt as co  # noqa: E402
from repro_torch.launch.expert_parallel import moe_ffn_expert_parallel  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import param_shardings  # noqa: E402
from repro_torch.models.moe import moe_init  # noqa: E402

WIRES = (torch.float32, torch.bfloat16, torch.float16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this file checks the card's runs")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _posts(a, device):
    g = torch.Generator().manual_seed(a)

    def leaf(*shape):
        return torch.randn((a,) + shape, generator=g)

    shapes = {"a": (6, 10), "b": {"c": (37,), "w": (3, 4, 14)}}

    def make(tree, fn):
        return {k: make(v, fn) if isinstance(v, dict) else fn(leaf(*v)).to(device)
                for k, v in tree.items()}

    return GaussianPosterior(mean=make(shapes, lambda x: x),
                             rho=make(shapes, lambda x: x * 0.5 - 3))


def _w(a):
    w = torch.zeros(a, a)
    for i in range(a):
        w[i, i], w[i, (i - 1) % a], w[i, (i + 1) % a] = 0.5, 0.3, 0.2
    return w if a > 2 else torch.tensor([[0.6, 0.4], [0.25, 0.75]])


def _pod_vs_ring(post, mesh, W, wire):
    sh = param_shardings(post, mesh, agent_leading=True)
    got = flat_posterior_from_pytree(co.consensus_ppermute_pod(post, W, mesh, sh, wire_dtype=wire),
                                     leading_axes=1)
    ring = co.consensus_ppermute_ring_flat(flat_posterior_from_pytree(post, leading_axes=1), mesh,
                                           "pod", wire_dtype=wire, W=W)
    return got, ring


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES, ids=str)
@pytest.mark.parametrize("a,data,model", [(2, 2, 1), (3, 1, 2), (4, 1, 1)])
def test_pod_consensus_is_bitwise_the_ring(dev, a, data, model, wire):
    post = _posts(a, dev)
    mesh = make_mesh((a, data, model), ("pod", "data", "model"), dev)
    got, ring = _pod_vs_ring(post, mesh, _w(a).to(dev), wire)
    assert got.mean.device.type == "cuda"
    assert torch.equal(got.mean, ring.mean) and torch.equal(got.rho, ring.rho)


@pytest.mark.cuda
def test_pod_consensus_over_real_cards(dev):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("one card: the virtual shards above cover it")
    cards = [torch.device("cuda", i) for i in range(2)]
    post = _posts(2, dev)
    virtual, _ = _pod_vs_ring(post, make_mesh((2, 1, 1), ("pod", "data", "model"), dev),
                              _w(2).to(dev), torch.bfloat16)
    real, ring = _pod_vs_ring(post, make_mesh((2, 1, 1), ("pod", "data", "model"), cards),
                              _w(2).to(dev), torch.bfloat16)
    assert torch.equal(real.mean, virtual.mean) and torch.equal(real.rho, virtual.rho)
    assert torch.equal(real.mean, ring.mean)


def _moe(device, shape, devices=None):
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), n_experts=8, top_k=2,
                              capacity_factor=1.25)
    p = moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(1))
    mesh = make_mesh(shape, ("data", "model"), devices or device)
    return moe_ffn_expert_parallel({k: v.to(device) for k, v in p.items()}, x.to(device), cfg,
                                   mesh)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 4), (1, 8)], ids=str)
def test_expert_parallel_card_against_cpu(dev, shape):
    y, aux = _moe(dev, shape)
    y2, aux2 = _moe(dev, shape)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    want, want_aux = _moe(torch.device("cpu"), shape)
    torch.testing.assert_close(y.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_expert_parallel_over_real_cards(dev):
    n = torch.cuda.device_count()
    m = max(k for k in (1, 2, 4, 8) if k <= n)
    if m < 2:
        pytest.skip("one card: the virtual shards above cover it")
    cards = [torch.device("cuda", i) for i in range(m)]
    virtual, aux_v = _moe(dev, (1, m))
    real, aux_r = _moe(dev, (1, m), cards)
    assert torch.equal(real, virtual) and torch.equal(aux_r, aux_v)
