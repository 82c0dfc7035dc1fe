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
* The sharded LM steps (``launch.spmd_steps``) at ``reduced()`` width,
  float32: the prefill and a decode step of Qwen3-8B, Granite-20B,
  Pixtral-12B, OLMoE-1B-7B, Phi-3.5-MoE, RecurrentGemma-9B, xLSTM-1.3B and
  Whisper-tiny (frames in the batch, the encoder re-run in the decode
  step) placed on a (2, 2, 2) mesh of virtual shards of the card, within
  1e-5 of the same steps placed on the CPU and of the card's unsharded
  steps, ``flash_attention`` once an attention layer a position (twice a
  ``dec_attn`` layer; the encoder's in the prefill and the step), two
  calls the same bits; the train round of repro-100m, a pytree state on
  (2, 2, 2) and a flat one on (2, 1, 1) and on (2, 2, 2) (its rows run as
  the parameter dict they flatten), the pytree state's ppermute round and
  the flat state's einsum round at the bf16 wire on (2, 2, 2), and of
  OLMoE, RecurrentGemma, xLSTM and Whisper-tiny, a pytree state on (2, 2,
  2), within 1e-4 of the card's unsharded round of the same route (Adam's
  moments, and the posterior off the lanes whose Adam step is a
  rounding-noise sign), ``consensus_fused_network`` once a (data, model)
  position on the einsum routes; over two real cards (each pod on its
  own) the prefill and the train round bitwise the virtual run.
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
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.sharding import cache_shardings  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

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


AXES = ("pod", "data", "model")


def _lm(arch, device):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    ps = [init_params(cfg, torch.Generator().manual_seed(10 + i), device="cpu") for i in range(2)]
    params = tree_map(lambda *xs: torch.stack(xs).to(device), *ps)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 4, 8), generator=g).to(device)}
    n_p = cfg.n_patches if cfg.frontend == "vision_stub" else 0
    if n_p:
        batch["patches"] = (0.1 * torch.randn(2, 4, n_p, cfg.d_model, generator=g)).to(device)
    if cfg.is_encdec:
        batch["frames"] = (0.1 * torch.randn(2, 4, cfg.encoder_seq, cfg.d_model,
                                             generator=g)).to(device)
    return cfg, params, batch, n_p


def _serve(cfg, params, batch, n_p, mesh):
    """Prefill and one decode step, placed on ``mesh`` when it is given."""
    device = params["embed"]["emb"].device
    cache = steps.make_agent_cache(cfg, 2, 4, 8 + n_p + 2, torch.float32, device=device)
    if mesh is not None:
        params = spmd.device_put(params, param_shardings(params, mesh, agent_leading=True))
        cache = spmd.device_put(cache, cache_shardings(cache, mesh))
    lg, cache = steps.make_prefill_step(cfg)(params, batch, cache)
    d, _ = steps.make_decode_step(cfg)(params, batch["tokens"][..., :1], 8 + n_p, cache,
                                       batch.get("frames"))
    return lg, d


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-20b", "pixtral-12b", "olmoe-1b-7b",
                                  "phi3.5-moe-42b-a6.6b", "recurrentgemma-9b", "xlstm-1.3b",
                                  "whisper-tiny"])
def test_sharded_serving_card_against_cpu(dev, arch):
    cfg, params, batch, n_p = _lm(arch, dev)
    dispatch.reset_launch_counts()
    lg, d = _serve(cfg, params, batch, n_p, make_mesh((2, 2, 2), AXES, dev))
    # a prefill's attention layers (a dec_attn layer's two, the encoder's), and
    # the encoder again in the decode step
    n_attn = sum(1 + (kind == "dec_attn") for kind in cfg.pattern * cfg.n_periods + cfg.tail
                 if kind not in ("rglru", "mlstm", "slstm")) + 2 * cfg.encoder_layers
    assert dispatch.launch_counts()["flash_attention"] == n_attn * 8
    lg2, d2 = _serve(cfg, params, batch, n_p, make_mesh((2, 2, 2), AXES, dev))
    assert torch.equal(lg, lg2) and torch.equal(d, d2)
    cpu = tree_map(lambda x: x.cpu(), (params, batch))
    want, want_d = _serve(cfg, *cpu, n_p, make_mesh((2, 2, 2), AXES, torch.device("cpu")))
    torch.testing.assert_close(lg.cpu(), want, atol=1e-5, rtol=0)
    torch.testing.assert_close(d.cpu(), want_d, atol=1e-5, rtol=0)
    ref, ref_d = _serve(cfg, params, batch, n_p, None)
    torch.testing.assert_close(lg, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(d, ref_d, atol=1e-5, rtol=0)


ROUTES = {"einsum": {}, "ppermute-bf16": {"consensus_impl": "ppermute"},
          "wire-bf16": {"consensus_wire_dtype": torch.bfloat16}}
TRAIN_W = torch.tensor([[0.75, 0.25], [0.25, 0.75]])


def _train_state(device, flat, arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    state = steps.init_train_state(cfg, 2, adam(), torch.Generator().manual_seed(0), flat=flat,
                                   device="cpu")
    g = torch.Generator().manual_seed(7)
    for m in tree_leaves(state.posterior.mean):
        m[1] += 0.01 * torch.randn(m.shape[1:], generator=g)
    eps = tree_map(lambda m: torch.randn(m.shape, generator=g), state.posterior.mean)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 4, 32), generator=g)
             for k in ("tokens", "targets")}
    if cfg.is_encdec:
        batch["frames"] = 0.1 * torch.randn(2, 4, cfg.encoder_seq, cfg.d_model, generator=g)
    return (cfg, *tree_map(lambda x: x.to(device), (state, eps, batch)))


def _train(device, flat, mesh=None, arch="repro-100m", route="einsum", ring_mesh=None):
    """One train round of the reduced ``arch`` (placed on ``mesh``, or not);
    the ppermute route's unplaced ring runs over ``ring_mesh``."""
    cfg, state, eps, batch = _train_state(device, flat, arch)
    kw = dict(ROUTES[route])
    if route.startswith("ppermute") and mesh is None:
        kw.update(mesh=ring_mesh, posterior_shardings=param_shardings(
            state, ring_mesh, agent_leading=True).posterior)
    if mesh is not None:
        state = spmd.device_put(state, param_shardings(state, mesh, agent_leading=True))
    step = steps.make_train_round_step(cfg, TRAIN_W, opt=adam(), remat=False, kl_scale=1e-5,
                                       **kw)
    out, metrics = step(state, batch, eps=eps)
    return spmd.device_get(out) if mesh is not None else out, metrics


def _wire_lanes(device, flat, arch, mesh, wire):
    """The lanes where the placed prior at ``wire`` (the network kernel) and
    the unplaced one (``consensus_einsum(_flat)``, plain) part by more than
    1e-5: a statistic at a wire rounding boundary, rounded apart.  One tree
    like the posterior of bools."""
    from repro_torch.launch import spmd_steps

    _, state, _, _ = _train_state(device, flat, arch)
    placed = spmd.device_put(state.posterior, param_shardings(state.posterior, mesh,
                                                              agent_leading=True))
    got = spmd.device_get(spmd_steps.pod_consensus(placed, TRAIN_W, wire))
    want = (co.consensus_einsum_flat if flat else co.consensus_einsum)(
        state.posterior, TRAIN_W, wire_dtype=wire)
    lanes = [(x - y).abs() > 1e-5 * (1.0 + y.abs())
             for x, y in zip(tree_leaves(got), tree_leaves(want))]
    n = len(lanes) // 2
    return [m | r for m, r in zip(lanes[:n], lanes[n:])] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch,flat,shape,route", [
    ("repro-100m", False, (2, 2, 2), "einsum"),
    ("repro-100m", True, (2, 1, 1), "einsum"),
    ("olmoe-1b-7b", False, (2, 2, 2), "einsum"),
    ("recurrentgemma-9b", False, (2, 2, 2), "einsum"),
    ("xlstm-1.3b", False, (2, 2, 2), "einsum"),
    ("whisper-tiny", False, (2, 2, 2), "einsum"),
    ("repro-100m", True, (2, 2, 2), "einsum"),
    ("repro-100m", False, (2, 2, 2), "ppermute-bf16"),
    ("repro-100m", True, (2, 2, 2), "wire-bf16")],
    ids=["pytree-2x2x2", "flat-2x1x1", "olmoe-pytree-2x2x2", "recurrentgemma-pytree-2x2x2",
         "xlstm-pytree-2x2x2", "whisper-pytree-2x2x2", "flat-2x2x2", "ppermute-bf16",
         "wire-bf16"])
def test_sharded_train_round_on_the_card(dev, arch, flat, shape, route):
    """The placed round against the card's unplaced round of the same route
    (a flat state under data x model included); ``consensus_fused_network``
    once a (data, model) position on the einsum routes, never on the
    ppermute one; at the bf16 wire the lanes whose statistic the two priors
    round apart (``_wire_lanes``) are held only by the largest difference."""
    mesh = make_mesh(shape, AXES, dev)
    dispatch.reset_launch_counts()
    got, got_m = _train(dev, flat, mesh, arch, route)
    launches = 0 if route.startswith("ppermute") else shape[1] * shape[2]
    assert dispatch.launch_counts()["consensus_fused_network"] == launches
    want, want_m = _train(dev, flat, arch=arch, route=route, ring_mesh=mesh)
    boundary = (_wire_lanes(dev, flat, arch, mesh, torch.bfloat16) if route == "wire-bf16"
                else None)
    torch.testing.assert_close(got_m["loss"], want_m["loss"], rtol=1e-5, atol=0)
    for field in ("mu", "nu"):
        for x, y in zip(tree_leaves(getattr(got.opt_state, field)),
                        tree_leaves(getattr(want.opt_state, field))):
            torch.testing.assert_close(x, y, atol=1e-4, rtol=0)
    moments = zip(*(tree_leaves(getattr(st.opt_state, f)) for st in (got, want)
                    for f in ("mu", "nu")))
    for k, (x, y, (m1, v1, m2, v2)) in enumerate(zip(tree_leaves(got.posterior),
                                                     tree_leaves(want.posterior), moments)):
        # Adam's noise lanes (chip_smoke.adam_noise_lanes): the two runs' moments apart
        # by more than rounding of a well-set gradient; there a step is about lr either way
        v = torch.maximum(v1, v2)
        noise = ((m1 - m2).abs() > 1e-3 * v.sqrt()) | ((v1 - v2).abs() > 1e-3 * v)
        if boundary is not None:
            noise |= boundary[k]
        d = (x - y).abs()
        assert float(d.masked_fill(noise, 0.0).max()) <= 1e-4
        assert float(d.max()) <= 2.5e-3


@pytest.mark.cuda
def test_sharded_steps_over_real_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("one card: the virtual shards above cover it")
    cards = [torch.device("cuda", p) for p in range(2) for _ in range(4)]
    cfg, params, batch, n_p = _lm("qwen3-8b", dev)
    real = _serve(cfg, params, batch, n_p, make_mesh((2, 2, 2), AXES, cards))
    virtual = _serve(cfg, params, batch, n_p, make_mesh((2, 2, 2), AXES, dev))
    assert all(torch.equal(x.to(dev), y) for x, y in zip(real, virtual))
    for flat, shape in ((False, (2, 2, 2)), (True, (2, 1, 1))):
        n = shape[1] * shape[2]
        mesh_cards = [torch.device("cuda", p) for p in range(2) for _ in range(n)]
        got, _ = _train(dev, flat, make_mesh(shape, AXES, mesh_cards))
        want, _ = _train(dev, flat, make_mesh(shape, AXES, dev))
        assert all(torch.equal(x.to(dev), y) for x, y in zip(tree_leaves(got), tree_leaves(want)))
