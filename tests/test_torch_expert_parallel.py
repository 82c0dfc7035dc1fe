"""The port's expert-parallel MoE (``repro_torch.launch.expert_parallel``)
against the JAX package's on the CPU, at OLMoE-1B-7B's ``reduced()``
width with 8 experts, top-2, float32.

The reference runs under ``shard_map`` on 8 virtual XLA devices, so it runs
once for this file in a subprocess (``conftest.run_multidevice_subprocess``,
``Auto`` mesh axes: under jax 0.9's default ``Explicit`` axes its last
reshape raises, ROADMAP "faults of its own") and writes its outputs to an
``.npz``.  The port runs on virtual shards of the CPU (``launch.mesh.Mesh``
over ``[cpu] * n``).  Inputs are made with numpy from seeds; a shared
component in the tokens skews the routing so that slots overflow at
capacity factor 1.25.

Held: ``_dispatch_to_buffers`` bit for bit against the reference's, with
slots past capacity and a ``keep`` mask; at capacity factor 16 (no drops)
the output within 1e-5 of the port's ``moe_ffn`` on meshes (1, 1), (1, 2),
(2, 4) and (1, 8); at 1.25, with drops, the output within 1e-5 of the
reference's and the aux at 1e-6, every shard's kept slots (the send
buffers' source and local-expert metadata) equal to those the reference's
own routing and dispatch give, their router weights within 1e-5 (the
skewed tokens' logits are large, so one rounding of a logit moves a
softmax weight by a few 1e-6); two calls the same bits; the all-to-all's bytes (m - 1) cap d 4 B a
shard and direction.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import expert_parallel as jep  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import expert_parallel as tep  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.moe import _capacity, moe_ffn  # noqa: E402

E, K, B, S = 8, 2, 2, 64
MESHES = [(1, 1), (1, 2), (2, 4), (1, 8)]
ATOL = 1e-5


def _cfg(cf, pkg=tget):
    return dataclasses.replace(pkg("olmoe-1b-7b").reduced(), n_experts=E, top_k=K,
                               capacity_factor=cf)


def _inputs():
    """Router weights ~ N(0, 1/fan_in), the experts' gate and up 0.25 of
    that (outputs of order 1 from tokens of norm ~3 sqrt(d)), and tokens
    with a shared component along two experts' router columns (the skew
    that overflows slots)."""
    d, f = _cfg(1.25).d_model, _cfg(1.25).d_ff
    rng = np.random.default_rng(0)
    p = {"router": rng.normal(size=(d, E)) / np.sqrt(d),
         "w_gate": rng.normal(size=(E, d, f)) * 0.25 / np.sqrt(d),
         "w_up": rng.normal(size=(E, d, f)) * 0.25 / np.sqrt(d),
         "w_down": rng.normal(size=(E, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(B, S, d)) + 2.0 * (p["router"][:, 0] + p["router"][:, 1]) * np.sqrt(d)
    return p, x.astype(np.float32)


_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, "tests")
from test_torch_expert_parallel import E, K, MESHES, _cfg, _inputs
from repro.configs import get_config
from repro.launch.expert_parallel import _dispatch_to_buffers, moe_ffn_expert_parallel
from repro.models.moe import _capacity, route_topk

cfg = _cfg(1.25, get_config)
p, x = _inputs()
p, x = {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)
out = {}
for shape in MESHES:
    tag = "x".join(map(str, shape))
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with mesh:
        y, aux = jax.jit(lambda p_, x_: moe_ffn_expert_parallel(p_, x_, cfg, mesh))(p, x)
    out["y_" + tag], out["aux_" + tag] = np.asarray(y), np.asarray(aux)
    # each shard's send buffers, by the reference's own routing and dispatch
    n, m = shape[0] * shape[1], shape[1]
    xt = x.reshape(-1, x.shape[-1])
    t_dev = xt.shape[0] // n
    cap = _capacity(t_dev, m, K, cfg.capacity_factor)
    for j in range(n):
        xj = xt[j * t_dev:(j + 1) * t_dev]
        weights, idx, _ = route_topk(xj @ p["router"], K)
        token_of = jnp.repeat(jnp.arange(t_dev), K)
        _, meta = _dispatch_to_buffers(xj[token_of], idx.reshape(-1), weights.reshape(-1),
                                       jnp.ones(t_dev * K, bool), m, cap, E // m)
        out[f"meta_{tag}_{j}"] = np.asarray(meta)
np.savez(os.environ["EP_OUT"], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs on every mesh, from one 8-device subprocess."""
    import os
    import sys

    from conftest import run_multidevice_subprocess

    path = tmp_path_factory.mktemp("ep") / "reference.npz"
    code = f"import os\nos.environ['EP_OUT'] = {str(path)!r}\n" + _REFERENCE
    run_multidevice_subprocess(code, timeout=300)
    assert os.path.exists(path), sys.stderr
    return dict(np.load(path))


def _port(cf, shape, x=None):
    p, xs = _inputs()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    mesh = make_mesh(shape, ("data", "model"), torch.device("cpu"))
    return tep.moe_ffn_expert_parallel(tp, torch.from_numpy(xs if x is None else x), _cfg(cf),
                                       mesh)


def test_dispatch_to_buffers_equals_the_references():
    rng = np.random.default_rng(1)
    t_k, d, n_dst, cap, per = 96, 16, 4, 12, 2
    x = rng.normal(size=(t_k, d)).astype(np.float32)
    expert_of = rng.choice(8, size=t_k, p=[0.3, 0.2, 0.1, 0.1, 0.1, 0.1, 0.05, 0.05])
    w = rng.uniform(size=t_k).astype(np.float32)
    keep = rng.uniform(size=t_k) > 0.1
    jx, jm = jep._dispatch_to_buffers(jnp.asarray(x), jnp.asarray(expert_of), jnp.asarray(w),
                                      jnp.asarray(keep), n_dst, cap, per)
    tx, tm = tep._dispatch_to_buffers(torch.from_numpy(x), torch.from_numpy(expert_of),
                                      torch.from_numpy(w), torch.from_numpy(keep), n_dst, cap, per)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    kept = int(np.count_nonzero(np.asarray(jm)[..., 0]))
    assert 0 < kept < int(keep.sum())  # some kept assignments overflow their slots


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_no_drops_equal_the_ports_moe_ffn(shape):
    """Capacity factor 16: every assignment keeps its slot, and the output
    is ``moe_ffn``'s (the aux is the mean of the shards' own losses)."""
    p, x = _inputs()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want, _ = moe_ffn(tp, torch.from_numpy(x), _cfg(16.0))
    tep.reset_ep_counts()
    got, aux = _port(16.0, shape)
    counts = tep.ep_counts()
    assert counts["dropped"] == 0 and counts["kept"] == B * S * K
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=ATOL, atol=ATOL)
    assert aux.shape == () and np.isfinite(float(aux))


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_drops_against_the_reference(reference, shape):
    tag = "x".join(map(str, shape))
    tep.reset_ep_counts()
    got, aux = _port(1.25, shape)
    counts = tep.ep_counts()
    np.testing.assert_allclose(got.numpy(), reference["y_" + tag], rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(reference["aux_" + tag]), rtol=0, atol=1e-6)
    # the same kept slots: each shard's send buffers' metadata
    n, m = shape[0] * shape[1], shape[1]
    p, x = _inputs()
    cfg = _cfg(1.25)
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    t_dev = xt.shape[0] // n
    cap = _capacity(t_dev, m, K, cfg.capacity_factor)
    kept = 0
    for j in range(n):
        _, meta, _ = tep._route(xt[j * t_dev:(j + 1) * t_dev], torch.from_numpy(p["router"]),
                                cfg, m, E // m, cap)
        want = reference[f"meta_{tag}_{j}"]
        np.testing.assert_array_equal(meta[..., :2].numpy(), want[..., :2])
        np.testing.assert_allclose(meta[..., 2].numpy(), want[..., 2], rtol=0, atol=ATOL)
        kept += int(np.count_nonzero(want[..., 0]))
    assert counts["kept"] == kept and counts["dropped"] == B * S * K - kept
    if m > 1:
        assert counts["dropped"] > 0  # the skew overflows slots on every split mesh
        # each direction: (m - 1) blocks of cap x d f32 a shard
        assert counts["bytes"] == 2 * n * (m - 1) * cap * x.shape[-1] * 4
        assert counts["all_to_all"] == 3 * shape[0]


def test_two_calls_give_the_same_bits():
    a, aux_a = _port(1.25, (2, 4))
    b, aux_b = _port(1.25, (2, 4))
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_experts_must_divide_the_axis():
    with pytest.raises(ValueError, match="do not divide"):
        _port(1.25, (1, 3))
