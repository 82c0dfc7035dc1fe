"""The port's leaf-wise pod consensus (``repro_torch.launch.consensus_opt
.consensus_ppermute_pod``) against the JAX package's, and inside the port
against the flat ring.

The reference's runs under ``shard_map`` on a ``("pod", "data", "model")``
mesh of 8 virtual XLA devices (``Auto`` axes), once for this file in a
subprocess (``conftest.run_multidevice_subprocess``) that writes its
outputs to an ``.npz``; the port runs on virtual shards of the CPU
(``launch.mesh.Mesh`` over ``[cpu] * n``) with the shardings of
``launch.sharding.param_shardings``, so each leaf splits over the data and
model axes as well as the pod axis.  Inputs: a three-leaf parameter dict
from a numpy seed, at A = 2, 3 and 4 agents (meshes (2, 2, 2), (3, 2, 1),
(4, 2, 1)), W a ring (A = 2: two different rows).

Held: within 1e-5 of the reference's at wire f32, bf16 and f16, except,
at bf16 and f16, the lanes where a statistic sits within an f32 rounding
of a wire rounding boundary, so that one package rounds it the other way
(at most 0.1% of the lanes, each within one wire place of its value plus
1: the wire's error bound, ``core.numerics.wire_error_bound``); bitwise
``consensus_ppermute_ring_flat`` on the same posterior flattened, same W
and wire (every contiguous run of a block here is a multiple of 32 lanes,
so PyTorch's CPU kernels take their vector path on every lane of both
forms: a run's last lanes otherwise take a scalar path with other bits; on
the card,
where every lane takes one path, tests/test_torch_sharding_cuda.py holds it
at ragged sizes); at f32 within 1e-5 of ``consensus_all_agents``; the
rotated bytes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.flat import flat_posterior_from_pytree  # noqa: E402
from repro_torch.core.posterior import GaussianPosterior, consensus_all_agents  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import consensus_opt as co  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import param_shardings  # noqa: E402

MESHES = {2: (2, 2, 2), 3: (3, 2, 1), 4: (4, 2, 1)}
WIRES = ("f32", "bf16", "f16")
TOL = 1e-5
WIRE_PLACE = {"bf16": 2.0 ** -8, "f16": 2.0 ** -11}
FLIP_SHARE = 1e-3
SHAPES = {"a": (8, 128), "b": {"c": (64,), "w": (4, 8, 64)}}


def _w(a):
    if a == 2:
        return np.array([[0.6, 0.4], [0.25, 0.75]], np.float32)
    w = np.zeros((a, a), np.float32)
    for i in range(a):
        w[i, i], w[i, (i - 1) % a], w[i, (i + 1) % a] = 0.5, 0.3, 0.2
    return w


def _posts(a, seed=0):
    """(mean, rho) dicts of numpy leaves ``[A, ...]``."""
    rng = np.random.default_rng(seed + a)

    def make(shapes, fn):
        return {k: make(v, fn) if isinstance(v, dict) else fn((a,) + v).astype(np.float32)
                for k, v in shapes.items()}

    return (make(SHAPES, lambda s: rng.normal(size=s)),
            make(SHAPES, lambda s: rng.uniform(-4.0, -2.0, size=s)))


_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, "tests")
from test_torch_pod_consensus import MESHES, WIRES, _posts, _w
from repro.core.posterior import GaussianPosterior, consensus_all_agents
from repro.launch.consensus_opt import consensus_ppermute_pod
from repro.launch.sharding import param_shardings

out = {}
for a, shape in MESHES.items():
    mean, rho = _posts(a)
    post = GaussianPosterior(mean=jax.tree.map(jnp.asarray, mean),
                             rho=jax.tree.map(jnp.asarray, rho))
    W = jnp.asarray(_w(a))
    mesh = jax.make_mesh(shape, ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    sh = param_shardings(jax.eval_shape(lambda: post), mesh, agent_leading=True)
    for wire in WIRES:
        wd = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}[wire]
        with mesh:
            got = jax.jit(lambda q: consensus_ppermute_pod(q, W, mesh, sh, wire_dtype=wd))(post)
        for i, (m, r) in enumerate(zip(jax.tree.leaves(got.mean), jax.tree.leaves(got.rho))):
            out[f"{a}_{wire}_{i}_mean"], out[f"{a}_{wire}_{i}_rho"] = np.asarray(m), np.asarray(r)
    dense = consensus_all_agents(post, W)
    for i, (m, r) in enumerate(zip(jax.tree.leaves(dense.mean), jax.tree.leaves(dense.rho))):
        out[f"{a}_dense_{i}_mean"], out[f"{a}_dense_{i}_rho"] = np.asarray(m), np.asarray(r)
np.savez(os.environ["POD_OUT"], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    from conftest import run_multidevice_subprocess

    path = tmp_path_factory.mktemp("pod") / "reference.npz"
    run_multidevice_subprocess(f"import os\nos.environ['POD_OUT'] = {str(path)!r}\n" + _REFERENCE,
                               timeout=300)
    return dict(np.load(path))


def _tposts(a):
    mean, rho = _posts(a)

    def t(tree):
        return {k: t(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}

    return GaussianPosterior(mean=t(mean), rho=t(rho))


def _mesh(a):
    shape = MESHES[a]
    return make_mesh(shape, ("pod", "data", "model"), torch.device("cpu"))


def _pod(a, wire):
    post, mesh = _tposts(a), _mesh(a)
    sh = param_shardings(post, mesh, agent_leading=True)
    return co.consensus_ppermute_pod(post, torch.from_numpy(_w(a)), mesh, sh, wire_dtype=wire)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("a", list(MESHES))
def test_against_the_reference(reference, a, wire):
    got = _pod(a, {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[wire])
    beyond, lanes = 0, 0
    for i, (m, r) in enumerate(zip(tree_leaves(got.mean), tree_leaves(got.rho))):
        for name, x in (("mean", m), ("rho", r)):
            want = reference[f"{a}_{wire}_{i}_{name}"]
            err = np.abs(x.numpy() - want)
            far = err > TOL + TOL * np.abs(want)
            if wire == "f32":
                assert not far.any(), (name, i, err.max())
            else:
                assert np.all(err <= TOL + WIRE_PLACE[wire] * (np.abs(want) + 1.0)), (name, i)
            beyond, lanes = beyond + int(far.sum()), lanes + far.size
    assert beyond <= FLIP_SHARE * lanes, (beyond, lanes)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("a", list(MESHES))
def test_bitwise_the_flat_ring(a, wire):
    wd = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[wire]
    post, mesh = _tposts(a), _mesh(a)
    W = torch.from_numpy(_w(a))
    co.reset_rotation_counts()
    got = flat_posterior_from_pytree(_pod(a, wd), leading_axes=1)
    moved = co.rotation_counts()
    ring = co.consensus_ppermute_ring_flat(flat_posterior_from_pytree(post, leading_axes=1), mesh,
                                           "pod", wire_dtype=wd, W=W)
    assert torch.equal(got.mean, ring.mean) and torch.equal(got.rho, ring.rho)
    # the control: W with its rows in another order is not the same consensus
    wrong = co.consensus_ppermute_ring_flat(flat_posterior_from_pytree(post, leading_axes=1), mesh,
                                            "pod", wire_dtype=wd, W=W.flip(0))
    assert not torch.equal(got.mean, wrong.mean)
    # every position's (prec, prec*mu) block, once a direction: 2 planes x A x P
    # elements a direction, less what a leaf's blocks repeat over the replicated axes
    n_params = sum(x[0].numel() for x in tree_leaves(post.mean))
    directions = 2 if a > 2 else 1
    replicated = MESHES[a][1] * MESHES[a][2]  # "c" is replicated over data and model
    c_extra = (replicated - 1) * 64
    size = torch.tensor([], dtype=wd).element_size()
    assert moved["bytes"] == directions * 2 * a * (n_params + c_extra) * size
    assert moved["rotations"] == directions * len(tree_leaves(post.mean))


@pytest.mark.parametrize("a", list(MESHES))
def test_f32_equals_the_dense_consensus(reference, a):
    got = _pod(a, torch.float32)
    dense = consensus_all_agents(_tposts(a), torch.from_numpy(_w(a)))
    for i, (g, d, m) in enumerate(zip(tree_leaves(got.mean), tree_leaves(dense.mean),
                                      tree_leaves(got.rho))):
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g.numpy(), reference[f"{a}_dense_{i}_mean"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(m.numpy(), reference[f"{a}_dense_{i}_rho"], rtol=TOL, atol=TOL)


def test_a_bare_spec_tree_serves_as_the_shardings():
    """The reference also takes ``PartitionSpec`` leaves for the shardings."""
    post, mesh = _tposts(2), _mesh(2)
    sh = param_shardings(post, mesh, agent_leading=True)
    specs = GaussianPosterior(mean={"a": sh.mean["a"].spec,
                                    "b": {k: v.spec for k, v in sh.mean["b"].items()}}, rho=None)
    a = co.consensus_ppermute_pod(post, torch.from_numpy(_w(2)), mesh, sh)
    b = co.consensus_ppermute_pod(post, torch.from_numpy(_w(2)), mesh, specs)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
