"""The port's sharding rules and meshes (``repro_torch.launch.sharding``,
``launch.mesh``) against the JAX package's, in process: the rules only read
a mesh's shape, so the reference runs on ``jax.sharding.AbstractMesh``es
(no devices) and the port on abstract ``Mesh``es of the same shapes.

Held spec for spec: ``leaf_pspec`` through ``param_shardings`` over every
leaf of all 11 configs at full and ``reduced()`` size, with and without
the agent axis, and over a flat and a pytree ``BayesTrainState`` (the path
names cross the dataclass fields as the reference prints them);
``cache_pspec`` over ``make_agent_cache`` (kv, int8 scales, mLSTM, sLSTM,
RG-LRU); ``batch_pspec``; ``sharding_report``'s tuples; the mesh builders.
Inside the port: ``shard_blocks`` / ``join_blocks`` place and join the
blocks a spec gives each mesh position.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import steps as js  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path, tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.launch.dryrun import param_shapes  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

ARCHS = list_archs()
MESHES = {  # shape, axes
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
A = 2


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), tmesh.make_mesh(shape, axes)


def _cfg_pair(arch, size):
    if size == "full":
        return jget(arch), tget(arch)
    return jget(arch).reduced(), tget(arch).reduced()


def _jax_specs(tree, mesh, fn=jsh.leaf_pspec, **kw):
    return [(jsh._path_str(path), tuple(fn(path, leaf, mesh, **kw)))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_specs(tree, mesh, fn=tsh.leaf_pspec, **kw):
    return [(tsh._path_str(path), tuple(fn(path, leaf, mesh, **kw)))
            for path, leaf in tree_flatten_with_path(tree)]


_PARAMS = {}


def _param_trees(arch, size):
    """Both packages' parameter shapes, without and with the agent axis."""
    key = (arch, size)
    if key not in _PARAMS:
        jcfg, tcfg = _cfg_pair(arch, size)
        jp = jax.eval_shape(lambda: jinit(jcfg, jax.random.key(0)))
        jstacked = jax.tree.map(lambda x: jax.ShapeDtypeStruct((A,) + x.shape, x.dtype), jp)
        tp = param_shapes(tcfg)
        tstacked = tree_map(lambda x: x.expand((A,) + tuple(x.shape)), tp)
        _PARAMS[key] = (jp, jstacked, tp, tstacked)
    return _PARAMS[key]


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, size):
    jp, jstacked, tp, tstacked = _param_trees(arch, size)
    for name in MESHES:
        jm, tm = _meshes(name)
        want = _jax_specs(jp, jm)
        assert _port_specs(tp, tm) == want, name
        got = [tuple(s.spec) for s in tree_leaves(tsh.param_shardings(tp, tm))]
        assert got == [spec for _, spec in want]
        want_a = _jax_specs(jstacked, jm, agent_leading=True)
        assert _port_specs(tstacked, tm, agent_leading=True) == want_a, name
        got = tree_leaves(tsh.param_shardings(tstacked, tm, agent_leading=True))
        assert [tuple(s.spec) for s in got] == [spec for _, spec in want_a]
        assert all(s.mesh is tm for s in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_report_equals_the_references(arch):
    jp, jstacked, tp, tstacked = _param_trees(arch, "full")
    for name in MESHES:
        jm, tm = _meshes(name)
        assert tsh.sharding_report(tp, tm) == jsh.sharding_report(jp, jm)
        assert (tsh.sharding_report(tstacked, tm, agent_leading=True)
                == jsh.sharding_report(jstacked, jm, agent_leading=True))


def test_phi35_moe_report_on_the_production_mesh():
    """Phi-3.5-MoE's 41,874,100,224 parameters: 167.5 GB at f32, 0.654 GB
    a device on the (16, 16) mesh, no leaf replicated."""
    _, _, tp, _ = _param_trees("phi3.5-moe-42b-a6.6b", "full")
    n, total, per_dev, n_repl = tsh.sharding_report(tp, tmesh.make_production_mesh())
    assert (n, total, n_repl) == (41_874_100_224, 4 * 41_874_100_224, 0)
    assert per_dev == 654_360_576


@pytest.mark.parametrize("arch", ["repro-100m", "olmoe-1b-7b", "xlstm-1.3b", "whisper-tiny",
                                  "pixtral-12b"])
@pytest.mark.parametrize("flat", [True, False])
def test_train_state_specs_equal_the_references(arch, flat):
    """Over a whole ``BayesTrainState`` (posterior, Adam's moments, the 0-d
    step): the paths print the dataclass fields as ``.name``, so
    ``"moe" in name`` picks the same expert stacks."""
    jcfg, tcfg = _cfg_pair(arch, "reduced")
    jstate = jax.eval_shape(lambda k: js.init_train_state(k, jcfg, A, jadam(), flat=flat),
                            jax.random.key(0))
    tstate = ts.init_train_state(tcfg, A, adam(), flat=flat, device="meta")
    for name in ("2x16x16", "2x2x2", "1x1"):
        jm, tm = _meshes(name)
        want = _jax_specs(jstate, jm, agent_leading=True)
        assert _port_specs(tstate, tm, agent_leading=True) == want
        post = tsh.param_shardings(tstate, tm, agent_leading=True).posterior
        if flat:
            assert tuple(post.mean.spec) == (("pod", None) if "pod" in tm.shape else (None, None))
        else:
            assert isinstance(post.mean, dict) and isinstance(post.rho, dict)
    if not flat and arch == "olmoe-1b-7b":  # the expert stacks, E over "model"
        experts = [spec for n, spec in want if n.endswith("w_gate")]
        assert len(experts) == 6 and all(spec[-3] == "model" for spec in experts)


CACHE_CASES = [("qwen3-8b", jnp.bfloat16, torch.bfloat16), ("qwen3-8b", jnp.int8, torch.int8),
               ("xlstm-1.3b", jnp.bfloat16, torch.bfloat16),
               ("recurrentgemma-9b", jnp.bfloat16, torch.bfloat16),
               ("whisper-tiny", jnp.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("arch,jdt,tdt", CACHE_CASES, ids=lambda v: str(v))
def test_cache_specs_equal_the_references(arch, jdt, tdt):
    jcfg, tcfg = _cfg_pair(arch, "reduced")
    for b in (1, 4):
        jc = jax.eval_shape(lambda: js.make_agent_cache(jcfg, A, b, 32, dtype=jdt))
        tc = ts.make_agent_cache(tcfg, A, b, 32, dtype=tdt, device="meta")
        for name in MESHES:
            jm, tm = _meshes(name)
            want = _jax_specs(jc, jm, fn=jsh.cache_pspec)
            assert _port_specs(tc, tm, fn=tsh.cache_pspec) == want, (name, b)
            got = tree_leaves(tsh.cache_shardings(tc, tm))
            assert [tuple(s.spec) for s in got] == [spec for _, spec in want]
    leaf_names = {n.split("/")[-1] for n, _ in want}
    expect = {"qwen3-8b": {"k", "v", "pos"}, "xlstm-1.3b": {"C", "n", "m", "c", "h"},
              "recurrentgemma-9b": {"h", "conv", "k", "v"}, "whisper-tiny": {"k", "v"}}[arch]
    assert expect <= leaf_names
    if jdt == jnp.int8:
        assert {"k_scale", "v_scale"} <= leaf_names


@pytest.mark.parametrize("name", list(MESHES))
def test_batch_pspec_equals_the_references(name):
    jm, tm = _meshes(name)
    for shape in [(2, 128, 4096), (2, 1, 1), (1, 32, 8), (4, 16), (2, 3, 7, 5), (3,)]:
        for agent_leading in (True, False):
            want = tuple(jsh.batch_pspec(jm, shape, agent_leading=agent_leading))
            assert tuple(tsh.batch_pspec(tm, shape, agent_leading=agent_leading)) == want
    assert tuple(tsh.replicated(tm).spec) == tuple(jsh.replicated(jm).spec) == ()


def test_mesh_builders():
    for multi in (False, True):
        tm = tmesh.make_production_mesh(multi_pod=multi)
        shape, axes = MESHES["2x16x16" if multi else "16x16"]
        jm = AbstractMesh(shape, axes)
        assert tm.shape == dict(jm.shape) and list(tm.shape) == list(jm.shape)
        assert tm.devices is None and tm.n_cards == 0
        assert tmesh.mesh_n_agents(tm) == jmesh.mesh_n_agents(jm) == (2 if multi else 1)
        assert tmesh.mesh_n_chips(tm) == jmesh.mesh_n_chips(jm) == (512 if multi else 256)
    cpu = torch.device("cpu")
    m = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"), cpu)
    assert m.devices == (cpu,) * 8 and m.n_cards == 1 and m.size == 8
    assert [tuple(p.values()) for p in m.positions()][:3] == [(0, 0, 0), (0, 0, 1), (0, 1, 0)]
    devs = [torch.device("cpu", i) for i in range(4)]
    m = tmesh.make_mesh((2, 2), ("data", "model"), devs)
    assert m.device_at({"data": 1, "model": 0}) == devs[2]
    assert m.device_at({"model": 1}) == devs[1]
    assert tmesh.make_production_mesh(devices=[cpu] * 256).n_cards == 1
    with pytest.raises(ValueError, match="positions"):
        tmesh.make_mesh((2, 2), ("data", "model"), [cpu] * 3)
    with pytest.raises(ValueError, match="names must differ"):
        tmesh.make_mesh((2, 2), ("data", "data"))
    # the constants are the H100's, not the reference's v5e numbers
    assert tmesh.PEAK_FLOPS_BF16 != jmesh.PEAK_FLOPS_BF16 and tmesh.HBM_BW != jmesh.HBM_BW


@pytest.mark.parametrize("spec", [("pod", "data", "model"), ("pod", None, ("data", "model")),
                                  (None, "model"), ("pod",), ()], ids=str)
def test_blocks_place_and_join(spec):
    """Each position holds the block of each sharded dim that its axis
    indices give (row-major over a tuple entry's axes); replicated
    positions hold the same block; joining gives the tensor back."""
    mesh = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"), torch.device("cpu"))
    x = torch.arange(2 * 4 * 8, dtype=torch.float32).reshape(2, 4, 8)
    sh = tsh.NamedSharding(mesh, tsh.P(*spec))
    blocks = tsh.shard_blocks(x, sh)
    assert len(blocks) == 8
    for pos, blk in zip(mesh.positions(), blocks):
        want = x
        for dim, entry in enumerate(spec):
            axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            i, n = 0, 1
            for ax in axes:
                i, n = i * mesh.shape[ax] + pos[ax], n * mesh.shape[ax]
            size = x.shape[dim] // n
            want = want.narrow(dim, i * size, size)
        assert torch.equal(blk, want)
    assert torch.equal(tsh.join_blocks(blocks, sh), x)
    np.testing.assert_array_equal(tsh.join_blocks(blocks, sh).numpy(), x.numpy())


def test_a_spec_that_does_not_divide_is_refused():
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split"):
        tsh.shard_blocks(torch.zeros(3, 4), tsh.NamedSharding(mesh, tsh.P("data")))


def test_specs_are_tuples_with_the_references_entries():
    spec = tsh.P("pod", None, ("data", "model"))
    assert tuple(spec) == tuple(jax.sharding.PartitionSpec("pod", None, ("data", "model")))
    assert spec == ("pod", None, ("data", "model")) and "PartitionSpec" in repr(spec)
    mesh = tmesh.make_mesh((1,), ("data",))
    a, b = tsh.NamedSharding(mesh, spec), tsh.NamedSharding(mesh, list(spec))
    assert a == b and hash(a) == hash(b) and dataclasses.is_dataclass(a) is False
