"""The port's placed trees and collectives (``repro_torch.launch.spmd``) on a
mesh of virtual CPU positions, and what the sharded LM steps refuse
(``launch.spmd_steps``).

Held:
* ``device_put`` / ``device_get``: a parameter tree, a decode cache and a
  flat and a pytree ``BayesTrainState`` come back bit for bit on every mesh;
  a block on the source's device is a view of the source;
* each position's placed bytes equal ``sharding_report``'s per-device bytes
  of the reference (``repro.launch.sharding``, on an abstract mesh of the
  same shape) for all 11 configs at full size on the ``meta`` device;
* ``all_reduce`` / ``all_gather`` / ``reduce_scatter`` over each axis of a
  (2, 2, 2) mesh against their plain definitions, bit for bit (sums in axis
  order), twice the same bits, their gradients through autograd, and
  ``spmd_counts()``' bytes against their formulas (2 (k - 1) n, k (k - 1) n
  and (k - 1) n + (k - 1) n / k a group of k blocks of n bytes);
* ``gather`` / ``gather_rows`` against slicing and indexing the whole
  tensor, and their counted bytes;
* a placed state's train round runs the ppermute consensus, a bf16 and
  an f16 wire and a flat state under data x model, each within the
  reference's sharded-round rule of the unplaced round; a pod-only mesh runs
  OLMoE's ``reduced()`` prefill and decode equal to the unsharded ones (a
  plain cache placed on the way in, its blocks views written in place);
* no whole-model gather: a sharded prefill's and decode step's gathered,
  all-reduced and all-gathered bytes equal ``forward_gather_bytes``'
  formula in all (the ``attn`` configs, OLMoE's experts and RecurrentGemma's
  recurrent blocks and tied embedding), and each position's gathers stay at
  or under its per-position bound, a fraction of the model.
"""
import dataclasses

import jax
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.launch.dryrun import param_shapes  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import (  # noqa: E402
    NamedSharding,
    cache_shardings,
    param_shardings,
)
from repro_torch.launch.spmd_steps import forward_gather_bytes  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

CPU = torch.device("cpu")
AXES = ("pod", "data", "model")
SHAPES = [(2, 2, 2), (2, 1, 1), (1, 2, 4), (2, 4, 1)]
A = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return make_mesh(shape, AXES, CPU)


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _params(cfg, a=A):
    ps = [tm.init_params(cfg, torch.Generator().manual_seed(10 + i), device="cpu")
          for i in range(a)]
    return tree_map(lambda *xs: torch.stack(xs), *ps)


def _same(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_device_put_and_get_round_trip_bitwise(shape):
    cfg = _cfg("qwen3-8b")
    mesh = _mesh(shape)
    params = _params(cfg)
    placed = spmd.device_put(params, param_shardings(params, mesh, agent_leading=True))
    assert spmd.is_placed(placed) and not spmd.is_placed(params)
    assert _same(spmd.device_get(placed), params)
    wq = placed["stacks"]["attn"]["attn"]["wq"]
    base = params["stacks"]["attn"]["attn"]["wq"]
    for blk in wq.blocks:  # views of the source, none copied
        assert blk.untyped_storage().data_ptr() == base.untyped_storage().data_ptr()
    cache = ts.make_agent_cache(cfg, A, 4, 10, torch.float32, device="cpu")
    cache["stacks"]["attn"]["k"].normal_(generator=torch.Generator().manual_seed(1))
    placed_cache = spmd.device_put(cache, cache_shardings(cache, mesh))
    assert _same(spmd.device_get(placed_cache), cache)
    for flat in (True, False):
        state = ts.init_train_state(cfg, A, adam(), torch.Generator().manual_seed(0), flat=flat,
                                    device="cpu")
        placed_state = spmd.device_put(state, param_shardings(state, mesh, agent_leading=True))
        assert _same(spmd.device_get(placed_state), state)


@pytest.mark.parametrize("mesh_name", ["2x2x2", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs())
def test_placed_bytes_a_position_equal_the_references_report(arch, mesh_name):
    shape = {"2x2x2": (2, 2, 2), "2x16x16": (2, 16, 16)}[mesh_name]
    jp = jax.eval_shape(lambda: jinit(jget(arch), jax.random.key(0)))
    jstacked = jax.tree.map(lambda x: jax.ShapeDtypeStruct((A,) + x.shape, x.dtype), jp)
    _, _, per_device, _ = jsh.sharding_report(jstacked, AbstractMesh(shape, AXES),
                                              agent_leading=True)
    tstacked = tree_map(lambda x: x.expand((A,) + tuple(x.shape)), param_shapes(get_config(arch)))
    mesh = make_mesh(shape, AXES)  # abstract: every block stays on the meta device
    placed = spmd.device_put(tstacked, param_shardings(tstacked, mesh, agent_leading=True))
    got = {spmd.position_bytes(placed, i) for i in range(mesh.size)}
    assert got == {per_device}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _blocks(mesh, shape=(4, 6), seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {i: torch.randn(shape, generator=g).to(dtype) for i in range(mesh.size)}


def _groups(mesh, axis):
    coords = spmd.position_coords(mesh)
    k = AXES.index(axis)
    out = {}
    for i, c in enumerate(coords):
        out.setdefault(c[:k] + c[k + 1:], []).append(i)
    return list(out.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("axis", AXES)
def test_collectives_against_their_definitions_and_byte_formulas(axis, dtype):
    mesh = _mesh((2, 2, 2))
    blocks = _blocks(mesh, dtype=dtype)
    n = blocks[0].numel() * blocks[0].element_size()
    spmd.reset_spmd_counts()
    red = spmd.all_reduce(blocks, mesh, axis)
    gat = spmd.all_gather(blocks, mesh, axis, 1)
    rs = spmd.reduce_scatter(blocks, mesh, axis, 0)
    counts = spmd.spmd_counts()
    groups = _groups(mesh, axis)
    k = len(groups[0])
    for group in groups:
        acc = blocks[group[0]].float()
        for j in group[1:]:
            acc = acc + blocks[j].float()
        want = acc.to(dtype)
        for r, i in enumerate(group):
            assert torch.equal(red[i], want)
            assert torch.equal(gat[i], torch.cat([blocks[j] for j in group], 1))
            assert torch.equal(rs[i], want.chunk(k, 0)[r])
    assert counts["all_reduce_bytes"] == len(groups) * 2 * (k - 1) * n
    assert counts["all_gather_bytes"] == len(groups) * k * (k - 1) * n
    assert counts["reduce_scatter_bytes"] == len(groups) * ((k - 1) * n + (k - 1) * n // k)
    assert counts["bytes"] == sum(counts[f"{c}_bytes"] for c in spmd.KINDS)
    again = spmd.all_reduce(_blocks(mesh, dtype=dtype), mesh, axis)
    assert all(torch.equal(again[i], red[i]) for i in red)


def test_collectives_are_differentiable():
    mesh = _mesh((2, 2, 2))
    leaves = {i: b.requires_grad_(True) for i, b in _blocks(mesh, seed=3).items()}
    weights = _blocks(mesh, shape=(4, 12), seed=4)
    with torch.enable_grad():
        gat = spmd.all_gather(leaves, mesh, "model", 1)
        red = spmd.all_reduce({i: (gat[i] * weights[i]).sum(1) for i in gat}, mesh, "data")
        loss = sum(red[i].sum() * (i + 1) for i in red)
        got = torch.autograd.grad(loss, [leaves[i] for i in range(mesh.size)])
    coords = spmd.position_coords(mesh)
    for i, g in enumerate(got):  # d loss / d leaf_i, by hand
        p, d, m = coords[i]
        want = torch.zeros_like(g)
        # every position j of i's (pod, data) group gathers leaf i into columns [6m, 6m+6);
        # j's product is summed over data into every member q of its (pod, model) group
        for j, (pj, dj, mj) in enumerate(coords):
            if pj == p and dj == d:
                scale = sum(q + 1 for q, (pq, dq, mq) in enumerate(coords)
                            if pq == pj and mq == mj)
                want = want + weights[j][:, 6 * m:6 * m + 6] * scale
        torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6)


def test_gather_and_gather_rows_against_slicing():
    mesh = _mesh((2, 2, 2))
    x = torch.randn(2, 3, 8, 12, generator=torch.Generator().manual_seed(0))
    leaf = spmd.place(x, NamedSharding(mesh, ("pod", None, "data", "model")))
    a1 = leaf.agent(1)
    assert torch.equal(a1.get(), x[1])  # the agent's pod alone holds its blocks
    for i, blk in enumerate(a1.blocks):
        if blk is None:
            continue
        spmd.reset_spmd_counts()
        got = spmd.gather(a1, i, ((1, 2), (0, 8), (6, 12)))
        assert torch.equal(got, x[1, 1:2, :, 6:12])
        own_cols = spmd.position_coords(mesh)[i][2] == 1
        assert spmd.spmd_counts()["gather_bytes"] == (4 if own_cols else 8) * 6 * 4
        spmd.reset_spmd_counts()
        assert torch.equal(spmd.gather(a1, i), x[1])
        assert spmd.spmd_counts()["gather_bytes"] == (3 * 8 * 12 - 3 * 4 * 6) * 4
    emb = torch.randn(2, 16, 6, generator=torch.Generator().manual_seed(1))
    table = spmd.place(emb, NamedSharding(mesh, ("pod", "data", "model"))).agent(0)
    tokens = torch.tensor([[0, 15, 7], [8, 3, 9]])
    spmd.reset_spmd_counts()
    assert torch.equal(spmd.gather_rows(table, 0, tokens), emb[0][tokens])
    assert spmd.spmd_counts()["gather_bytes"] == 3 * 6 * 3 * 4  # 3 of 4 pieces, 6 x 3 each


# ---------------------------------------------------------------------------
# the sharded steps' refusals, pod-only meshes and gathered bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["flat_state", "wire_f16", "ppermute", "wire_bf16"])
def test_other_kinds_are_refused_under_data_or_model(case):
    """Every block kind runs under data x model, and so does every route of
    a placed state's train round: a flat state (its spec replicates it over
    data x model), the ppermute consensus and a bf16 / f16 wire, each
    within ``tests/test_distributed.py:130``'s rule of the same step on the
    unplaced state (the loss within rtol 1e-4; the posterior at most 2.5e-3
    apart, under 0.5% of the lanes beyond 1e-4), its rows or leaves finite."""
    W = torch.full((A, A), 0.5)
    cfg = _cfg("repro-100m" if case == "flat_state" else "olmoe-1b-7b")
    g = torch.Generator().manual_seed(0)
    state = ts.init_train_state(cfg, A, adam(), g, flat=case == "flat_state", device="cpu")
    mesh = _mesh((2, 2, 2))
    shardings = param_shardings(state, mesh, agent_leading=True)
    placed = spmd.device_put(state, shardings)
    kw = {"ppermute": {"consensus_impl": "ppermute", "mesh": mesh,
                       "posterior_shardings": shardings.posterior},
          "wire_bf16": {"consensus_wire_dtype": torch.bfloat16},
          "wire_f16": {"consensus_wire_dtype": torch.float16}}.get(case, {})
    step = ts.make_train_round_step(cfg, W, opt=adam(), remat=False, **kw)
    batch = {k: torch.randint(0, cfg.vocab_size, (A, 2, 4), generator=g)
             for k in ("tokens", "targets")}
    eps = tree_map(lambda m: torch.randn(m.shape, generator=g), state.posterior.mean)
    got, got_m = step(placed, batch, eps=eps)
    want, want_m = step(state, batch, eps=eps)
    torch.testing.assert_close(got_m["loss"], want_m["loss"], rtol=1e-4, atol=0)
    got = spmd.device_get(got)
    for x, y in zip(tree_leaves(got.posterior), tree_leaves(want.posterior)):
        assert x.shape == y.shape and bool(torch.isfinite(x).all())
        d = (x - y).abs()
        assert float(d.max()) <= 2.5e-3 and float((d > 1e-4).float().mean()) < 5e-3


def test_pod_only_mesh_runs_the_moe_prefill_and_decode():
    cfg = _cfg("olmoe-1b-7b")
    params = _params(cfg)
    toks = torch.randint(0, cfg.vocab_size, (A, 2, 8), generator=torch.Generator().manual_seed(1))
    prefill, decode = ts.make_prefill_step(cfg), ts.make_decode_step(cfg)
    cache = ts.make_agent_cache(cfg, A, 2, 10, torch.float32, device="cpu")
    want, cache = prefill(params, {"tokens": toks}, cache)
    want_d, _ = decode(params, toks[..., :1], 8, cache)
    mesh = _mesh((2, 1, 1))
    placed = spmd.device_put(params, param_shardings(params, mesh, agent_leading=True))
    pcache = ts.make_agent_cache(cfg, A, 2, 10, torch.float32, device="cpu")
    pcache = spmd.device_put(pcache, cache_shardings(pcache, mesh))
    got, pcache = prefill(placed, {"tokens": toks}, pcache)
    got_d, _ = decode(placed, toks[..., :1], 8, pcache)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(got_d, want_d, atol=1e-5, rtol=0)
    plain = ts.make_agent_cache(cfg, A, 2, 10, torch.float32, device="cpu")
    again, _ = prefill(placed, {"tokens": toks}, plain)  # placed on the way in, as views
    written = spmd.device_get(pcache)["stacks"]["moe"]["k"][..., :8, :, :]
    assert torch.equal(again, got) and torch.equal(plain["stacks"]["moe"]["k"][..., :8, :, :],
                                                   written)


@pytest.mark.parametrize("arch,shape", [("qwen3-8b", (2, 2, 2)), ("granite-20b", (2, 2, 2)),
                                        ("pixtral-12b", (1, 2, 2)), ("qwen3-8b", (1, 1, 4)),
                                        ("olmoe-1b-7b", (2, 2, 2)),
                                        ("recurrentgemma-9b", (2, 2, 2))],
                         ids=str)
def test_gathered_bytes_stay_at_the_formula(arch, shape):
    cfg = _cfg(arch)
    a = shape[0]
    mesh = _mesh(shape)
    params = spmd.device_put(_params(cfg, a), param_shardings(_params(cfg, a), mesh,
                                                              agent_leading=True))
    b, s = 4, 8
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (a, b, s))}
    n_p = cfg.n_patches if cfg.frontend == "vision_stub" else 0
    if n_p:
        batch["patches"] = torch.randn(a, b, n_p, cfg.d_model)
    cache = ts.make_agent_cache(cfg, a, b, s + n_p + 2, torch.float32, device="cpu")
    cache = spmd.device_put(cache, cache_shardings(cache, mesh))
    model_bytes = sum(x.numel() * 4 for x in tree_leaves(_params(cfg, 1)))
    for name, call, seq in (
            ("prefill", lambda: ts.make_prefill_step(cfg)(params, batch, cache), s),
            ("decode", lambda: ts.make_decode_step(cfg)(params, batch["tokens"][..., :1], s + n_p,
                                                        cache), 1)):
        spmd.reset_spmd_counts()
        call()
        counts = spmd.spmd_counts()
        want = forward_gather_bytes(cfg, mesh, b, seq, 4, a, n_p if name == "prefill" else 0)
        assert counts["gather_bytes"] == want["gather"], name
        assert counts["all_reduce_bytes"] == want["all_reduce"], name
        assert counts["all_gather_bytes"] == want["all_gather"], name
        most = max(counts["gather_by_position"].values())
        assert most <= want["gather_per_position_max"] < model_bytes, name
