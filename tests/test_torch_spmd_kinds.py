"""The sharded LM steps (``repro_torch.launch.spmd_steps``) of the ``moe``,
``local_attn`` and ``rglru`` kinds and tied embeddings under ``data`` x
``model`` > 1, against the JAX package's unsharded steps on the CPU, on
meshes of virtual CPU positions, at ``reduced()`` size and float32.

* Prefill and decode of OLMoE-1B-7B, Phi-3.5-MoE and RecurrentGemma-9B
  (``rglru`` + ``local_attn`` with window 8 over a ring cache of 8 slots,
  one KV head computed by every position, tied embeddings) on (2, 2, 2) and
  (1, 2, 2) ``("pod", "data", "model")`` meshes, in
  ``tests/test_torch_spmd_steps.py``'s setting (A = 2 agents of distinct
  weights, B = 4 rows of S = 8 tokens, a cache of S + 2 slots): within
  ``F32_ATOL`` = 1e-4 of the reference's ``make_prefill_step`` /
  ``make_decode_step`` and ``PORT_ATOL`` = 1e-5 of the port's unsharded
  steps; the caches joined back (k / v / pos, h / conv) against the
  unsharded ones at 1e-5 (``pos`` equal).
* The ``moe`` drops: one OLMoE layer at capacity factor 0.5 on a (1, 2, 2)
  mesh, where the reference drops assignments and some of block 1's drop
  only because block 0 filled its experts first.  The placed layer drops
  exactly the unsharded dispatch's assignments (``moe_counts()`` against
  the count from the routing) and matches it and the reference's
  ``moe_ffn`` within 1e-5; the control, each data block dispatched alone
  at the agent's capacity (a per-block capacity, as
  ``launch/expert_parallel.py``'s per-shard one), must differ.
* The pytree train round of OLMoE (the router's aux in the loss) and of
  tied RecurrentGemma on (2, 2, 2), against the reference's unsharded
  round under ``tests/test_distributed.py:130``'s rule (the loss within
  rtol 1e-4; per leaf of the posterior the largest difference at most
  2.5e-3 and the share beyond 1e-4 under 5e-3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.graphs import complete_w  # noqa: E402
from repro.data.pipeline import make_lm_batch_sampler as j_sampler  # noqa: E402
from repro.launch import steps as js  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import spmd, spmd_steps  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import (  # noqa: E402
    NamedSharding,
    cache_shardings,
    param_shardings,
)
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.modules import rmsnorm  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from test_torch_pytree_steps import _carry as _carry_tree  # noqa: E402
from test_torch_pytree_steps import _eps as _eps_tree  # noqa: E402
from test_torch_spmd_steps import _move_agent1  # noqa: E402

A, B, S = 2, 4, 8
F32_ATOL = 1e-4
PORT_ATOL = 1e-5
AXES = ("pod", "data", "model")
CPU = torch.device("cpu")
ARCHS = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-9b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget(arch).reduced(), dtype="float32", **kw),
            dataclasses.replace(tget(arch).reduced(), dtype="float32", **kw))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@functools.lru_cache(maxsize=None)
def _unsharded(arch):
    """The reference's and the port's unsharded prefill and decode, once an
    arch: (port params, tokens, reference logits, port logits, port cache)."""
    jcfg, tcfg = _cfgs(arch)
    jp = jax.vmap(lambda k: jm.init_params(jcfg, k))(jax.random.split(jax.random.key(0), A))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.array(jax.random.randint(jax.random.key(1), (A, B, S), 0, jcfg.vocab_size))
    jcache = js.make_agent_cache(jcfg, A, B, S + 2, jnp.float32)
    lj, jcache = js.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)}, jcache)
    dj, _ = js.make_decode_step(jcfg)(jp, jnp.asarray(toks[..., :1]), jnp.asarray(S), jcache)
    ucache = ts.make_agent_cache(tcfg, A, B, S + 2, torch.float32, device="cpu")
    tok = torch.from_numpy(toks)
    lu, ucache = ts.make_prefill_step(tcfg)(tp, {"tokens": tok}, ucache)
    du, ucache = ts.make_decode_step(tcfg)(tp, tok[..., :1], S, ucache)
    return tp, tok, (np.asarray(lj), np.asarray(dj)), (lu, du), ucache


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 2)], ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_against_the_reference(arch, shape):
    tcfg = _cfgs(arch)[1]
    tp, tok, (lj, dj), (lu, du), ucache = _unsharded(arch)
    assert spmd_steps.sharded_schedule(tcfg, make_mesh(shape, AXES, CPU))
    mesh = make_mesh(shape, AXES, CPU)
    params = spmd.device_put(tp, param_shardings(tp, mesh, agent_leading=True))
    cache = ts.make_agent_cache(tcfg, A, B, S + 2, torch.float32, device="cpu")
    cache = spmd.device_put(cache, cache_shardings(cache, mesh))
    lt, cache = ts.make_prefill_step(tcfg)(params, {"tokens": tok}, cache)
    dt, cache = ts.make_decode_step(tcfg)(params, tok[..., :1], S, cache)
    assert lt.shape == dt.shape == (A, B, 1, tcfg.padded_vocab)
    _close(lt, lj, F32_ATOL)
    _close(dt, dj, F32_ATOL)
    _close(lt, lu, PORT_ATOL)
    _close(dt, du, PORT_ATOL)
    joined = spmd.device_get(cache)
    names = [("/".join(map(str, path)), x, y) for (path, x), y in zip(
        _paths(joined), tree_leaves(ucache))]
    assert {n.rsplit("/", 1)[-1] for n, _, _ in names} >= (
        {"h", "conv", "k", "v", "pos"} if "rglru" in tcfg.pattern else {"k", "v", "pos"})
    for name, x, y in names:
        if name.endswith("pos"):
            assert torch.equal(x, y), name
        else:
            _close(x, y, PORT_ATOL)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# the moe drops
# ---------------------------------------------------------------------------


def _slots(idx):
    """Each assignment's slot in its expert, token-major (``[T k]``)."""
    flat = idx.reshape(-1)
    running = torch.cumsum(torch.nn.functional.one_hot(flat, int(flat.max()) + 1), 0)
    return running.gather(1, flat[:, None])[:, 0] - 1


def test_moe_drops_follow_the_agents_capacity():
    jcfg, tcfg = _cfgs("olmoe-1b-7b", capacity_factor=0.5)
    t, e, k = B * S, tcfg.n_experts, tcfg.top_k
    cap = tmoe._capacity(t, e, k, tcfg.capacity_factor)
    g = torch.Generator().manual_seed(4)
    layer = {"norm2": {"scale": 1.0 + 0.1 * torch.randn(1, 1, 1, tcfg.d_model, generator=g)},
             "moe": tmoe.moe_init(g, tcfg, lead=(1, 1, 1))}
    x = torch.randn(1, B, S, tcfg.d_model, generator=g)
    h2 = rmsnorm(tree_map(lambda w: w[0, 0, 0], layer["norm2"]), x[0], tcfg.norm_eps)
    expert_p = tree_map(lambda w: w[0, 0, 0], layer["moe"])
    want, _ = tmoe.moe_ffn(expert_p, h2, tcfg)
    ref, _ = jmoe.moe_ffn(jax.tree.map(lambda w: jnp.asarray(w.numpy()), expert_p),
                          jnp.asarray(h2.numpy()), jcfg)
    _close(want, np.asarray(ref), PORT_ATOL)

    # the unsharded dispatch's drops, and those of block 1 that block 0 causes
    _, idx, _ = tmoe.route_topk(h2.reshape(t, -1) @ expert_p["router"], k)
    slot = _slots(idx)
    dropped = int((slot >= cap).sum())
    half = t * k // 2
    alone = _slots(idx[t // 2:])  # block 1 counted from zero
    assert dropped > 0 and int(((slot[half:] >= cap) & (alone < cap)).sum()) > 0

    mesh = make_mesh((1, 2, 2), AXES, CPU)
    placed = spmd.device_put(layer, param_shardings(layer, mesh, agent_leading=True))
    lp = tree_map(lambda leaf: leaf.agent(0), placed)
    tokens = spmd.place(x, NamedSharding(mesh, ("pod", "data")))
    grid = spmd_steps._Grid(tcfg, mesh)
    members = [(i, grid.coords[i][2]) for i in range(mesh.size)]
    xs = {i: b[0] for i, b in enumerate(tokens.blocks)}
    spmd_steps.reset_moe_counts()
    out = spmd_steps._moe(grid, lp, (0, 0), xs, members, t, 2, None)
    assert spmd_steps.moe_counts() == {"kept": t * k - dropped, "dropped": dropped}
    got = torch.cat([out[i] - xs[i] for i in (0, 2)])  # data blocks 0 and 1, model 0
    _close(got, want, PORT_ATOL)
    # control: each block dispatched alone at the agent's capacity
    per_block = dataclasses.replace(tcfg, capacity_factor=2 * tcfg.capacity_factor)
    assert tmoe._capacity(t // 2, e, k, per_block.capacity_factor) == cap
    control = torch.cat([tmoe.moe_ffn(expert_p, h2[r], per_block)[0] for r in (slice(0, B // 2),
                                                                          slice(B // 2, B))])
    assert float((control - want).abs().max()) > 100 * PORT_ATOL


# ---------------------------------------------------------------------------
# the train round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-9b"])
def test_sharded_train_round_against_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    W = complete_w(A)
    jstate = _move_agent1(js.init_train_state(jax.random.key(0), jcfg, A, jadam(), flat=False),
                          False)
    jb = j_sampler(jcfg.vocab_size, 4, 32, n_agents=A)(jax.random.key(1), 0)
    key = jax.random.key(2)
    jstep = jax.jit(js.make_train_round_step(jcfg, jnp.asarray(W, jnp.float32), opt=jadam(),
                                             remat=False, kl_scale=1e-5))
    j2, jmet = jstep(jstate, jb, key)

    state = _carry_tree(jstate)
    mesh = make_mesh((2, 2, 2), AXES, CPU)
    placed = spmd.device_put(state, param_shardings(state, mesh, agent_leading=True))
    step = ts.make_train_round_step(tcfg, torch.as_tensor(W, dtype=torch.float32), opt=adam(),
                                    remat=False, kl_scale=1e-5)
    t2, tmet = step(placed, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()},
                    eps=_eps_tree(key, jstate.posterior.mean))
    np.testing.assert_allclose(float(tmet["loss"]), float(jnp.mean(jmet["loss"])), rtol=1e-4)
    got = spmd.device_get(t2)
    want_leaves = [np.asarray(x) for x in jax.tree.leaves(j2.posterior.mean)
                   + jax.tree.leaves(j2.posterior.rho)]
    got_leaves = [x.numpy() for x in tree_leaves(got.posterior.mean)
                  + tree_leaves(got.posterior.rho)]
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        diff = np.abs(g - w)
        assert diff.max() <= 2.5e-3, diff.max()
        assert (diff > 1e-4).mean() < 5e-3, (diff > 1e-4).mean()


@pytest.mark.parametrize("arch,change,what", [
    ("olmoe-1b-7b", {"n_experts": 3}, "experts"),
    ("recurrentgemma-9b", {"d_model": 250}, "recurrence channels"),
    ("xlstm-1.3b", {"d_model": 4, "head_dim": 1}, "mLSTM head columns")])
def test_schedule_refuses_what_does_not_split(arch, change, what):
    cfg = dataclasses.replace(_cfgs(arch)[1], **change)
    mesh = make_mesh((1, 1, 4), AXES, CPU)
    with pytest.raises(ValueError, match=what):
        spmd_steps.sharded_schedule(cfg, mesh)
    assert not spmd_steps.sharded_schedule(cfg, make_mesh((2, 1, 1), AXES, CPU))
