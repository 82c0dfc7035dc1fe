"""The sharded LM steps (``repro_torch.launch.spmd_steps``) of the xLSTM's
``mlstm`` and ``slstm`` kinds under ``data`` x ``model`` > 1, against the
JAX package's unsharded steps on the CPU, on meshes of virtual CPU
positions, at ``reduced()`` size and float32.

* Prefill and decode of reduced xLSTM-1.3B (one ``mlstm`` and one
  ``slstm`` block, 4 heads) on (2, 2, 2) and (1, 2, 2) ``("pod", "data",
  "model")`` meshes, A = 2 agents of distinct weights, B = 4 rows of S =
  264 tokens (past the mLSTM's 256-token chunk, so the chunk carry is
  crossed): within ``F32_ATOL`` = 1e-4 of the reference's
  ``make_prefill_step`` / ``make_decode_step`` and ``PORT_ATOL`` = 1e-5 of
  the port's unsharded steps; the caches joined back (``C``, ``n``, ``m``,
  ``c``, ``h``) against the unsharded ones at 1e-5; each position's copy of
  the mLSTM's ``m`` (replicated over ``model``, computed on every model
  position; the cache placed with a block of its own on each position)
  bitwise equal over ``model``; the moved bytes equal to
  ``forward_gather_bytes`` and each position's gathers within its bound.
* Each layer alone (``spmd_steps.apply_layer``, the schedule's layer step)
  against the unsharded block on the same input, a 16-token prefill then
  a decode step, at ``PORT_ATOL``.
* The pytree train round on (2, 2, 2) against the reference's unsharded
  round under ``tests/test_distributed.py:130``'s rule (the loss within
  rtol 1e-4; per leaf of the posterior the largest difference at most
  2.5e-3 and the share beyond 1e-4 under 5e-3), from a posterior over the
  prefill's agents' weights (``init_train_state``'s, over weights of each
  agent's own) with agent 1's mean moved.
* The schedule refuses an xLSTM whose heads do not split over ``model``.
* ``models.xlstm.mlstm_scan`` over one 256-step chunk of fast-forgetting
  gates (the training chunk of the card's placed xLSTM round): its output
  within 1e-4 of the reference's, and its gradient finite (the decay is
  masked before its exp, where the reference's exp overflows above the
  diagonal and its gradient there is NaN).
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
from repro.core.posterior import init_posterior  # noqa: E402
from repro.data.pipeline import make_lm_batch_sampler as j_sampler  # noqa: E402
from repro.launch import steps as js  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map, tree_replace_leaves  # noqa: E402
from repro_torch.launch import spmd, spmd_steps  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import cache_shardings, param_shardings  # noqa: E402
from repro_torch.launch.spmd_steps import forward_gather_bytes  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from test_torch_pytree_steps import JGaussian, _tpost  # noqa: E402
from test_torch_pytree_steps import _carry as _carry_tree  # noqa: E402
from test_torch_spmd_kinds import _paths  # noqa: E402
from test_torch_spmd_steps import _move_agent1  # noqa: E402

A, B, S = 2, 4, 264
F32_ATOL = 1e-4
PORT_ATOL = 1e-5
AXES = ("pod", "data", "model")
CPU = torch.device("cpu")
ARCH = "xlstm-1.3b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (dataclasses.replace(jget(ARCH).reduced(), dtype="float32", **kw),
            dataclasses.replace(tget(ARCH).reduced(), dtype="float32", **kw))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _eps(key, jmean):
    """``test_torch_pytree_steps._eps``'s draws (agent a's leaf i from
    ``split(split(key, A)[a], n_leaves)[i]``) in one ``jit``: one compile,
    where a draw of each leaf alone compiles each leaf's shape."""
    leaves = jax.tree.leaves(jmean)

    @jax.jit
    def draw(key):
        return [[jax.random.normal(k, leaf.shape[1:], leaf.dtype)
                 for k, leaf in zip(jax.random.split(k_a, len(leaves)), leaves)]
                for k_a in jax.random.split(key, A)]

    stacked = [torch.from_numpy(np.stack([np.asarray(x) for x in xs])) for xs in zip(*draw(key))]
    return tree_replace_leaves(_tpost(JGaussian(mean=jmean, rho=jmean)).mean, stacked)


def _train_state(jp):
    """The reference's pytree ``BayesTrainState`` over the agents' stacked
    weights ``jp`` (``init_train_state``'s posterior, sigma 0.02, and Adam
    state, over weights of each agent's own), agent 1's mean moved."""
    def init(p):
        post = init_posterior(p, init_sigma=0.02)
        return js.BayesTrainState(posterior=post, opt_state=jadam().init(post),
                                  step=jnp.asarray(0, jnp.int32))

    return _move_agent1(jax.jit(init)(jp), False)


@functools.lru_cache(maxsize=None)
def _unsharded():
    """The reference's and the port's unsharded prefill and decode, once:
    (port params, tokens, reference logits, port logits, port cache,
    reference params)."""
    jcfg, tcfg = _cfgs()
    jp = jax.jit(jax.vmap(lambda k: jm.init_params(jcfg, k)))(
        jax.random.split(jax.random.key(0), A))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.array(jax.random.randint(jax.random.key(1), (A, B, S), 0, jcfg.vocab_size))
    jcache = js.make_agent_cache(jcfg, A, B, S + 2, jnp.float32)
    lj, jcache = jax.jit(js.make_prefill_step(jcfg))(jp, {"tokens": jnp.asarray(toks)}, jcache)
    dj, _ = jax.jit(js.make_decode_step(jcfg))(jp, jnp.asarray(toks[..., :1]), jnp.asarray(S),
                                               jcache)
    ucache = ts.make_agent_cache(tcfg, A, B, S + 2, torch.float32, device="cpu")
    tok = torch.from_numpy(toks)
    lu, ucache = ts.make_prefill_step(tcfg)(tp, {"tokens": tok}, ucache)
    du, ucache = ts.make_decode_step(tcfg)(tp, tok[..., :1], S, ucache)
    return tp, tok, (np.asarray(lj), np.asarray(dj)), (lu, du), ucache, jp


def _own_blocks(tree):
    """A placed tree whose every position holds a block of its own (a
    replicated block is a view of one source where ``device_put`` places it
    on the source's device, so its copies would be one tensor)."""
    return tree_map(lambda x: spmd.Placed(x.sharding, [b.clone() for b in x.blocks], x.shape,
                                          x.dtype), tree)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 2)], ids=str)
def test_sharded_prefill_and_decode_against_the_reference(shape):
    tcfg = _cfgs()[1]
    tp, tok, (lj, dj), (lu, du), ucache, _ = _unsharded()
    mesh = make_mesh(shape, AXES, CPU)
    assert spmd_steps.sharded_schedule(tcfg, mesh)
    params = spmd.device_put(tp, param_shardings(tp, mesh, agent_leading=True))
    cache = ts.make_agent_cache(tcfg, A, B, S + 2, torch.float32, device="cpu")
    cache = _own_blocks(spmd.device_put(cache, cache_shardings(cache, mesh)))
    moved = []
    spmd.reset_spmd_counts()
    lt, cache = ts.make_prefill_step(tcfg)(params, {"tokens": tok}, cache)
    moved.append(spmd.spmd_counts())
    spmd.reset_spmd_counts()
    dt, cache = ts.make_decode_step(tcfg)(params, tok[..., :1], S, cache)
    moved.append(spmd.spmd_counts())
    assert lt.shape == dt.shape == (A, B, 1, tcfg.padded_vocab)
    _close(lt, lj, F32_ATOL)
    _close(dt, dj, F32_ATOL)
    _close(lt, lu, PORT_ATOL)
    _close(dt, du, PORT_ATOL)

    joined = spmd.device_get(cache)
    names = [("/".join(map(str, path)), x, y) for (path, x), y in zip(
        _paths(joined), tree_leaves(ucache))]
    assert {n for n, _, _ in names} == {f"stacks/mlstm/{k}" for k in "Cnm"} | {
        f"stacks/slstm/{k}" for k in "cnhm"}
    for name, x, y in names:
        _close(x, y, PORT_ATOL)
    coords = spmd.position_coords(mesh)
    m_leaf = cache["stacks"]["mlstm"]["m"]
    for i, (p, d, m) in enumerate(coords):  # each model position's copy of m
        first = next(j for j, c in enumerate(coords) if c[:2] == (p, d))
        assert torch.equal(m_leaf.blocks[i], m_leaf.blocks[first]), (i, first)
    assert m_leaf.blocks[0].data_ptr() != m_leaf.blocks[1].data_ptr()

    for counts, seq in zip(moved, (S, 1)):
        want = forward_gather_bytes(tcfg, mesh, B, seq, 4, A)
        for kind in ("gather", "all_reduce", "all_gather"):
            assert counts[f"{kind}_bytes"] == want[kind], (kind, seq)
        per_pod = A // shape[0]  # agents a position computes for
        assert max(counts["gather_by_position"].values()) <= (
            per_pod * want["gather_per_position_max"])


def test_sharded_train_round_against_the_reference():
    jcfg, tcfg = _cfgs()
    W = complete_w(A)
    jstate = _train_state(_unsharded()[-1])
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
                    eps=_eps(key, jstate.posterior.mean))
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


def _layer_params(cfg, params):
    """(kind, its params' views ``[A, ...]``) of every layer in order: each
    period's pattern, each kind's stack at its own occurrence count, then
    the tail."""
    out = []
    for p in range(cfg.n_periods):
        seen: dict = {}
        for kind in cfg.pattern:
            o = seen.get(kind, 0)
            seen[kind] = o + 1
            out.append((kind, tree_map(lambda t: t[:, p, o], params["stacks"][kind])))
    return out + list(zip(cfg.tail, params.get("tail", [])))


def _hold_layers(cfg, tp, mesh, s, enc_out=None):
    """``spmd_steps.apply_layer`` at every layer against the unsharded
    block (``models.transformer.block_apply``) on the same seeded input
    ``[A, B, s + 1, D]``: a prefill of s positions into the layer's placed
    cache, then a decode step from it, each within ``PORT_ATOL``."""
    params = spmd.device_put(tp, param_shardings(tp, mesh, agent_leading=True))
    cache = ts.make_agent_cache(cfg, A, B, s + 2, torch.float32, device="cpu")
    cache = spmd.device_put(cache, cache_shardings(cache, mesh))
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(A, B, s + 1, cfg.d_model))
                         .astype(np.float32))
    pos = torch.arange(s + 1)
    for layer, (kind, lp) in enumerate(_layer_params(cfg, tp)):
        c_u = ttr.block_cache_init(kind, cfg, B, s + 2, torch.float32, "cpu", lead=(A,))
        for part in (slice(0, s), slice(s, s + 1)):
            want = ttr.block_apply(kind, lp, x[..., part, :], cfg, positions=pos[part],
                                   cache=c_u, enc_out=enc_out)[0]
            got = spmd_steps.apply_layer(cfg, params, cache, layer, x[..., part, :], pos[part],
                                         enc_out=enc_out)
            assert got.shape == want.shape, (layer, kind)
            _close(got, want, PORT_ATOL)
    return layer + 1


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 2)], ids=str)
def test_apply_layer_against_the_unsharded_block(shape):
    tcfg = _cfgs()[1]
    assert _hold_layers(tcfg, _unsharded()[0], make_mesh(shape, AXES, CPU), 16) == 2


@pytest.mark.parametrize("shape,change,what", [
    ((1, 1, 3), {}, "query heads"),
    ((1, 1, 4), {"d_model": 4, "head_dim": 1}, "mLSTM head columns")], ids=str)
def test_schedule_refuses_heads_that_do_not_split(shape, change, what):
    cfg = dataclasses.replace(_cfgs()[1], **change)
    with pytest.raises(ValueError, match=what):
        spmd_steps.sharded_schedule(cfg, make_mesh(shape, AXES, CPU))


def test_mlstm_chunk_gradient_stays_finite():
    rng = np.random.default_rng(5)
    b, s, h, hd = 1, 256, 2, 8
    q, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32) for _ in range(3))
    ig = rng.normal(size=(b, s, h)).astype(np.float32)
    fg = np.full((b, s, h), -5.0, np.float32)  # logsig(-5) ~ -5 a step: exp(b_j - b_l) overflows
    state = {"C": np.zeros((b, h, hd, hd), np.float32), "n": np.zeros((b, h, hd), np.float32),
             "m": np.full((b, h), -1e30, np.float32)}
    want, _ = jxl.mlstm_scan(*map(jnp.asarray, (q, k, v, ig, fg)),
                             {n: jnp.asarray(x) for n, x in state.items()})
    args = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, ig, fg)]
    got, _ = txl.mlstm_scan(*args, {n: torch.from_numpy(x) for n, x in state.items()})
    _close(got.detach(), np.asarray(want), F32_ATOL)
    got.sum().backward()
    assert all(bool(torch.isfinite(x.grad).all()) for x in args)
