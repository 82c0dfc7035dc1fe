"""The sharded LM steps (``repro_torch.launch.spmd_steps``) of the
encoder-decoder kinds ``enc_attn`` / ``dec_attn`` under ``data`` x
``model`` > 1, against the JAX package's unsharded steps on the CPU, on
meshes of virtual CPU positions, at ``reduced()`` size and float32.

* Prefill and decode of reduced Whisper-tiny (2 encoder layers over 16
  frames, 2 ``dec_attn`` layers, 4 heads) on (2, 2, 2) and (1, 2, 2)
  ``("pod", "data", "model")`` meshes, A = 2 agents of distinct weights,
  B = 4 rows of S = 8 tokens, frames ``[A, B, F, D]`` (normal x 0.1) placed
  by ``batch_pspec`` (B over ``data``), the encoder re-run in the decode
  step: within ``F32_ATOL`` = 1e-4 of the reference's ``make_prefill_step``
  / ``make_decode_step`` and ``PORT_ATOL`` = 1e-5 of the port's unsharded
  steps; the KV caches joined back against the unsharded ones at 1e-5
  (``pos`` equal); the moved bytes equal to ``forward_gather_bytes`` (the
  encoder's frames counted) and each position's gathers within its bound.
* Each ``dec_attn`` layer alone (``spmd_steps.apply_layer``) against the
  unsharded block on the same input and encoder output, at ``PORT_ATOL``.
* The pytree train round on (2, 2, 2), frames in the batch, against the
  reference's unsharded round under ``tests/test_distributed.py:130``'s
  rule (the loss within rtol 1e-4; per leaf of the posterior the largest
  difference at most 2.5e-3 and the share beyond 1e-4 under 5e-3), from a
  posterior over the prefill's agents' weights, agent 1's mean moved.
* The schedule refuses Whisper-tiny's 6 heads on a 4-way ``model`` axis.
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
from repro.launch import steps as js  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import spmd, spmd_steps  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import cache_shardings, param_shardings  # noqa: E402
from repro_torch.launch.spmd_steps import forward_gather_bytes  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from test_torch_pytree_steps import _carry as _carry_tree  # noqa: E402
from test_torch_spmd_kinds import _paths  # noqa: E402
from test_torch_spmd_xlstm import _eps, _hold_layers, _train_state  # noqa: E402

A, B, S = 2, 4, 8
F32_ATOL = 1e-4
PORT_ATOL = 1e-5
AXES = ("pod", "data", "model")
CPU = torch.device("cpu")
ARCH = "whisper-tiny"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (dataclasses.replace(jget(ARCH).reduced(), dtype="float32"),
            dataclasses.replace(tget(ARCH).reduced(), dtype="float32"))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _frames(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(A, rows, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _unsharded():
    """The reference's and the port's unsharded prefill and decode (the
    encoder re-run in the step), once: (port params, tokens, frames,
    reference logits, port logits, port cache, reference params)."""
    jcfg, tcfg = _cfgs()
    jp = jax.jit(jax.vmap(lambda k: jm.init_params(jcfg, k)))(
        jax.random.split(jax.random.key(0), A))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.array(jax.random.randint(jax.random.key(1), (A, B, S), 0, jcfg.vocab_size))
    frames = _frames(jcfg, B, 3)
    jcache = js.make_agent_cache(jcfg, A, B, S + 2, jnp.float32)
    lj, jcache = jax.jit(js.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, jcache)
    dj, _ = jax.jit(js.make_decode_step(jcfg))(jp, jnp.asarray(toks[..., :1]), jnp.asarray(S),
                                               jcache, jnp.asarray(frames))
    ucache = ts.make_agent_cache(tcfg, A, B, S + 2, torch.float32, device="cpu")
    tok, fr = torch.from_numpy(toks), torch.from_numpy(frames)
    lu, ucache = ts.make_prefill_step(tcfg)(tp, {"tokens": tok, "frames": fr}, ucache)
    du, ucache = ts.make_decode_step(tcfg)(tp, tok[..., :1], S, ucache, fr)
    return tp, tok, fr, (np.asarray(lj), np.asarray(dj)), (lu, du), ucache, jp


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 2)], ids=str)
def test_sharded_prefill_and_decode_against_the_reference(shape):
    tcfg = _cfgs()[1]
    tp, tok, fr, (lj, dj), (lu, du), ucache, _ = _unsharded()
    mesh = make_mesh(shape, AXES, CPU)
    assert spmd_steps.sharded_schedule(tcfg, mesh)
    params = spmd.device_put(tp, param_shardings(tp, mesh, agent_leading=True))
    cache = ts.make_agent_cache(tcfg, A, B, S + 2, torch.float32, device="cpu")
    cache = spmd.device_put(cache, cache_shardings(cache, mesh))
    moved = []
    spmd.reset_spmd_counts()
    lt, cache = ts.make_prefill_step(tcfg)(params, {"tokens": tok, "frames": fr}, cache)
    moved.append(spmd.spmd_counts())
    spmd.reset_spmd_counts()
    dt, cache = ts.make_decode_step(tcfg)(params, tok[..., :1], S, cache, fr)
    moved.append(spmd.spmd_counts())
    assert lt.shape == dt.shape == (A, B, 1, tcfg.padded_vocab)
    _close(lt, lj, F32_ATOL)
    _close(dt, dj, F32_ATOL)
    _close(lt, lu, PORT_ATOL)
    _close(dt, du, PORT_ATOL)
    joined = spmd.device_get(cache)
    names = [("/".join(map(str, path)), x, y) for (path, x), y in zip(
        _paths(joined), tree_leaves(ucache))]
    assert {n for n, _, _ in names} == {f"stacks/dec_attn/{k}" for k in ("k", "v", "pos")}
    for name, x, y in names:
        if name.endswith("pos"):
            assert torch.equal(x, y), name
        else:
            _close(x, y, PORT_ATOL)

    for counts, seq in zip(moved, (S, 1)):
        want = forward_gather_bytes(tcfg, mesh, B, seq, 4, A, frames=tcfg.encoder_seq)
        for kind in ("gather", "all_reduce", "all_gather"):
            assert counts[f"{kind}_bytes"] == want[kind], (kind, seq)
        per_pod = A // shape[0]  # agents a position computes for
        assert max(counts["gather_by_position"].values()) <= (
            per_pod * want["gather_per_position_max"])


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 2)], ids=str)
def test_apply_layer_against_the_unsharded_block(shape):
    """Each ``dec_attn`` layer alone, cross-attending the unsharded
    encoder's output of the frames."""
    tcfg = _cfgs()[1]
    tp, _, fr = _unsharded()[:3]
    enc_out = ttr.encode(tp, tcfg, fr)
    n = _hold_layers(tcfg, tp, make_mesh(shape, AXES, CPU), S, enc_out=enc_out)
    assert n == tcfg.n_layers


def test_sharded_train_round_against_the_reference():
    jcfg, tcfg = _cfgs()
    W = complete_w(A)
    jstate = _train_state(_unsharded()[-1])
    toks = np.random.default_rng(16).integers(0, jcfg.vocab_size, (A, B, 13))
    batch = {"tokens": toks[..., :-1], "targets": toks[..., 1:], "frames": _frames(jcfg, B, 17)}
    key = jax.random.key(2)
    jstep = jax.jit(js.make_train_round_step(jcfg, jnp.asarray(W, jnp.float32), opt=jadam(),
                                             remat=False, kl_scale=1e-5))
    j2, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    state = _carry_tree(jstate)
    mesh = make_mesh((2, 2, 2), AXES, CPU)
    placed = spmd.device_put(state, param_shardings(state, mesh, agent_leading=True))
    step = ts.make_train_round_step(tcfg, torch.as_tensor(W, dtype=torch.float32), opt=adam(),
                                    remat=False, kl_scale=1e-5)
    t2, tmet = step(placed, {k: torch.from_numpy(v.copy()) for k, v in batch.items()},
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


@pytest.mark.parametrize("shape,splits", [((1, 1, 4), False), ((2, 1, 2), True)], ids=str)
def test_whisper_heads_split_over_model(shape, splits):
    """Whisper-tiny's 6 heads split over a 2-way ``model`` axis and are
    refused over a 4-way one."""
    cfg = tget(ARCH)
    mesh = make_mesh(shape, AXES, CPU)
    if splits:
        assert spmd_steps.sharded_schedule(cfg, mesh)
    else:
        with pytest.raises(ValueError, match="6 query heads"):
            spmd_steps.sharded_schedule(cfg, mesh)
