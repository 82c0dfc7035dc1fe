"""The sharded LM steps (``repro_torch.launch.spmd_steps``, reached through
``launch.steps`` on placed inputs) against the JAX package's unsharded
steps on the CPU, in the settings of the reference's own sharded tests,
on a mesh of virtual CPU positions.

* Prefill and decode (``tests/test_distributed.py:171``'s setting: A = 2
  agents of distinct weights, B = 4 rows of S = 8 tokens, a float32 cache
  of S + 2 slots, S counting a VLM's patches) on a (2, 2, 2)
  ``("pod", "data", "model")`` mesh, params, cache and tokens placed by
  ``param_shardings(..., agent_leading=True)``, ``cache_shardings`` and
  ``batch_pspec``: reduced Qwen3-8B (qk-norm, 4 KV heads over 2 model
  positions), Granite-20B (one KV head, every position computing it) and
  Pixtral-12B (with patches), at float32.  Held against the reference's
  ``make_prefill_step`` / ``make_decode_step`` at ``F32_ATOL`` = 1e-4
  (``tests/test_torch_zoo_steps.py``) and against the port's unsharded
  steps at 1e-5 (fp32 sums split over the model axis), the cache after
  decode joined back against the unsharded one at 1e-5.
* The train round (``tests/test_distributed.py:130``'s setting: reduced
  repro-100m, A = 2 on ``complete_w(2)``, a batch of 4 rows of 32 tokens an
  agent, ``kl_scale`` 1e-5, ``remat=False``, the reference's draws through
  the ``eps`` seam), at float32 and with agent 1's mean moved by seeded
  noise so eq. (6) mixes agents that differ: a pytree state on (2, 2, 2)
  and a flat state on (2, 1, 1), each against the reference's unsharded
  round under that test's rule: the loss within rtol 1e-4, and per leaf of
  the posterior's mean and rho the largest difference at most 2.5e-3 and
  the share beyond 1e-4 under 5e-3 (Adam's sign flips on rounding-noise
  gradients, about lr each).
"""
import dataclasses

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
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import cache_shardings, param_shardings  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from test_torch_pytree_steps import _carry as _carry_tree  # noqa: E402
from test_torch_pytree_steps import _eps as _eps_tree  # noqa: E402
from test_torch_zoo_train import _carry as _carry_flat  # noqa: E402
from test_torch_zoo_train import _eps as _eps_flat  # noqa: E402

A, B, S = 2, 4, 8
F32_ATOL = 1e-4
PORT_ATOL = 1e-5
AXES = ("pod", "data", "model")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (dataclasses.replace(jget(arch).reduced(), dtype="float32"),
            dataclasses.replace(tget(arch).reduced(), dtype="float32"))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-20b", "pixtral-12b"])
def test_sharded_prefill_and_decode_against_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jax.vmap(lambda k: jm.init_params(jcfg, k))(jax.random.split(jax.random.key(0), A))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.array(jax.random.randint(jax.random.key(1), (A, B, S), 0, jcfg.vocab_size))
    n_p = jcfg.n_patches if jcfg.frontend == "vision_stub" else 0
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if n_p:
        patches = np.random.default_rng(3).normal(size=(A, B, n_p, jcfg.d_model)).astype(
            np.float32) * 0.1
        jbatch["patches"], tbatch["patches"] = jnp.asarray(patches), torch.from_numpy(patches)
    cap = S + n_p + 2
    jcache = js.make_agent_cache(jcfg, A, B, cap, jnp.float32)
    lj, jcache = js.make_prefill_step(jcfg)(jp, jbatch, jcache)
    dj, _ = js.make_decode_step(jcfg)(jp, jnp.asarray(toks[..., :1]), jnp.asarray(S + n_p), jcache)

    prefill, decode = ts.make_prefill_step(tcfg), ts.make_decode_step(tcfg)
    ucache = ts.make_agent_cache(tcfg, A, B, cap, torch.float32, device="cpu")
    lu, ucache = prefill(tp, tbatch, ucache)
    du, ucache = decode(tp, tbatch["tokens"][..., :1], S + n_p, ucache)

    mesh = make_mesh((2, 2, 2), AXES, CPU)
    params = spmd.device_put(tp, param_shardings(tp, mesh, agent_leading=True))
    cache = ts.make_agent_cache(tcfg, A, B, cap, torch.float32, device="cpu")
    cache = spmd.device_put(cache, cache_shardings(cache, mesh))
    lt, cache = prefill(params, tbatch, cache)
    dt, cache = decode(params, tbatch["tokens"][..., :1], S + n_p, cache)
    assert lt.shape == dt.shape == (A, B, 1, jcfg.padded_vocab)
    _close(lt, lj, F32_ATOL)
    _close(dt, dj, F32_ATOL)
    _close(lt, lu, PORT_ATOL)
    _close(dt, du, PORT_ATOL)
    joined = spmd.device_get(cache)
    assert torch.equal(joined["stacks"]["attn"]["pos"], ucache["stacks"]["attn"]["pos"])
    for name in ("k", "v"):
        _close(joined["stacks"]["attn"][name], ucache["stacks"]["attn"][name], PORT_ATOL)


def _move_agent1(jstate, flat):
    """Agent 1's mean moved by seeded noise (the port's training tests')."""
    rng = np.random.default_rng(7)

    def move(m):
        m = np.array(m)
        m[1] += 0.01 * rng.normal(size=m.shape[1:]).astype(np.float32)
        return jnp.asarray(m)

    mean = move(jstate.posterior.mean) if flat else jax.tree.map(move, jstate.posterior.mean)
    return dataclasses.replace(jstate, posterior=dataclasses.replace(jstate.posterior, mean=mean))


@pytest.mark.parametrize("flat,shape", [(False, (2, 2, 2)), (True, (2, 1, 1))],
                         ids=["pytree-2x2x2", "flat-2x1x1"])
def test_sharded_train_round_against_the_reference(flat, shape):
    jcfg, tcfg = _cfgs("repro-100m")
    W = complete_w(A)
    jstate = _move_agent1(js.init_train_state(jax.random.key(0), jcfg, A, jadam(), flat=flat),
                          flat)
    jb = j_sampler(jcfg.vocab_size, 4, 32, n_agents=A)(jax.random.key(1), 0)
    key = jax.random.key(2)
    jstep = jax.jit(js.make_train_round_step(jcfg, jnp.asarray(W, jnp.float32), opt=jadam(),
                                             remat=False, kl_scale=1e-5))
    j2, jmet = jstep(jstate, jb, key)

    if flat:
        state = _carry_flat(jstate, tcfg)
        eps = _eps_flat(key, state.posterior.mean.shape[1])
    else:
        state = _carry_tree(jstate)
        eps = _eps_tree(key, jstate.posterior.mean)
    mesh = make_mesh(shape, AXES, CPU)
    placed = spmd.device_put(state, param_shardings(state, mesh, agent_leading=True))
    step = ts.make_train_round_step(tcfg, torch.as_tensor(W, dtype=torch.float32), opt=adam(),
                                    remat=False, kl_scale=1e-5)
    t2, tmet = step(placed, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}, eps=eps)
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
