"""LM training on a pytree posterior (``init_train_state(flat=False)``: a
``GaussianPosterior`` over the agent-stacked parameter dict) against the
JAX package on the CPU, at ``reduced()`` sizes in float32, in the setting
of tests/test_torch_zoo_train.py (A = 2 agents on W = [[.75, .25], [.25,
.75]], B = 2 rows of S = 16 tokens, the reference's state carried across
with agent 1's mean moved by seeded noise, and its hold rule).

The reference draws each leaf's noise from its own key
(``GaussianPosterior.sample``: ``split(key_a, n_leaves)``); the port takes
those draws through its ``eps`` seam as a dict shaped like the mean.

Held, each within the round-step tests' 1e-4 rule (``_hold_state``; the
loss, nll and KL at 1e-4):
* the round step against the reference's single-device step, with the
  einsum consensus and with the bf16 wire, for repro-100m and OLMoE (the
  enc-dec and VLM configs in tests/test_torch_pytree_steps_encdec.py);
* ``launch.train``'s u = 2 local steps against a stored prior;
* the ``nll_fn`` form of ``make_local_step`` (the launch engine's) on a
  two-layer MLP with 2 MC samples;
* the ``ppermute`` route: the reference's ``consensus_ppermute_pod`` inside
  its round step on a (2, 2, 2) ``("pod", "data", "model")`` mesh of 8
  virtual XLA devices (``Auto`` axes), once in a subprocess
  (``conftest.run_multidevice_subprocess``), against the port's on a
  ``launch.mesh.Mesh`` of virtual CPU shards;
* inside the port, the pytree round against the flat round from the same
  state and draws, on every route.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.posterior import GaussianPosterior as JGaussian  # noqa: E402
from repro.launch import steps as js  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.core.flat import flat_posterior_from_pytree  # noqa: E402
from repro_torch.core.posterior import GaussianPosterior, posterior_from_numpy  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map, tree_replace_leaves  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import param_shardings  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.optim.optimizers import AdamState  # noqa: E402
from test_torch_zoo_train import A, W, _batch, _cfgs, _close, _hold_state, _noise  # noqa: E402

ROUTES = {
    "einsum": ({}, {}),
    "wire_bf16": ({"consensus_wire_dtype": jnp.bfloat16},
                  {"consensus_wire_dtype": torch.bfloat16}),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree_state(jcfg):
    """The reference's pytree state, agent 1's mean moved by seeded noise."""
    st = js.init_train_state(jax.random.key(0), jcfg, A, jadam(), flat=False)
    rng = np.random.default_rng(7)

    def move(m):
        m = np.array(m)
        m[1] += 0.01 * rng.normal(size=m.shape[1:]).astype(np.float32)
        return jnp.asarray(m)

    post = JGaussian(mean=jax.tree.map(move, st.posterior.mean), rho=st.posterior.rho)
    return dataclasses.replace(st, posterior=post)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _tpost(jpost):
    return posterior_from_numpy(_numpy(jpost.mean), _numpy(jpost.rho), device="cpu")


def _carry(jstate):
    """A JAX pytree ``BayesTrainState`` as the port's, leaf for leaf."""
    opt = jstate.opt_state
    return ts.BayesTrainState(
        posterior=_tpost(jstate.posterior),
        opt_state=AdamState(mu=_tpost(opt.mu), nu=_tpost(opt.nu)),
        step=torch.tensor(int(jstate.step), dtype=torch.int32))


def _eps(key, jmean, n_samples=None):
    """The reference's draws of one step as the port's noise dict: agent a's
    leaf i from ``split(split(key, A)[a], n_leaves)[i]`` (with
    ``n_samples``, first ``split(key_a, n_samples)[s]``: ``free_energy``)."""
    leaves, treedef = jax.tree.flatten(jmean)

    def agent(k):
        ks = jax.random.split(k, len(leaves))
        return [np.asarray(jax.random.normal(kk, leaf.shape[1:], leaf.dtype))
                for kk, leaf in zip(ks, leaves)]

    per_agent = []
    for k_a in jax.random.split(key, A):
        if n_samples is None:
            per_agent.append(agent(k_a))
        else:
            per_s = [agent(k_s) for k_s in jax.random.split(k_a, n_samples)]
            per_agent.append([np.stack(xs) for xs in zip(*per_s)])
    stacked = [torch.from_numpy(np.stack(xs)) for xs in zip(*per_agent)]
    return tree_replace_leaves(_tpost(JGaussian(mean=jmean, rho=jmean)).mean, stacked)


def _flat_view(state):
    """A pytree state's posterior and Adam moments as flat ``[A, P]``
    tensors (leaves in sorted-key order), for ``_hold_state``."""
    def f(tree):
        return torch.cat([torch.as_tensor(np.asarray(x)).reshape(A, -1)
                          for x in (tree_leaves(tree) if isinstance(tree, dict)
                                    else jax.tree.leaves(tree))], dim=1)

    def post(p):
        return SimpleNamespace(mean=f(p.mean), rho=f(p.rho))

    return SimpleNamespace(posterior=post(state.posterior),
                           opt_state=SimpleNamespace(mu=post(state.opt_state.mu),
                                                     nu=post(state.opt_state.nu)),
                           step=state.step)


def _round_case(arch, route, batch_fn=None):
    """One round step in each package from the same pytree state, tokens
    and draws."""
    jcfg, tcfg = _cfgs(arch)
    jstate = _jax_tree_state(jcfg)
    jb, tb = _batch(jcfg, 1) if batch_fn is None else batch_fn(jcfg)
    key = jax.random.key(2)
    jkw, tkw = ROUTES[route]
    jstep = jax.jit(js.make_train_round_step(jcfg, jnp.asarray(W, jnp.float32), opt=jadam(),
                                             remat=False, **jkw))
    j2, jm = jstep(jstate, jb, key)
    tstep = ts.make_train_round_step(tcfg, torch.as_tensor(W, dtype=torch.float32), opt=adam(),
                                     remat=False, **tkw)
    t2, tm = tstep(_carry(jstate), tb, eps=_eps(key, jstate.posterior.mean))
    return (j2, jm), (t2, tm)


def _hold_round(j, t):
    (j2, jm), (t2, tm) = j, t
    assert isinstance(t2.posterior, GaussianPosterior)
    assert tm["loss"].shape == () and tm["nll"].shape == tm["kl"].shape == (A,)
    for name in ("loss", "nll", "kl"):
        _close(tm[name], jm[name])
    return _hold_state(_flat_view(t2), _flat_view(j2))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("arch", ["repro-100m", "olmoe-1b-7b"])
def test_round_step_against_the_reference(arch, route):
    j, t = _round_case(arch, route)
    _hold_round(j, t)


def test_local_steps_against_a_stored_prior():
    """``launch.train``'s u > 1 round on the pytree: the consensus prior
    stored, then u = 2 local steps against it, each with its own tokens
    and draws."""
    from repro.optim.schedules import exponential_decay as jdecay
    from repro_torch.optim.schedules import exponential_decay

    jcfg, tcfg = _cfgs("repro-100m")
    jstate = _jax_tree_state(jcfg)
    jprior = js.make_consensus_step(jcfg, jnp.asarray(W, jnp.float32))(jstate.posterior)
    jstate = dataclasses.replace(jstate, posterior=jprior)
    tstate = _carry(jstate)
    tprior = tstate.posterior
    jlocal = jax.jit(js.make_local_step(jcfg, jadam(), jdecay(1e-3, 0.99), remat=False))
    tlocal = ts.make_local_step(tcfg, adam(), exponential_decay(1e-3, 0.99), remat=False)
    noise = None
    for u in range(2):
        jb, tb = _batch(jcfg, 10 + u)
        key = jax.random.key(20 + u)
        jstate, jloss = jlocal(jstate, jprior, jb, key)
        tstate, tloss = tlocal(tstate, tprior, tb, eps=_eps(key, jprior.mean))
        assert tloss.shape == ()
        _close(tloss, jloss)
        lanes = _noise(_flat_view(tstate), _flat_view(jstate))
        noise = lanes if noise is None else noise | lanes
    _hold_state(_flat_view(tstate), _flat_view(jstate), u=2, noise=noise)
    assert tprior.mean["embed"]["emb"].data_ptr() != tstate.posterior.mean["embed"][
        "emb"].data_ptr()  # the prior is kept


def _mlp_nll(pkg):
    """A two-layer MLP's summed softmax NLL over ``params`` ``{"l1": {"w",
    "b"}, "l2": {"w", "b"}}`` for one agent (JAX) or all agents (port)."""
    if pkg == "jax":
        def nll(p, batch):
            h = jnp.tanh(batch["x"] @ p["l1"]["w"] + p["l1"]["b"])
            logits = h @ p["l2"]["w"] + p["l2"]["b"]
            lp = jax.nn.log_softmax(logits)
            return -jnp.sum(jnp.take_along_axis(lp, batch["y"][:, None], axis=1))
        return nll

    def nll(p, batch):
        h = torch.tanh(batch["x"] @ p["l1"]["w"] + p["l1"]["b"][:, None])
        logits = h @ p["l2"]["w"] + p["l2"]["b"][:, None]
        lp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(lp, 2, batch["y"][..., None]).sum(dim=(1, 2))
    return nll


def test_nll_fn_local_step_against_the_reference():
    """The launch engine's form: each agent's free energy over 2 MC
    samples, the gradient of their sum (each agent's own), ``loss [A]``."""
    from repro.core.posterior import init_posterior
    from repro.optim.schedules import constant_schedule as jconst
    from repro_torch.optim.schedules import constant_schedule

    rng = np.random.default_rng(3)
    shapes = {"l1": {"w": (6, 5), "b": (5,)}, "l2": {"w": (5, 3), "b": (3,)}}
    mean = {k: {n: rng.normal(size=(A,) + s).astype(np.float32) * 0.3 for n, s in v.items()}
            for k, v in shapes.items()}
    jpost = init_posterior(jax.tree.map(jnp.asarray, mean), init_sigma=0.05)
    jstate = js.BayesTrainState(posterior=jpost, opt_state=jadam().init(jpost),
                                step=jnp.asarray(0, jnp.int32))
    batch = {"x": rng.normal(size=(A, 4, 6)).astype(np.float32),
             "y": rng.integers(0, 3, size=(A, 4))}
    key = jax.random.key(5)
    keys = jax.random.split(key, A)
    jstep = js.make_local_step(None, jadam(), jconst(1e-2), kl_scale=0.1,
                               nll_fn=_mlp_nll("jax"), n_mc_samples=2)
    jprior = jax.tree.map(lambda x: x * 0.9, jpost)
    j2, jloss = jax.jit(jstep)(jstate, jprior, jax.tree.map(jnp.asarray, batch), keys)
    tstep = ts.make_local_step(None, adam(), constant_schedule(1e-2), kl_scale=0.1,
                               nll_fn=_mlp_nll("torch"), n_mc_samples=2)
    tstate = _carry(jstate)
    t2, tloss = tstep(tstate, _tpost(jprior), {k: torch.from_numpy(v) for k, v in batch.items()},
                      eps=_eps(key, jpost.mean, n_samples=2))
    assert tloss.shape == (A,)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5, atol=1e-5)
    for got, want in zip(tree_leaves(t2.posterior), jax.tree.leaves(j2.posterior)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for got, want in zip(tree_leaves(t2.opt_state), jax.tree.leaves(j2.opt_state)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


_PPERMUTE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, "tests")
import jax, jax.numpy as jnp, numpy as np
from test_torch_pytree_steps import W, _batch, _cfgs, _jax_tree_state
from repro.launch import steps as js
from repro.launch.sharding import param_shardings
from repro.optim import adam

jcfg, _ = _cfgs("repro-100m")
jstate = _jax_tree_state(jcfg)
jb, _ = _batch(jcfg, 1)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
shard = param_shardings(jax.eval_shape(lambda: jstate), mesh, agent_leading=True)
step = js.make_train_round_step(jcfg, jnp.asarray(W, jnp.float32), opt=adam(), remat=False,
                                consensus_impl="ppermute", mesh=mesh,
                                posterior_shardings=shard.posterior)
with mesh:
    new, met = jax.jit(step)(jstate, jb, jax.random.key(2))
out = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(new))}
out.update({k: np.asarray(v) for k, v in met.items()})
np.savez(os.environ["PPERMUTE_OUT"], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ppermute_reference(tmp_path_factory):
    from conftest import run_multidevice_subprocess

    path = tmp_path_factory.mktemp("ppermute") / "reference.npz"
    run_multidevice_subprocess(
        f"import os\nos.environ['PPERMUTE_OUT'] = {str(path)!r}\n" + _PPERMUTE, timeout=300)
    return dict(np.load(path))


def test_ppermute_route_against_the_reference(ppermute_reference, monkeypatch):
    """``consensus_impl="ppermute"`` on the pytree routes through
    ``consensus_ppermute_pod`` with the step's W, the mesh, the shardings
    and the bf16 wire, and holds to the reference's sharded step."""
    from repro_torch.launch import consensus_opt as co

    jcfg, tcfg = _cfgs("repro-100m")
    jstate = _jax_tree_state(jcfg)
    _, tb = _batch(jcfg, 1)
    tstate = _carry(jstate)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), torch.device("cpu"))
    shard = param_shardings(tstate, mesh, agent_leading=True)
    calls = {}
    pod = co.consensus_ppermute_pod

    def spy(posts, W_, mesh_, shardings, wire_dtype=torch.bfloat16, axis="pod"):
        calls.update(mesh=mesh_, shardings=shardings, wire=wire_dtype, axis=axis)
        return pod(posts, W_, mesh_, shardings, wire_dtype, axis)

    monkeypatch.setattr(co, "consensus_ppermute_pod", spy)
    Wt = torch.as_tensor(W, dtype=torch.float32)
    step = ts.make_train_round_step(tcfg, Wt, opt=adam(), remat=False, consensus_impl="ppermute",
                                    mesh=mesh, posterior_shardings=shard.posterior)
    t2, tm = step(tstate, tb, eps=_eps(jax.random.key(2), jstate.posterior.mean))
    assert calls == {"mesh": mesh, "shardings": shard.posterior, "wire": torch.bfloat16,
                     "axis": "pod"}
    ref = ppermute_reference
    for name in ("loss", "nll", "kl"):
        _close(tm[name], ref[name])
    jleaves = [ref[f"leaf_{i}"] for i in range(len(tree_leaves(t2)))]
    jlike = jax.tree.unflatten(jax.tree.structure(jstate), jleaves)
    _hold_state(_flat_view(t2), _flat_view(jlike))
    with pytest.raises(ValueError, match="posterior_shardings"):
        ts.make_train_round_step(tcfg, Wt, consensus_impl="ppermute", mesh=mesh)(tstate, tb)


@pytest.mark.parametrize("route", ["einsum", "wire_bf16", "ppermute", "none"])
def test_pytree_round_equals_the_flat_round(route):
    """Inside the port: the pytree state and the flat state of one draw,
    one round from the same tokens and noise: the same step within the
    1e-4 rule (the KL's sums run by leaf instead of over the flat row)."""
    from repro_torch.data.pipeline import make_lm_batch_sampler

    _, tcfg = _cfgs("repro-100m")
    tree = ts.init_train_state(tcfg, A, adam(), torch.Generator().manual_seed(0), flat=False,
                               device="cpu")
    g = torch.Generator().manual_seed(7)
    tree.posterior.mean = tree_map(lambda m: m + torch.cat(
        [torch.zeros_like(m[:1]), 0.01 * torch.randn(m[1:].shape, generator=g)]),
        tree.posterior.mean)
    flat_post = flat_posterior_from_pytree(tree.posterior, leading_axes=1)
    flat = ts.BayesTrainState(posterior=flat_post, opt_state=adam().init(flat_post),
                              step=tree.step.clone())
    batch = make_lm_batch_sampler(tcfg.vocab_size, 2, 16, n_agents=A, device="cpu")(
        torch.Generator().manual_seed(1), 0)
    eps = torch.randn(flat.posterior.mean.shape, generator=torch.Generator().manual_seed(2))
    mesh = make_mesh((A, 1, 1), ("pod", "data", "model"), torch.device("cpu"))
    kw = {"einsum": {}, "wire_bf16": {"consensus_wire_dtype": torch.bfloat16},
          "ppermute": {"consensus_impl": "ppermute", "mesh": mesh}, "none": {"consensus_impl":
                                                                             "none"}}[route]
    Wt = torch.as_tensor(W, dtype=torch.float32)
    f2, fm = ts.make_train_round_step(tcfg, Wt, remat=False, **kw)(flat, batch, eps=eps)
    if route == "ppermute":
        kw["posterior_shardings"] = param_shardings(tree, mesh, agent_leading=True).posterior
    t2, tm = ts.make_train_round_step(tcfg, Wt, remat=False, **kw)(
        tree, batch, eps=flat.posterior.layout.unflatten(eps))
    for name in ("loss", "nll", "kl"):
        torch.testing.assert_close(tm[name], fm[name], atol=1e-4, rtol=0)
    _hold_state(_flat_view(t2), f2)
