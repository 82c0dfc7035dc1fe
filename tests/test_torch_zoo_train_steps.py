"""LM training on the port, continued from tests/test_torch_zoo_train.py
(its setting, draws and hold rule, imported from it): the round step's
other routes and ``launch.train``'s u > 1 local steps against the JAX
package; inside the port, ``remat`` on == off bitwise, flat ppermute ==
einsum (the routing pinned as tests/test_gossip.py:1143 pins the
reference's), the loss falling over 10 steps on one batch
(tests/test_steps_and_substrate.py:33), the flash-attention kernel kept out
of every recorded forward; and the entry points ``launch.train`` (both round
forms, a checkpoint) and ``launch.serve`` (its lines against the
reference's) at a tiny size.
"""
import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.graphs import complete_w  # noqa: E402
from repro.launch import steps as js  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.core.flat import FlatPosterior  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.launch.mesh import agent_mesh  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from test_torch_zoo_train import (  # noqa: E402
    A,
    B,
    S,
    W,
    _batch,
    _carry,
    _cfgs,
    _close,
    _eps,
    _hold_state,
    _jax_state,
    _noise,
    _round_case,
)

ARCHS = ["repro-100m", "olmoe-1b-7b", "recurrentgemma-9b", "xlstm-1.3b"]
NUMBER = re.compile(r"-?\d[\d,]*(\.\d+)?(e[-+]?\d+)?")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("route", ["deterministic", "wire_bf16", "none"])
def test_round_step_routes_against_the_reference(route):
    """``bayesian=False`` (the NLL at the mean: KL exactly 0, rho untouched),
    the bf16 wire (``consensus_einsum_flat``) and no consensus."""
    jkw, tkw = {
        "deterministic": (dict(bayesian=False), None),
        "wire_bf16": (dict(consensus_wire_dtype=jnp.bfloat16),
                      dict(consensus_wire_dtype=torch.bfloat16)),
        "none": (dict(consensus_impl="none"), None),
    }[route]
    (j2, jm), (t2, tm) = _round_case("repro-100m", jkw, tkw)
    for name in ("loss", "nll", "kl"):
        _close(tm[name], jm[name])
    if route == "deterministic":
        assert torch.count_nonzero(tm["kl"]) == 0
        assert torch.count_nonzero(t2.opt_state.mu.rho) == 0
    _hold_state(t2, j2)


def test_local_steps_against_a_stored_prior():
    """``launch.train``'s u > 1 round: the consensus prior stored, the
    posterior set to it, then u = 2 local steps against it (the second with
    a KL above 0), each with its own tokens and draws."""
    jcfg, tcfg = _cfgs("repro-100m")
    jstate = _jax_state(jcfg)
    jprior = js.make_consensus_step(jcfg, jnp.asarray(W, jnp.float32))(jstate.posterior)
    jstate = dataclasses.replace(jstate, posterior=jprior)
    tstate = _carry(jstate, tcfg)
    tprior = tstate.posterior
    from repro.optim.schedules import exponential_decay as jdecay
    from repro_torch.optim.schedules import exponential_decay

    jlocal = jax.jit(js.make_local_step(jcfg, jadam(), jdecay(1e-3, 0.99), remat=False))
    tlocal = ts.make_local_step(tcfg, adam(), exponential_decay(1e-3, 0.99), remat=False)
    p = jprior.mean.shape[1]
    noise = None
    for u in range(2):
        jb, tb = _batch(jcfg, 10 + u)
        key = jax.random.key(20 + u)
        jstate, jloss = jlocal(jstate, jprior, jb, key)
        tstate, tloss = tlocal(tstate, tprior, tb, eps=_eps(key, p))
        assert tloss.shape == ()
        _close(tloss, jloss)
        noise = _noise(tstate, jstate) if noise is None else noise | _noise(tstate, jstate)
    _hold_state(tstate, jstate, u=2, noise=noise)
    assert tprior.mean.data_ptr() != tstate.posterior.mean.data_ptr()  # the prior is kept


# -- inside the port ----------------------------------------------------------------


def _port_case(arch, seed=0):
    _, tcfg = _cfgs(arch)
    state = ts.init_train_state(tcfg, A, adam(), torch.Generator().manual_seed(seed),
                                device="cpu")
    state.posterior.mean[1] += 0.01 * torch.randn(
        state.posterior.mean.shape[1], generator=torch.Generator().manual_seed(7))
    from repro_torch.data.pipeline import make_lm_batch_sampler

    batch = make_lm_batch_sampler(tcfg.vocab_size, B, S, n_agents=A, device="cpu")(
        torch.Generator().manual_seed(1), 0)
    eps = torch.randn(state.posterior.mean.shape, generator=torch.Generator().manual_seed(2))
    return tcfg, state, batch, eps


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_bit(arch, monkeypatch):
    """``remat=True`` recomputes each period in the backward pass (the
    blocks run twice as often) and gives the same bits."""
    from repro_torch.models import transformer

    tcfg, state, batch, eps = _port_case(arch)
    calls = []
    apply = transformer.block_apply
    monkeypatch.setattr(transformer, "block_apply",
                        lambda *a, **k: calls.append(1) or apply(*a, **k))
    out = {}
    for remat in (False, True):
        calls.clear()
        step = ts.make_train_round_step(tcfg, torch.as_tensor(W, dtype=torch.float32),
                                        remat=remat)
        out[remat] = (step(state, batch, eps=eps), len(calls))
    (off, n_off), (on, n_on) = out[False], out[True]
    assert n_on == 2 * n_off > 0
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(off), tree_leaves(on)))


def test_flat_ppermute_routes_through_the_ring_and_equals_einsum(monkeypatch):
    """``consensus_impl="ppermute"`` on the flat posterior goes through
    ``consensus_ppermute_ring_flat`` with the step's W, over the axis of the
    posterior shardings' first spec entry, else ``"pod"`` (as
    tests/test_gossip.py:1143 pins the reference's routing), and at the f32
    wire gives the einsum route's step; without a mesh it is refused.  A
    pytree posterior takes the leaf-wise ``consensus_ppermute_pod``, which
    needs the shardings (tests/test_torch_pytree_steps.py)."""
    import repro_torch.launch.consensus_opt as co
    from repro_torch.core.posterior import GaussianPosterior
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import NamedSharding, P, param_shardings

    tcfg, state, batch, eps = _port_case("repro-100m")
    Wt = torch.as_tensor(W, dtype=torch.float32)
    mesh = make_mesh((A, 1, 1), ("pod", "data", "model"), torch.device("cpu"))
    calls = {}
    ring = co.consensus_ppermute_ring_flat

    def spy(posts, mesh_, axis, self_weight=1.0 / 3.0, wire_dtype=torch.float32, W=None):
        calls.update(axis=axis, W=W, flat=isinstance(posts, FlatPosterior), wire=wire_dtype)
        return ring(posts, mesh_, axis, self_weight, wire_dtype, W)

    monkeypatch.setattr(co, "consensus_ppermute_ring_flat", spy)
    ring_out = ts.make_train_round_step(tcfg, Wt, consensus_impl="ppermute", mesh=mesh,
                                        consensus_wire_dtype=torch.float32)(state, batch, eps=eps)
    assert calls == {"axis": "pod", "W": Wt, "flat": True, "wire": torch.float32}
    assert calls["W"] is Wt
    ts.make_train_round_step(tcfg, Wt, consensus_impl="ppermute", mesh=mesh)(state, batch,
                                                                             eps=eps)
    assert calls["wire"] is torch.bfloat16  # the reference's default wire
    agents = agent_mesh([torch.device("cpu")] * A)
    shardings = FlatPosterior(NamedSharding(agents, P(agents.axis, None)), None, None)
    again = ts.make_train_round_step(tcfg, Wt, consensus_impl="ppermute", mesh=agents,
                                     consensus_wire_dtype=torch.float32,
                                     posterior_shardings=shardings)(state, batch, eps=eps)
    assert calls["axis"] == agents.axis  # the shardings' first spec entry
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(ring_out)))
    einsum_out = ts.make_train_round_step(tcfg, Wt, consensus_wire_dtype=torch.float32)(
        state, batch, eps=eps)
    torch.testing.assert_close(ring_out[1], einsum_out[1], atol=1e-6, rtol=1e-6)
    _hold_state(ring_out[0], einsum_out[0])  # eq. (6)'s sums in another order
    with pytest.raises(ValueError, match="mesh"):
        ts.make_train_round_step(tcfg, Wt, consensus_impl="ppermute")(state, batch, eps=eps)
    tree = ts.init_train_state(tcfg, A, adam(), torch.Generator().manual_seed(0), flat=False,
                               device="cpu")
    with pytest.raises(ValueError, match="posterior_shardings"):
        ts.make_train_round_step(tcfg, Wt, consensus_impl="ppermute", mesh=mesh)(tree, batch)
    calls.clear()
    pod = ts.make_train_round_step(tcfg, Wt, consensus_impl="ppermute", mesh=mesh,
                                   posterior_shardings=param_shardings(
                                       tree, mesh, agent_leading=True).posterior)(tree, batch)
    assert isinstance(pod[0].posterior, GaussianPosterior) and calls == {}  # not the flat ring


def test_loss_falls_on_a_fixed_batch():
    """tests/test_steps_and_substrate.py:33 on the port: 10 round steps on
    one batch, noise from the generator."""
    tcfg, state, batch, _ = _port_case("repro-100m")
    step = ts.make_train_round_step(tcfg, torch.as_tensor(complete_w(A), dtype=torch.float32),
                                    remat=False, kl_scale=1e-5)
    g = torch.Generator().manual_seed(3)
    losses = []
    for _ in range(10):
        state, m = step(state, batch, generator=g)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert int(state.step) == 10


def test_training_keeps_the_kernel_out_of_the_recorded_forward(monkeypatch):
    """A training step never reaches ``flash_attention`` (the reference
    trains through ``chunked_attention``); a no-grad forward does, and a
    kernel forward recorded under autograd refuses its backward."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as att
    from repro_torch.models import forward

    tcfg, state, batch, eps = _port_case("repro-100m")
    calls = []
    kernel = ops.attention
    monkeypatch.setattr(ops, "attention", lambda *a, **k: calls.append(1) or kernel(*a, **k))
    ts.make_train_round_step(tcfg, torch.as_tensor(W, dtype=torch.float32))(state, batch,
                                                                             eps=eps)
    assert not calls
    params = state.posterior.layout.unflatten(state.posterior.mean)
    with torch.no_grad():
        forward(params, tcfg, batch["tokens"])
    assert len(calls) == tcfg.n_layers
    q = torch.randn((1, 8, 2, 16), requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        att.kernel_attention(q, q, q, causal=True).sum().backward()


def test_local_step_refuses_neither_a_config_nor_an_nll():
    with pytest.raises(ValueError, match="config or an nll_fn"):
        ts.make_local_step(None, adam(), lambda s: torch.tensor(1e-3))


# -- the entry points ----------------------------------------------------------------


def _template(line):
    return " ".join(NUMBER.sub("#", line).split())


@pytest.mark.parametrize("form", ["local_steps", "round_step", "deterministic"])
def test_launch_train_runs_both_round_forms(form, tmp_path, capsys):
    """``launch.train`` at the smoke config on the CPU: consensus then u = 2
    local steps, the round step (u = 1), and ``--no-bayesian``; the
    parameter count the reference prints (A P), a finite loss each round,
    and the checkpoint restored at the step the rounds reached."""
    from repro.configs import get_config as jget
    from repro.launch import dryrun as jdry
    from repro.models import init_params as jinit
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    extra = {"local_steps": ["--local-steps", "2"], "round_step": ["--local-steps", "1"],
             "deterministic": ["--no-bayesian"]}[form]
    losses = train.main(["--reduced", "--device", "cpu", "--rounds", "2", "--batch", "2",
                         "--seq", "16", "--ckpt-dir", str(tmp_path)] + extra)
    out = capsys.readouterr().out.splitlines()
    jcfg = jget("repro-100m").reduced()
    p = jdry.count_params(jax.eval_shape(lambda: jinit(jcfg, jax.random.key(0))))
    assert out[0] == f"arch={jcfg.name} agents=2 posterior params={A * p:,}"
    assert [_template(x) for x in out[1:3]] == ["round #/# loss # ( #s)"] * 2
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert out[-1] == f"checkpoint saved to {tmp_path}"
    like = ts.init_train_state(get_config("repro-100m").reduced(), A, adam(),
                               torch.Generator().manual_seed(0), device="cpu")
    step, state = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 2 and int(state.step) == (4 if form == "local_steps" else 2)


def test_launch_serve_prints_the_reference_lines(monkeypatch, capsys):
    """``launch.serve`` on the CPU against the reference's command, the same
    flags: every line's template; the request counts and the snapshot line
    whole but for its staleness percentiles."""
    import repro.launch.serve as jserve
    from repro_torch.launch import serve

    argv = ["--rounds", "2", "--requests", "6"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    tel = serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert [_template(x) for x in got] == [_template(x) for x in want]
    assert got[2] == want[2]  # served N requests (rows, slabs, pad rows, traces)
    assert got[1].split(" telemetry=")[0] == want[1].split(" telemetry=")[0]
    assert tel["requests"] == 6 and tel["traces"] == int(want[2].split()[-2])
