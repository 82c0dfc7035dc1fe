"""The launch engine of repro_torch (``api.LaunchEngine`` over
``launch.steps``) against the port's own ``SimulatedEngine`` and against
the JAX package's ``LaunchEngine``, on the CPU.

* Inside the port, launch and simulated sessions of one seed agree as
  tests/test_api.py:46 and :76 hold the JAX engines (posteriors atol/rtol
  1e-5, accuracies atol 1e-6); they draw the same noise from the session
  generator in the same order.
* Against JAX, the port's launch session runs on the JAX session's own
  draws, replayed as tests/test_torch_round.py does, from a JAX state
  carried across after one round (the zero-Adam-state caveat of that file):
  atol/rtol 1e-5.
* Launch checkpoints (``BayesTrainState`` leaves: posterior, Adam moments,
  the 0-d int32 step) cross both packages with every leaf bitwise, and
  resume is bitwise inside the port.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core.simulated import network_state_from_numpy  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import BayesTrainState, make_local_step  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.optim.schedules import exponential_decay  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
U, B = 2, 4


def _spec(mod, engine="launch", n_rounds=3, seed=0, **inf):
    """tests/test_api.py:24's spec: a 3-agent star, 8-dim 3-class data."""
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.star(n_edge=2, a=0.5),
        data=mod.DataSpec(
            dataset_params=dict(n_classes=3, dim=8, n_train_per_class=30),
            partition="star",
            partition_params=dict(center_labels=[1, 2], edge_labels=[0], n_edge=2),
            batch_size=B, local_updates=U,
        ),
        inference=mod.InferenceSpec(**{"hidden": 8, "depth": 1, "lr": 1e-2, **inf}),
        run=mod.RunSpec(n_rounds=n_rounds, seed=seed, engine=engine),
    )


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), rtol=1e-5, atol=atol)


# -- inside the port --------------------------------------------------------------


@pytest.mark.parametrize("lr_decay", [1.0, 0.9])
def test_launch_and_simulated_engines_agree(lr_decay):
    sim = tapi.build_session(_spec(tapi, "simulated", lr_decay=lr_decay), device="cpu")
    lau = tapi.build_session(_spec(tapi, "launch", lr_decay=lr_decay), device="cpu")
    h_sim, h_lau = sim.run(), lau.run()
    assert isinstance(lau.state, BayesTrainState)
    assert lau.engine.name == "launch"
    p_sim, p_lau = sim.posterior(), lau.posterior()
    _close(p_lau.mean, p_sim.mean.numpy())
    _close(p_lau.rho, p_sim.rho.numpy())
    assert [r["loss"] for r in h_lau] == pytest.approx([r["loss"] for r in h_sim], abs=1e-5)
    fresh = tapi.build_session(_spec(tapi, "simulated"), device="cpu").posterior()
    assert float((p_sim.mean - fresh.mean).abs().max()) > 1e-4  # training moved it
    assert lau.state.step.shape == () and lau.state.step.dtype == torch.int32
    assert int(lau.state.step) == 3 * U
    np.testing.assert_allclose(lau.evaluate()["acc"], sim.evaluate()["acc"], atol=1e-6)
    assert lau.health() == sim.health()


def test_launch_engine_consumes_the_generator_as_simulated_does():
    """The same draws in the same order: the generators end in one state."""
    sim = tapi.build_session(_spec(tapi, "simulated"), device="cpu")
    lau = tapi.build_session(_spec(tapi, "launch"), device="cpu")
    sim.run(n_rounds=2)
    lau.run(n_rounds=2)
    assert torch.equal(sim.generator.get_state(), lau.generator.get_state())


def test_launch_run_round_takes_injected_noise():
    s = tapi.build_session(_spec(tapi), device="cpu")
    n, p = s.posterior().mean.shape
    g = torch.Generator().manual_seed(3)
    idx = torch.randint(0, 20, (n, U * B), generator=g)
    eps = torch.randn((n, U, 1, p), generator=g)
    before = s.generator.get_state()
    a = s.round(batch_idx=idx, eps=eps)
    assert torch.equal(s.generator.get_state(), before)  # nothing drawn
    t = tapi.build_session(_spec(tapi), device="cpu")
    b = t.round(batch_idx=idx, eps=eps)
    assert a["losses"].tolist() == b["losses"].tolist()
    assert torch.equal(s.posterior().mean, t.posterior().mean)


def test_mean_only_is_refused():
    with pytest.raises(ValueError, match="mean_only"):
        tapi.build_session(_spec(tapi, consensus="mean_only"), device="cpu")


def test_lr_decays_per_round_while_the_step_ticks_per_local_step(monkeypatch):
    from repro_torch.launch import steps

    seen = []
    real = steps.vi_step

    def spy(post, prior, opt, opt_state, nll_fn, batch, lr, step, *a, **k):
        seen.append((float(lr), int(step)))
        return real(post, prior, opt, opt_state, nll_fn, batch, lr, step, *a, **k)

    monkeypatch.setattr(steps, "vi_step", spy)
    s = tapi.build_session(_spec(tapi, lr=1e-2, lr_decay=0.5), device="cpu")
    s.run(n_rounds=3)
    want = [(float(np.float32(1e-2) * np.float32(0.5) ** r), U * r + t)
            for r in range(3) for t in range(U)]
    assert seen == pytest.approx(want, rel=1e-6)


def test_exponential_decay_on_an_int32_floor_division():
    sched = exponential_decay(1e-3, 0.9)
    step = torch.tensor(7, dtype=torch.int32)
    q = step // 4
    assert q.dtype == torch.int32 and int(q) == 1
    assert float(sched(q)) == pytest.approx(1e-3 * 0.9, rel=1e-6)
    assert torch.equal(sched(q), sched(torch.tensor(1, dtype=torch.int32)))


def test_adam_scalar_step_equals_per_agent_step():
    """The launch engine passes one scalar step where the simulated engine
    passes ``[N]``: the bias corrections broadcast to the same bits."""
    g = torch.Generator().manual_seed(0)
    params = torch.randn((3, 11), generator=g)
    grads = torch.randn((3, 11), generator=g)
    opt = adam()
    state = opt.init(params)
    lr = torch.tensor(1e-2)
    for t in range(3):
        u_s, st_s = opt.update(grads, state, torch.tensor(t, dtype=torch.int32), lr)
        u_v, st_v = opt.update(grads, state, torch.full((3,), t, dtype=torch.int32), lr)
        assert torch.equal(u_s, u_v) and torch.equal(st_s.nu, st_v.nu)
        state = st_s


def test_make_local_step_refuses_the_language_model_objective():
    """The LM objective is ported (tests/test_torch_zoo_train.py): the step
    needs a model config or an ``nll_fn``, and with an ``nll_fn`` the config
    is not read, as in the reference."""
    with pytest.raises(ValueError, match="config or an nll_fn"):
        make_local_step(None, adam(), exponential_decay(1e-3, 1.0))
    assert callable(make_local_step(object(), adam(), exponential_decay(1e-3, 1.0),
                                    nll_fn=lambda params, batch: None))


def test_launch_package_imports_without_a_model_zoo():
    code = ("import sys, repro_torch.launch as l; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro') "
            "or m.startswith(('repro_torch.models', 'repro_torch.configs'))]; "
            "print(sorted(l.__all__), bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.stdout.strip() == (
        "['BayesTrainState', 'make_consensus_step', 'make_local_step', "
        "'make_train_round_step'] []")


# -- against the JAX package ------------------------------------------------------


def _shard_sizes():
    ds = jsyn.make_synthetic_classification(n_classes=3, dim=8, n_train_per_class=30)
    return [len(y) for _, y in jpart.star_partition(
        ds.x_train, ds.y_train, center_labels=[1, 2], edge_labels=[0], n_edge=2)]


def _replay_round_draws(session, n_samples):
    """The batch indices [N, U*B] and BbB noise [N, U, S, P] the JAX
    session's next round() draws (tests/test_torch_round.py:62)."""
    n, p = session.state.posterior.mean.shape
    _, k_batch, k_round = jax.random.split(session.key, 3)
    idx = np.stack([np.asarray(jax.random.randint(k, (U * B,), 0, n_a))
                    for k, n_a in zip(jax.random.split(k_batch, n), _shard_sizes())])
    eps = np.empty((n, U, n_samples, p), np.float32)
    for a, k_a in enumerate(jax.random.split(k_round, n)):
        for t, k_t in enumerate(jax.random.split(k_a, U)):
            for s, k_s in enumerate(jax.random.split(k_t, n_samples)):
                eps[a, t, s] = np.asarray(jax.random.normal(k_s, (p,), jnp.float32))
    return idx, eps


def _carry(jstate, layout):
    """A JAX ``BayesTrainState`` as the port's, through numpy."""
    post, opt = jstate.posterior, jstate.opt_state
    ns = network_state_from_numpy(
        np.asarray(post.mean), np.asarray(post.rho), layout=layout,
        mu=(np.asarray(opt.mu.mean), np.asarray(opt.mu.rho)),
        nu=(np.asarray(opt.nu.mean), np.asarray(opt.nu.rho)), device="cpu")
    return BayesTrainState(posterior=ns.posterior, opt_state=ns.opt_state,
                           step=torch.tensor(int(np.asarray(jstate.step)), dtype=torch.int32))


@pytest.mark.parametrize("inf", [
    {}, {"n_mc_samples": 2}, {"consensus": "none"}, {"lr_decay": 0.9}, {"wire_dtype": "bf16"},
], ids=["gaussian", "mc2", "none", "decay", "wire_bf16"])
def test_launch_matches_jax_launch_on_replayed_draws(inf):
    js = japi.build_session(_spec(japi, **inf))
    ts = tapi.build_session(_spec(tapi, **inf), device="cpu")
    assert type(js.engine).__name__ == type(ts.engine).__name__ == "LaunchEngine"
    js.round()  # leave the zero Adam state (tests/test_torch_round.py)
    ts.state = _carry(js.state, ts.posterior().layout)
    ts.round_idx = js.round_idx
    for _ in range(2):
        idx, eps = _replay_round_draws(js, inf.get("n_mc_samples", 1))
        jrec = js.round()
        trec = ts.round(batch_idx=idx, eps=eps)
        assert trec["loss"] == pytest.approx(jrec["loss"], rel=1e-5, abs=1e-5)
        jst, tst = js.state, ts.state
        _close(tst.posterior.mean, jst.posterior.mean)
        _close(tst.posterior.rho, jst.posterior.rho)
        for m in ("mu", "nu"):
            for f in ("mean", "rho"):
                _close(getattr(getattr(tst.opt_state, m), f),
                       getattr(getattr(jst.opt_state, m), f))
        assert int(tst.step) == int(np.asarray(jst.step))
    assert int(ts.state.step) == 3 * U


def _assert_leaves_bitwise(tstate, jstate):
    tl, jl = tree_leaves(tstate), jax.tree.leaves(jstate)
    assert len(tl) == len(jl) == 7  # mean, rho, mu x2, nu x2, step
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name
        np.testing.assert_array_equal(t.cpu().numpy(), j)


def test_jax_launch_checkpoint_loads_in_the_port(tmp_path):
    js = japi.build_session(_spec(japi))
    js.run(2)
    path = str(tmp_path / "j.ckpt")
    js.save(path)
    ts = tapi.Session.load(path, device="cpu")
    assert isinstance(ts.state, BayesTrainState) and ts.round_idx == 2
    assert ts.state.step.shape == () and ts.state.step.dtype == torch.int32
    _assert_leaves_bitwise(ts.state, js.state)
    assert ts.health() == js.health()


def test_port_launch_checkpoint_loads_in_jax(tmp_path):
    ts = tapi.build_session(_spec(tapi), device="cpu")
    ts.run(2)
    path = str(tmp_path / "t.ckpt")
    ts.save(path)
    js = japi.Session.load(path)
    assert type(js.engine).__name__ == "LaunchEngine" and js.round_idx == 2
    _assert_leaves_bitwise(ts.state, js.state)
    assert js.health() == ts.health()


def test_launch_resume_is_bitwise_in_the_port(tmp_path):
    a = tapi.build_session(_spec(tapi), device="cpu")
    a.run(2)
    path = str(tmp_path / "a.ckpt")
    a.save(path)
    b = tapi.Session.load(path, device="cpu")
    assert isinstance(b.state, BayesTrainState)
    ra, rb = a.round(), b.round()
    assert ra["losses"].tolist() == rb["losses"].tolist()
    for x, y in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_launch_state_moves_between_devices():
    s = tapi.build_session(_spec(tapi), device="cpu")
    s.run(1)
    moved = s.state.to("cpu")
    assert isinstance(moved, BayesTrainState)
    assert moved.posterior.mean.data_ptr() != s.state.posterior.mean.data_ptr()
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(moved), tree_leaves(s.state)))
    assert dataclasses.is_dataclass(moved.opt_state)
