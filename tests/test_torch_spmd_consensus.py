"""The placed train round's consensus routes and a flat state under
``data`` x ``model`` (``repro_torch.launch.spmd_steps.train_round``,
reached through ``launch.steps.make_train_round_step`` on a placed state)
against the JAX package's unplaced round on the CPU, on meshes of virtual
CPU positions.

Setting (``tests/test_distributed.py:130``'s, as
``tests/test_torch_spmd_steps.py``): reduced repro-100m at float32, A = 2,
a batch of 4 rows of 32 tokens an agent, ``kl_scale`` 1e-5, ``remat=False``,
the reference's flat state with agent 1's mean moved by seeded noise and
the reference's draws through the ``eps`` seam.  W is ``[[0.6, 0.4],
[0.25, 0.75]]``, whose entries bf16 and f16 do not hold exactly, so a route
that left W unrounded at a compressed wire would show.  The pytree form is
the same posterior as the parameter dict its rows flatten.

* A flat state on (2, 2, 2) at the f32 einsum: the round under
  ``test_distributed.py:130``'s rule against the reference's (the loss
  within rtol 1e-4; per leaf of the posterior's mean and rho the largest
  difference at most 2.5e-3 and the share beyond 1e-4 under 5e-3);
  bitwise the placed pytree round of the same state; the network kernel
  once a (data, model) position on a quarter of the row; every position's
  rows bitwise equal after two rounds; the rows' re-join moving what
  ``spmd_steps.rejoin_bytes`` says.
* The einsum at the bf16 and f16 wires, both forms, on (2, 2, 2) and
  (2, 1, 1): the prior the round computes against the reference's
  ``consensus_einsum(_flat)`` at that wire, within 1e-5 except at most
  0.1% of the lanes, each within one wire place (the lanes where a
  statistic sits at a wire rounding boundary and the packages round it
  apart, ``tests/test_torch_pod_consensus.py``'s rule); at bf16 the whole
  round against the reference's bf16 round under the rule above, those
  lanes excepted from the largest difference only.
* The placed einsum at an f32 wire bitwise the one without a wire.
* The ppermute consensus at f32 and bf16, both forms, both meshes: the
  prior bitwise the unplaced port route on the same state, mesh and
  shardings (``consensus_ppermute_ring_flat`` / ``consensus_ppermute_pod``);
  at f32 the round within the rule of the reference's einsum round (for two
  agents the ring is the complete graph).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.posterior import GaussianPosterior as JGaussian  # noqa: E402
from repro.data.pipeline import make_lm_batch_sampler as j_sampler  # noqa: E402
from repro.launch import consensus_opt as jco  # noqa: E402
from repro.launch import steps as js  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.core.flat import FlatPosterior, flat_posterior_from_pytree  # noqa: E402
from repro_torch.core.posterior import GaussianPosterior  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import consensus as kc  # noqa: E402
from repro_torch.launch import consensus_opt as co  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.launch import spmd_steps as ss  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import param_shardings  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from test_torch_spmd_steps import _cfgs, _move_agent1  # noqa: E402
from test_torch_zoo_train import _carry, _eps  # noqa: E402

A = 2
AXES = ("pod", "data", "model")
CPU = torch.device("cpu")
W = np.array([[0.6, 0.4], [0.25, 0.75]], np.float32)
WIRES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
TOL = 1e-5
WIRE_PLACE = {"bf16": 2.0 ** -8, "f16": 2.0 ** -11}
FLIP_SHARE = 1e-3
MESHES = {"2x2x2": (2, 2, 2), "2x1x1": (2, 1, 1)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setting():
    jcfg, tcfg = _cfgs("repro-100m")
    jstate = _move_agent1(js.init_train_state(jax.random.key(0), jcfg, A, jadam()), True)
    jb = j_sampler(jcfg.vocab_size, 4, 32, n_agents=A)(jax.random.key(1), 0)
    key = jax.random.key(2)
    flat = _carry(jstate, tcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jstate=jstate, jb=jb, key=key, flat=flat,
                layout=flat.posterior.layout, eps=_eps(key, flat.posterior.layout.n_params),
                batch={k: torch.from_numpy(np.array(v)) for k, v in jb.items()})


@pytest.fixture(scope="module")
def reference(setting):
    """The reference's round at the f32 (``consensus_all_agents``) or bf16
    (``consensus_einsum_flat``) wire, each compiled once: (its new flat
    posterior mean and rho, its mean loss)."""
    made = {}

    def get(wire):
        if wire not in made:
            step = js.make_train_round_step(
                setting["jcfg"], jnp.asarray(W), opt=jadam(), remat=False, kl_scale=1e-5,
                consensus_wire_dtype=None if wire == "f32" else jnp.bfloat16)
            j2, jm = jax.jit(step)(setting["jstate"], setting["jb"], setting["key"])
            made[wire] = (np.asarray(j2.posterior.mean), np.asarray(j2.posterior.rho),
                          float(jnp.mean(jm["loss"])))
        return made[wire]

    return get


def _state(setting, form):
    """The setting's state, flat or as the parameter dict its rows flatten."""
    flat = setting["flat"]
    if form == "flat":
        return flat
    unflatten = setting["layout"].unflatten
    post = tree_map(torch.clone, GaussianPosterior(mean=unflatten(flat.posterior.mean),
                                                   rho=unflatten(flat.posterior.rho)))
    return ts.BayesTrainState(posterior=post, opt_state=adam().init(post), step=flat.step.clone())


def _rows(post):
    """A (joined) posterior's flat ``[A, P]`` mean and rho."""
    if not isinstance(post, FlatPosterior):
        post = flat_posterior_from_pytree(post, leading_axes=1)
    return post.mean, post.rho


def _placed(setting, form, shape):
    state = _state(setting, form)
    mesh = make_mesh(shape, AXES, CPU)
    return state, mesh, spmd.device_put(state, param_shardings(state, mesh, agent_leading=True))


def _round(setting, form, shape, rounds=1, spy=None, monkeypatch=None, **kw):
    """``rounds`` placed round steps of the setting's state; with ``spy``
    (``"pod_consensus"`` or ``"pod_ppermute"``) also the first prior that
    route computed, joined."""
    state, mesh, placed = _placed(setting, form, shape)
    priors = []
    if spy is not None:
        route = getattr(ss, spy)

        def capture(*args, **kwargs):
            out = route(*args, **kwargs)
            priors.append(spmd.device_get(out))
            return out

        monkeypatch.setattr(ss, spy, capture)
    step = ts.make_train_round_step(setting["tcfg"], torch.from_numpy(W), opt=adam(),
                                    remat=False, kl_scale=1e-5, **kw)
    eps = setting["eps"] if form == "flat" else setting["layout"].unflatten(setting["eps"])
    outs = []
    for _ in range(rounds):
        placed, met = step(placed, setting["batch"], eps=eps)
        outs.append((placed, met))
    return outs, (priors[0] if priors else None), state, mesh


def _hold_round(setting, got, met, want, boundary=None):
    """``tests/test_distributed.py:130``'s rule per leaf of the posterior's
    mean and rho; ``boundary`` lanes are excepted from the largest
    difference only."""
    want_mean, want_rho, want_loss = want
    np.testing.assert_allclose(float(met["loss"]), want_loss, rtol=1e-4)
    for g, w, field in zip(_rows(spmd.device_get(got).posterior), (want_mean, want_rho),
                           ("mean", "rho")):
        diff = np.abs(g.numpy() - w)
        for spec in setting["layout"].specs:
            d = diff[:, spec.offset:spec.offset + spec.size]
            held = d if boundary is None else np.where(
                boundary[field][:, spec.offset:spec.offset + spec.size], 0.0, d)
            assert held.max() <= 2.5e-3, (field, spec.path, held.max())
            assert (d > 1e-4).mean() < 5e-3, (field, spec.path, (d > 1e-4).mean())


def _hold_wire(prior, jpost, wire):
    """The prior against the reference's at a compressed wire: within TOL
    except at the wire-boundary lanes (at most FLIP_SHARE), each within one
    wire place.  Returns those lanes of the mean and rho."""
    far_lanes, beyond, lanes = {}, 0, 0
    for got, want, field in zip(_rows(prior), (jpost.mean, jpost.rho), ("mean", "rho")):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want)
        far = err > TOL + TOL * np.abs(want)
        assert np.all(err <= TOL + WIRE_PLACE[wire] * (np.abs(want) + 1.0)), field
        far_lanes[field] = far
        beyond, lanes = beyond + int(far.sum()), lanes + far.size
    assert beyond <= FLIP_SHARE * lanes, (beyond, lanes)
    return far_lanes


def _same_rows(state):
    """Every position of a pod holds the same rows, bitwise, in each of the
    six buffers (the posterior's and Adam's moments')."""
    mesh = state.posterior.mean.mesh
    pods = [pos["pod"] for pos in mesh.positions()]
    for buf in tree_leaves(state.posterior) + tree_leaves(state.opt_state):
        first = {}
        for p, blk in zip(pods, buf.blocks):
            assert torch.equal(first.setdefault(p, blk), blk)
        assert len({id(b) for b in buf.blocks}) == mesh.size  # a row a position


def test_flat_state_under_data_x_model(setting, reference, monkeypatch):
    calls = []
    network = kc.consensus_fused_network

    def counted(W_, mean, rho, **kw):
        calls.append(mean.shape)
        return network(W_, mean, rho, **kw)

    monkeypatch.setattr(kc, "consensus_fused_network", counted)
    outs, _, state, mesh = _round(setting, "flat", (2, 2, 2), rounds=2)
    (got, met), (again, _) = outs
    p = setting["layout"].n_params
    assert len(calls) == 2 * 4 and all(s[0] == A and s[1] < p // 3 for s in calls), calls
    view = tree_leaves(ss.FlatRows(setting["layout"], got.posterior.mean).tree(
        got.posterior.mean))
    # position (0, d, m)'s blocks of every leaf (the replicated norm scales whole)
    assert [s[1] for s in calls[:4]] == [sum(x.blocks[i][0].numel() for x in view)
                                         for i in range(4)]
    _hold_round(setting, got, met, reference("f32"))
    _same_rows(got)
    _same_rows(again)
    # bitwise the placed pytree round of the same state
    (tree, tree_met), = _round(setting, "pytree", (2, 2, 2))[0]
    assert torch.equal(met["loss"], tree_met["loss"]) and torch.equal(met["nll"], tree_met["nll"])
    flat_got, tree_got = spmd.device_get(got), spmd.device_get(tree)
    for x, y in zip((flat_got.posterior, flat_got.opt_state.mu, flat_got.opt_state.nu),
                    (tree_got.posterior, tree_got.opt_state.mu, tree_got.opt_state.nu)):
        for a, b in zip(_rows(x), _rows(y)):
            assert torch.equal(a, b)
    # the re-join: what each position lacks of the row, by the formula
    rows = ss.FlatRows(setting["layout"], got.posterior.mean)
    spmd.reset_spmd_counts()
    joined = rows.rows(rows.tree(got.posterior.mean))
    moved = spmd.spmd_counts()
    assert all(torch.equal(x, y) for x, y in zip(joined.blocks, got.posterior.mean.blocks))
    lacked = 0
    for x in tree_leaves(rows.tree(got.posterior.mean)):
        f = math.prod(x.shape) // A // x.blocks[0][0].numel()  # distinct blocks a pod
        lacked += 4 * (f - 1) * A * (math.prod(x.shape) // A // f) * 4
    assert moved["all_gather"] == 1
    assert moved["all_gather_bytes"] == ss.rejoin_bytes(setting["layout"], mesh, A) == lacked
    assert lacked <= 3 * A * p * 4  # (k - 1) rows a pod, less the replicated leaves


@pytest.mark.parametrize("shape", list(MESHES.values()), ids=list(MESHES))
@pytest.mark.parametrize("form", ["flat", "pytree"])
@pytest.mark.parametrize("wire", ["bf16", "f16"])
def test_compressed_wire_einsum(setting, reference, monkeypatch, wire, form, shape):
    outs, prior, _, _ = _round(setting, form, shape, spy="pod_consensus",
                               monkeypatch=monkeypatch, consensus_wire_dtype=WIRES[wire])
    jwire = {"bf16": jnp.bfloat16, "f16": jnp.float16}[wire]
    jpost = setting["jstate"].posterior
    if form == "flat":
        want = jco.consensus_einsum_flat(jpost, jnp.asarray(W), wire_dtype=jwire)
    else:  # the reference's leaf-wise form, on the dict the rows flatten
        unflatten = jpost.layout.unflatten
        tree = jco.consensus_einsum(
            JGaussian(mean=unflatten(jpost.mean), rho=unflatten(jpost.rho)), jnp.asarray(W),
            wire_dtype=jwire)
        want = dataclasses.replace(jpost, mean=jpost.layout.flatten(tree.mean),
                                   rho=jpost.layout.flatten(tree.rho))
    boundary = _hold_wire(prior, want, wire)
    # W reaches the kernel rounded through the wire: on (2, 1, 1) the flat row is
    # one call, the plain version's bits; handed W unrounded it parts, and at bf16
    # fails the rule (at f16 W's rounding moves the prior by less than TOL)
    mean, rho = (torch.from_numpy(np.array(x)) for x in (jpost.mean, jpost.rho))
    unrounded = FlatPosterior(*kc.consensus_network_plain(torch.from_numpy(W), mean, rho,
                                                          WIRES[wire]), setting["layout"])
    if form == "flat" and shape == (2, 1, 1):
        rounded = kc.consensus_network_plain(torch.from_numpy(W).to(WIRES[wire]).float(),
                                             mean, rho, WIRES[wire])
        assert all(torch.equal(x, y) for x, y in zip(_rows(prior), rounded))
        assert not torch.equal(unrounded.mean, rounded[0])
    if wire == "bf16":
        with pytest.raises(AssertionError):
            _hold_wire(unrounded, want, wire)
    if wire == "bf16":
        (got, met), = outs
        _hold_round(setting, got, met, reference("bf16"), boundary)


@pytest.mark.parametrize("shape", list(MESHES.values()), ids=list(MESHES))
@pytest.mark.parametrize("form", ["flat", "pytree"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_ppermute(setting, reference, monkeypatch, wire, form, shape):
    kw = {"consensus_impl": "ppermute"}
    if wire == "f32":
        kw["consensus_wire_dtype"] = torch.float32
    outs, prior, state, mesh = _round(setting, form, shape, spy="pod_ppermute",
                                      monkeypatch=monkeypatch, **kw)
    W_ = torch.from_numpy(W)
    if form == "flat":  # the unplaced route: steps.py's ring over the rows' spec axis
        want = co.consensus_ppermute_ring_flat(state.posterior, mesh, "pod",
                                               wire_dtype=WIRES[wire], W=W_)
    else:
        want = co.consensus_ppermute_pod(
            state.posterior, W_, mesh, param_shardings(state, mesh, agent_leading=True).posterior,
            wire_dtype=WIRES[wire])
    for x, y in zip(tree_leaves(prior), tree_leaves(want)):
        assert torch.equal(x, y)
    (got, met), = outs
    if wire == "f32":
        _hold_round(setting, got, met, reference("f32"))
    else:
        assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(spmd.device_get(got)))


@pytest.mark.parametrize("form", ["flat", "pytree"])
def test_f32_wire_is_a_structural_no_op(setting, form):
    """The placed einsum at an f32 wire is the one without a wire, bitwise;
    W passes unrounded."""
    _, _, placed = _placed(setting, form, (2, 2, 2))
    W_ = torch.from_numpy(W)
    got = spmd.device_get(ss.pod_consensus(placed.posterior, W_, torch.float32))
    want = spmd.device_get(ss.pod_consensus(placed.posterior, W_, None))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(got), tree_leaves(want)))
