"""The sharded gossip windows of repro_torch (``launch.consensus_opt``,
``core.flat``'s ``mode="ppermute"``, ``GossipEngine`` on
``consensus_impl="ppermute"``) on the CPU, over meshes of virtual shards
(``[cpu] * S``, one process: the reference's own sharded tests run 8 virtual
CPU devices in one process).

Inside the port the sharded window is bitwise the masked window at every
wire dtype, for every clock, topology and shard count of the reference's
acceptance tests (tests/test_gossip.py:994, tests/test_wire_dtype.py:591),
and the engine-level session is bitwise the masked session
(tests/test_gossip.py:1052, tests/test_wire_dtype.py:634,
tests/test_faults.py:538, :594).  Against the JAX package: atol 1e-5 at f32
(fp32 reduction order), one wire ulp of the output scale at bf16 and f16 (a
one-ulp fp32 difference in prec can flip a rounding tie); the ring forms at
bf16 within 2e-2, the reference's own bound (tests/test_distributed.py:60).
The bitwise rungs are asserted inside the port only, never across the
packages.  The CUDA kernels run only on the card
(tests/test_torch_kernels_cuda.py).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch.api.spec as tspec  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.core.posterior import GaussianPosterior as JGaussian  # noqa: E402
from repro.gossip import clocks as jclocks  # noqa: E402
from repro.launch import consensus_opt as jopt  # noqa: E402
from repro_torch.api import build_session as tbuild  # noqa: E402
from repro_torch.core import flat as tflat  # noqa: E402
from repro_torch.core.graphs import (  # noqa: E402
    bidirectional_ring_w,
    time_varying_star_schedule,
    torus_w,
)
from repro_torch.core.posterior import GaussianPosterior  # noqa: E402
from repro_torch.gossip import clocks as tclocks  # noqa: E402
from repro_torch.kernels import consensus as tk  # noqa: E402
from repro_torch.launch import consensus_opt as topt  # noqa: E402
from repro_torch.launch.costmodel import gossip_window_roofline  # noqa: E402
from repro_torch.launch.mesh import AgentMesh, agent_mesh, local_devices  # noqa: E402

CPU = torch.device("cpu")
WIRES = [None, "f32", "bf16", "f16"]
WIRE_EPS = {"bf16": 2.0 ** -7, "f16": 2.0 ** -10}
P = 200
# tests/test_gossip.py:994's topologies and shard counts (time-varying star: 5 agents)
CASES = [("ring", 2), ("ring", 4), ("ring", 8), ("torus", 2), ("torus", 8),
         ("time_varying_star", 5)]


def _mesh(s):
    return AgentMesh((CPU,) * s)


def _clocks(mod, name):
    """The reference's clocks on one topology, from ``mod`` (either package)."""
    if name == "time_varying_star":
        table, trace = mod.trace_from_schedule(time_varying_star_schedule(4, 2, a=0.5))
        return [mod.TraceClock(table, trace, rule="table")]
    W = bidirectional_ring_w(8) if name == "ring" else torus_w(2, 4)
    return [mod.PoissonClock(W, rate=0.6, seed=1), mod.RoundRobinClock(W, edges_per_window=3),
            mod.all_edges_trace(W)]


def _posts(n, p=P, seed=0, scale=0.4):
    rng = np.random.default_rng(seed)
    mean = (rng.normal(size=(n, p)) * 3.0).astype(np.float32)
    rho = (rng.normal(size=(n, p)) * scale - 1.0).astype(np.float32)  # f16-safe precisions
    return mean, rho


def _tpost(mean, rho):
    layout = tflat.FlatLayout.for_pytree({"w": torch.zeros(mean.shape[1])})
    return tflat.FlatPosterior(torch.from_numpy(mean.copy()), torch.from_numpy(rho.copy()),
                               layout)


def _jpost(mean, rho):
    layout = jflat.FlatLayout.for_pytree({"w": jnp.zeros((mean.shape[1],))})
    return jflat.FlatPosterior(mean=jnp.asarray(mean), rho=jnp.asarray(rho), layout=layout)


def _bitwise(a, b):
    return torch.equal(a.mean, b.mean) and torch.equal(a.rho, b.rho)


def _close(got, want, wire):
    got, want = np.asarray(got), np.asarray(want)
    if wire in (None, "f32"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        u = WIRE_EPS[wire]
        np.testing.assert_allclose(got, want, rtol=u, atol=u * np.abs(want).max())


# -- the rotation schedule -----------------------------------------------------


def test_window_shard_offsets_schedule():
    """tests/test_gossip.py:1123, in the port: only offsets that fired edges
    cross; intra-shard edges and idle windows need no rotation."""
    W = bidirectional_ring_w(8)
    win = tclocks.all_edges_trace(W).window(0)
    assert topt.window_shard_offsets(win, 4) == (1, 3)
    assert topt.window_shard_offsets(win, 8) == (1, 7)
    assert topt.window_shard_offsets(win, 1) == ()
    assert topt.window_shard_offsets(tclocks.window_from_events(W, [(0, 1)], e_max=2), 4) == ()
    assert topt.window_shard_offsets(tclocks.window_from_events(W, [], e_max=2), 4) == ()


@pytest.mark.parametrize("name,shards", CASES)
def test_window_shard_offsets_equal_jax(name, shards):
    for tclock, jclock in zip(_clocks(tclocks, name), _clocks(jclocks, name)):
        for r in range(6):
            tw, jw = tclock.window(r), jclock.window(r)
            assert topt.window_shard_offsets(tw, shards) == jopt.window_shard_offsets(jw, shards)


# -- one window: sharded == masked, bitwise ------------------------------------


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("name,shards", CASES)
def test_sharded_window_is_masked_bitwise(name, shards, wire):
    """tests/test_gossip.py:994 and tests/test_wire_dtype.py:591, in the
    port: every window of every clock, at every wire dtype."""
    for clock in _clocks(tclocks, name):
        n = clock.window(0).n_agents
        posts = _tpost(*_posts(n, seed=n))
        for r in range(4):
            win = clock.window(r)
            ref = tflat.consensus_flat_masked(posts, win.w_eff, win.active, wire_dtype=wire)
            out = topt.consensus_ppermute_window(posts, win, _mesh(shards), wire_dtype=wire)
            assert _bitwise(out, ref), (name, shards, r, wire)
            routed = tflat.consensus_flat_masked(posts, win.w_eff, win.active, mode="ppermute",
                                                 mesh=_mesh(shards), window=win, wire_dtype=wire)
            assert _bitwise(routed, ref)


@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("name,shards", [("ring", 1), ("ring", 4), ("torus", 8),
                                         ("time_varying_star", 5)])
def test_sharded_window_matches_jax(name, shards, wire):
    """Against JAX's masked window (``mode="xla"``); at one shard also
    against JAX's own ``consensus_ppermute_window`` (its single-shard mesh,
    tests/test_wire_dtype.py:247)."""
    mean, rho = _posts(8 if name != "time_varying_star" else 5, seed=3)
    tposts, jposts = _tpost(mean, rho), _jpost(mean, rho)
    for tclock, jclock in zip(_clocks(tclocks, name), _clocks(jclocks, name)):
        for r in range(3):
            tw, jw = tclock.window(r), jclock.window(r)
            out = topt.consensus_ppermute_window(tposts, tw, _mesh(shards), wire_dtype=wire)
            ref = jflat.consensus_flat_masked(jposts, jnp.asarray(jw.w_eff, jnp.float32),
                                              jnp.asarray(jw.active), mode="xla",
                                              wire_dtype=wire)
            _close(out.mean.numpy(), ref.mean, wire)
            _close(out.rho.numpy(), ref.rho, wire)
            if shards == 1:
                mesh1 = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("agents",))
                jsh = jopt.consensus_ppermute_window(jposts, jw, mesh1, "agents",
                                                     wire_dtype=wire)
                _close(out.mean.numpy(), jsh.mean, wire)
                _close(out.rho.numpy(), jsh.rho, wire)


def test_f32_wire_is_a_structural_no_op():
    """The f32 wire moves float32 statistics and rounds nothing: the same
    bits as no wire dtype, and the encode's plain version hands back its
    own computation, uncast."""
    win = tclocks.PoissonClock(bidirectional_ring_w(8), rate=0.7, seed=3).window(1)
    posts = _tpost(*_posts(8))
    a = topt.consensus_ppermute_window(posts, win, _mesh(4), wire_dtype="f32")
    b = topt.consensus_ppermute_window(posts, win, _mesh(4))
    assert _bitwise(a, b)
    prec, pm = tk.consensus_shard_encode_plain(posts.mean, posts.rho, 8, 0, "f32")
    assert prec.dtype == pm.dtype == torch.float32


def test_rotations_move_wire_bytes_the_cost_model_counts():
    """A rotation copies wire-dtype blocks: a bf16 window moves half the f32
    window's bytes, and each equals the cost model's ``window_ppermute``."""
    clock = tclocks.PoissonClock(bidirectional_ring_w(8), rate=0.7, seed=3)
    posts = _tpost(*_posts(8))
    moved = {}
    for wire in ("f32", "bf16", "f16"):
        for r in range(3):
            win = clock.window(r)
            topt.reset_rotation_counts()
            topt.consensus_ppermute_window(posts, win, _mesh(4), wire_dtype=wire)
            got = topt.rotation_counts()
            n_off = len(topt.window_shard_offsets(win, 4))
            model = gossip_window_roofline(8, P, int(win.participating().sum()), n_shards=4,
                                           n_cross_offsets=n_off, wire_dtype=wire)
            assert got["rotations"] == n_off and got["copies"] == 2 * 4 * n_off
            assert got["bytes"] == model["ici_bytes"]["window_ppermute"]
            moved[wire, r] = got["bytes"]
    assert any(moved["f32", r] for r in range(3))
    assert all(moved["bf16", r] * 2 == moved["f32", r] == moved["f16", r] * 2
               for r in range(3))


# -- the shard kernels' plain versions ----------------------------------------


@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,shards", [(8, 4), (9, 3), (40, 5)])
def test_shard_plain_versions_are_masked_plain_rows_bitwise(n, shards, wire):
    """Encode each shard into a full statistics buffer, reduce each shard's
    rows: the rows are bitwise ``consensus_masked_plain``'s (N = 8, 9, 40;
    the kernels' small and generic instances' sizes)."""
    rng = np.random.default_rng(n)
    W = torch.from_numpy(rng.random((n, n)).astype(np.float32) + 0.05)
    W = W / W.sum(dim=1, keepdim=True)
    mean, rho = (torch.from_numpy(a) for a in _posts(n, p=257, seed=n))
    active = torch.arange(n) % 3 != 1
    want = tk.consensus_masked_plain(W, active, mean, rho, wire)
    per = n // shards
    wd = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[wire]
    stats = torch.zeros((2, n, 257), dtype=wd)
    for s in range(shards):
        rows = slice(s * per, (s + 1) * per)
        tk.consensus_shard_encode(mean[rows], rho[rows], stats[0], stats[1], row0=s * per)
    for s in range(shards):
        rows = slice(s * per, (s + 1) * per)
        got = tk.consensus_fused_shard(W[rows], active[rows], stats[0], stats[1], mean[rows],
                                       rho[rows], row0=s * per)
        assert torch.equal(got[0], want[0][rows]) and torch.equal(got[1], want[1][rows])


def test_shard_wrappers_reject_what_the_kernel_does_not_take():
    mean, rho = (torch.from_numpy(a) for a in _posts(4, p=8))
    stats = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="outside"):
        tk.consensus_shard_encode(mean[:2], rho[:2], stats[0], stats[1], row0=3)
    with pytest.raises(ValueError, match="prec_x"):
        tk.consensus_shard_encode(mean, rho, stats[0, :, :4], stats[1, :, :4])
    with pytest.raises(ValueError, match="W_rows"):
        tk.consensus_fused_shard(torch.ones(2, 3), None, stats[0], stats[1], mean[:2], rho[:2])


# -- the hazards the reference's sharded semantics carry -----------------------


def test_non_finite_payload_of_an_unrotated_shard_reaches_no_row():
    """The reference zero-fills the rows of shards that were not rotated: a
    NaN payload there does not reach a row under the strict policy, where
    the masked window's 0 * NaN does.  The port keeps the sharded
    semantics."""
    W = bidirectional_ring_w(8)
    win = tclocks.window_from_events(W, [(0, 1), (3, 4)], e_max=4)  # agent 3 hears 4: offset 1
    assert topt.window_shard_offsets(win, 4) == (3,)  # shard 2 -> shard 1 only
    mean, rho = _posts(8)
    mean[6] = np.nan  # shard 3's payload: rotated nowhere
    posts = _tpost(mean, rho)
    masked = tflat.consensus_flat_masked(posts, win.w_eff, win.active)
    sharded = topt.consensus_ppermute_window(posts, win, _mesh(4))
    merging = np.flatnonzero(win.active)
    assert list(merging) == [0, 3]
    assert torch.isnan(masked.mean[merging]).all()  # 0 * NaN in every merging row
    assert torch.isfinite(sharded.mean[merging]).all()
    idle = ~torch.from_numpy(win.active)
    assert torch.equal(sharded.mean[idle].view(torch.int32), posts.mean[idle].view(torch.int32))
    mean[4] = np.nan  # shard 2's payload is rotated to shard 1: it reaches agent 3
    sharded = topt.consensus_ppermute_window(_tpost(mean, rho), win, _mesh(4))
    assert torch.isnan(sharded.mean[3]).all() and torch.isfinite(sharded.mean[0]).all()


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_quarantined_sharded_window(shards):
    """tests/test_faults.py:538 in the port: with every payload valid the
    quarantined sharded window is the strict one bitwise; with agent 3's
    payload poisoned it is finite and bitwise the dense quarantined merge."""
    clock = tclocks.PoissonClock(bidirectional_ring_w(8), rate=0.7, seed=2)
    mean, rho = _posts(8, p=192, seed=0)
    posts = _tpost(mean, rho)
    kw = dict(mode="ppermute", mesh=_mesh(shards))
    for r in range(3):
        win = clock.window(r)
        strict = tflat.consensus_flat_masked(posts, win.w_eff, win.active, window=win, **kw)
        got, valid = tflat.consensus_flat_masked_quarantined(posts, win.w_eff, win.active,
                                                             window=win, **kw)
        assert bool(valid.all()) and _bitwise(got, strict)
        mean_src = posts.mean.clone()
        mean_src[3] = float("nan")
        gq, vq = tflat.consensus_flat_masked_quarantined(
            posts, win.w_eff, win.active, mean_src=mean_src, rho_src=posts.rho, window=win, **kw)
        dq, vd = tflat.consensus_flat_masked_quarantined(
            posts, win.w_eff, win.active, mean_src=mean_src, rho_src=posts.rho)
        assert torch.equal(vq, vd) and not bool(vq[3])
        assert torch.isfinite(gq.mean).all() and _bitwise(gq, dq)


def test_sharded_calls_refuse_what_they_cannot_run():
    W = bidirectional_ring_w(8)
    win = tclocks.PoissonClock(W, rate=0.7, seed=3).window(0)
    posts = _tpost(*_posts(8))
    with pytest.raises(ValueError, match="divide evenly"):
        topt.consensus_ppermute_window(posts, win, _mesh(3))
    delayed = tclocks.DelayedClock(tclocks.PoissonClock(W, rate=1.0, seed=0),
                                   {"kind": "constant", "delay": 1})
    late = next(w for w in (delayed.window(r) for r in range(4)) if w.max_lag > 0)
    with pytest.raises(ValueError, match="instant delivery"):
        topt.consensus_ppermute_window(posts, late, _mesh(2))
    with pytest.raises(ValueError, match="mesh= and window="):
        tflat.consensus_flat_masked(posts, win.w_eff, win.active, mode="ppermute")
    with pytest.raises(ValueError, match="axis"):
        topt.consensus_ppermute_window(posts, win, _mesh(2), "pod")


# -- the mesh --------------------------------------------------------------------


def test_agent_mesh_and_local_devices():
    assert local_devices("cpu") == [CPU]
    mesh = agent_mesh([CPU] * 8, 4)
    assert mesh.shape == {"agents": 4} and mesh.n_shards == 4 and mesh.n_cards == 1
    assert mesh.devices == (CPU,) * 4
    with pytest.raises(ValueError):
        agent_mesh([CPU], 2)
    with pytest.raises(ValueError):
        AgentMesh(())


# -- ring and einsum forms vs JAX -------------------------------------------------


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_ring_and_einsum_forms_match_jax_einsum(wire):
    """tests/test_distributed.py:60 in the port: the ring forms on the ring
    W, and the einsum forms, against JAX's ``consensus_einsum_flat`` /
    ``consensus_einsum``: f32 within 1e-5, bf16 within 2e-2."""
    tol = 1e-5 if wire == "f32" else 2e-2
    n = 8
    mean, rho = _posts(n, p=2048, seed=1, scale=0.3)
    W = bidirectional_ring_w(n).astype(np.float32)
    jdt = jnp.float32 if wire == "f32" else jnp.bfloat16
    ref = jopt.consensus_einsum_flat(_jpost(mean, rho), jnp.asarray(W), wire_dtype=jdt)
    tposts = _tpost(mean, rho)
    forms = {
        "ring_flat_W": topt.consensus_ppermute_ring_flat(tposts, _mesh(n), "agents",
                                                         wire_dtype=wire, W=W),
        "ring_flat": topt.consensus_ppermute_ring_flat(tposts, _mesh(n), wire_dtype=wire),
        "einsum_flat": topt.consensus_einsum_flat(tposts, torch.from_numpy(W), wire_dtype=wire),
    }
    for name, out in forms.items():
        np.testing.assert_allclose(out.mean.numpy(), np.asarray(ref.mean), rtol=tol, atol=tol,
                                   err_msg=name)
        np.testing.assert_allclose(out.rho.numpy(), np.asarray(ref.rho), rtol=tol, atol=tol,
                                   err_msg=name)
    # the pytree forms: a two-leaf dict
    tree_t = GaussianPosterior(mean={"a": torch.from_numpy(mean[:, :48].reshape(n, 6, 8)),
                                     "b": torch.from_numpy(mean[:, 48:].copy())},
                               rho={"a": torch.from_numpy(rho[:, :48].reshape(n, 6, 8)),
                                    "b": torch.from_numpy(rho[:, 48:].copy())})
    tree_j = JGaussian(mean={"a": jnp.asarray(mean[:, :48].reshape(n, 6, 8)),
                             "b": jnp.asarray(mean[:, 48:])},
                       rho={"a": jnp.asarray(rho[:, :48].reshape(n, 6, 8)),
                            "b": jnp.asarray(rho[:, 48:])})
    jref = jopt.consensus_einsum(tree_j, jnp.asarray(W), wire_dtype=jdt)
    for out in (topt.consensus_einsum(tree_t, torch.from_numpy(W), wire_dtype=wire),
                topt.consensus_ppermute_ring(tree_t, _mesh(n), wire_dtype=wire)):
        for k in ("a", "b"):
            np.testing.assert_allclose(out.mean[k].numpy(), np.asarray(jref.mean[k]),
                                       rtol=tol, atol=tol)
            np.testing.assert_allclose(out.rho[k].numpy(), np.asarray(jref.rho[k]),
                                       rtol=tol, atol=tol)


def test_ring_flat_with_two_shards_mixes_one_direction():
    """For 2 shards both ring directions are one neighbour: with ``W`` the
    forward one mixes alone, as the reference's ``Wd[i, (i + 1) % n]`` is 0."""
    mean, rho = _posts(2, p=64, seed=4, scale=0.3)
    W = np.asarray([[0.6, 0.4], [0.25, 0.75]], np.float32)
    out = topt.consensus_ppermute_ring_flat(_tpost(mean, rho), _mesh(2), W=W)
    ref = tflat.consensus_flat(_tpost(mean, rho), torch.from_numpy(W))
    np.testing.assert_allclose(out.mean.numpy(), ref.mean.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.rho.numpy(), ref.rho.numpy(), rtol=1e-5, atol=1e-5)


# -- the engine --------------------------------------------------------------------


def _spec(impl="ppermute", clock=None, n=8, **inf):
    clock = clock or {"kind": "poisson", "rate": 0.7, "seed": 3}
    return tspec.ExperimentSpec(
        topology=tspec.TopologySpec.gossip("bidirectional_ring", {"n": n}, clock=clock),
        data=tspec.DataSpec(dataset_params=dict(n_classes=3, dim=8, n_train_per_class=30),
                            partition="iid", partition_params=dict(n_agents=n), batch_size=4,
                            local_updates=2),
        inference=tspec.InferenceSpec(hidden=8, depth=1, lr=1e-2, consensus_impl=impl, **inf),
        run=tspec.RunSpec(n_rounds=3, seed=0),
    )


def _session(spec, shards=8):
    return tbuild(spec, device="cpu", devices=[CPU] * shards)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_engine_sharded_session_is_masked_bitwise(wire):
    """tests/test_gossip.py:1052 and tests/test_wire_dtype.py:634 in the
    port: 8 virtual shards, the whole trajectory bitwise the masked one."""
    m = _session(_spec("masked", wire_dtype=wire))
    s = _session(_spec(wire_dtype=wire))
    m.run()
    s.run()
    assert s.engine.n_shards == 8 and s.engine.mesh.n_shards == 8
    assert s.engine.n_traces == 1
    assert _bitwise(s.posterior(), m.posterior())
    assert torch.equal(s.state.n_merges, m.state.n_merges)
    tel = s.evaluate()["engine"]
    assert tel["consensus_shards"] == 8
    assert tel.get("wire_dtype", "f32") == wire


def test_engine_sharded_quarantine_zero_fault_and_chaos():
    """tests/test_faults.py:594 in the port: the zero-fault quarantined
    sharded session is the strict one bitwise; under chaos it stays
    finite and healthy."""
    posts = {}
    for policy in ("strict", "quarantine"):
        s = _session(_spec(fault_policy=policy))
        for _ in range(3):
            s.round()
        posts[policy] = s.posterior()
    assert _bitwise(posts["strict"], posts["quarantine"])
    chaos = {"kind": "poisson", "rate": 0.7, "seed": 3,
             "faults": {"crash_rate": 0.25, "recover_rate": 0.5, "corrupt_rate": 0.3,
                        "seed": 7}}
    s = _session(_spec(clock=chaos, fault_policy="quarantine"), shards=4)
    for _ in range(4):
        s.round()
    assert s.health()["all_ok"], s.health()
    assert torch.isfinite(s.posterior().mean).all()
    tel = s.evaluate(n_mc=1)["engine"]
    assert tel["faults"]["quarantined"]["total"] >= 0 and tel["consensus_shards"] == 4


def test_engine_sharded_chaos_quarantine_is_masked_bitwise():
    """Under chaos with quarantine every sanitised payload is finite, so the
    sharded session is the masked one bitwise, quarantine counts too."""
    chaos = {"kind": "failure_injected", "inner": {"kind": "poisson", "rate": 0.8, "seed": 0},
             "drop_rate": 0.1, "faults": {"crash_rate": 0.15, "recover_rate": 0.5,
                                           "corrupt_rate": 0.2, "corrupt_kind": "mix",
                                           "seed": 7}}
    m = _session(_spec("masked", clock=chaos, fault_policy="quarantine"))
    s = _session(_spec(clock=chaos, fault_policy="quarantine"), shards=4)
    m.run(n_rounds=4)
    s.run(n_rounds=4)
    assert _bitwise(s.posterior(), m.posterior())
    assert torch.equal(s.state.n_quarantined, m.state.n_quarantined)
    assert int(s.state.n_quarantined.sum()) > 0


def test_engine_sharded_observability_on_is_off_bitwise():
    """Observability on == off on the sharded path; each window is a
    ``gossip.local_phase`` and a ``gossip.consensus`` span."""
    spec = _spec()
    on = _session(dataclasses.replace(spec, obs=tspec.ObsSpec(enabled=True)))
    off = _session(spec)
    on.run()
    off.run()
    assert _bitwise(on.posterior(), off.posterior())
    spans = [(sp.name, sp.attrs.get("impl")) for sp in on.obs.tracer.spans
             if sp.name.startswith("gossip.") and sp.name != "gossip.window_build"]
    assert spans == [("gossip.local_phase", "ppermute"), ("gossip.consensus", "ppermute")] * 3
    assert on.obs.registry.counter("gossip.windows").value() == 3


def test_engine_sharded_active_mask_survives_subresolution_weight():
    """The host-exact window mask reaches the sharded window: a fired
    in-edge of weight 1e-8 (1.0 - w rounds to 1.0 in f32) still merges."""
    eps = 1e-8
    W = np.array([[1.0 - eps, eps], [0.4, 0.6]])
    assert np.float32(W[0, 0]) == np.float32(1.0)
    spec = tspec.ExperimentSpec(
        topology=tspec.TopologySpec.gossip(
            "explicit", w=W, clock={"kind": "trace", "trace": [[[0, 1]], [[1, 0]]]}),
        data=tspec.DataSpec(dataset_params=dict(n_classes=2, dim=8, n_train_per_class=30),
                            partition="iid", partition_params=dict(n_agents=2), batch_size=4,
                            local_updates=2),
        inference=tspec.InferenceSpec(hidden=8, depth=1, lr=1e-2, consensus_impl="ppermute"),
        run=tspec.RunSpec(n_rounds=1, seed=0),
    )
    s = _session(spec, shards=2)
    s.round()
    assert s.engine.n_shards == 2
    assert s.state.n_merges.tolist() == [1, 0]
    assert s.state.last_merge.tolist() == [0, -1]


def test_spec_and_build_checks_raise_as_the_reference():
    """tests/test_gossip.py:1092 in the port."""
    _spec(n=4).validate()
    with pytest.raises(ValueError, match="gossip"):
        tspec.ExperimentSpec(topology=tspec.TopologySpec.complete(4), data=_spec(n=4).data,
                             inference=tspec.InferenceSpec(consensus_impl="ppermute")).validate()
    with pytest.raises(ValueError, match="ppermute"):
        _spec(n=4, consensus="mean_only").validate()
    with pytest.raises(ValueError, match="consensus_shards"):
        tspec.InferenceSpec(consensus_shards=4).validate()
    tspec.InferenceSpec(consensus_impl="ppermute", consensus_shards=4).validate()
    delayed = {"kind": "delayed", "inner": {"kind": "poisson", "rate": 1.0},
               "latency": {"kind": "constant", "delay": 1}}
    with pytest.raises(ValueError, match="instant delivery"):
        tbuild(_spec(clock=delayed, n=4), device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        _session(_spec(n=8, consensus_shards=4), shards=2)
    with pytest.raises(ValueError, match="must divide"):
        _session(_spec(n=8, consensus_shards=3), shards=4)
    # the default: the largest shard count that divides N, at most one a device
    assert _session(_spec(n=8), shards=6).engine.n_shards == 4
    assert tbuild(_spec(n=8), device="cpu").engine.n_shards == 1
    sparse = tspec.ExperimentSpec(
        topology=tspec.TopologySpec.sparse("watts_strogatz", n=8, k=4, beta=0.2,
                                           clock={"kind": "poisson", "rate": 0.5}),
        data=_spec(n=8).data, inference=tspec.InferenceSpec(consensus_impl="ppermute"))
    with pytest.raises(ValueError, match="SparseWindows"):
        tbuild(sparse, device="cpu")


def test_engine_sharded_refuses_a_foreign_window():
    """The rotation schedule is the spec clock's window: a W that is not
    that window's is refused, as on the delayed path."""
    s = _session(_spec(), shards=4)
    with pytest.raises(ValueError, match="sharded gossip windows come from the spec clock"):
        s.round(W=bidirectional_ring_w(8))
