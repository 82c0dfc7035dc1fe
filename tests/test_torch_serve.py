"""The serving tier of repro_torch (``repro_torch.serve``,
``Session.snapshot/attach_server``, ``checkpoint.io.save_snapshot``) on the
CPU: each contract of tests/test_serve.py on the port (all but
``serve_roofline``'s modeled bytes, which come with the cost model), and
the port against the JAX package:

* the apply program against the reference's (``serve/server.py:145
  _apply_for``) and whole ragged streams against the reference server, on
  JAX's own noise (``normal`` over ``split(fold_in(key(seed), counter),
  mc)``, fed through the server's ``noise_fn`` seam): f32 and bf16
  residency, mc 0 and 8, atol 1e-5;
* ``snapshot_meta`` and the telemetry keys equal to JAX's on the same
  gossip state; snapshot checkpoints crossing both packages bitwise, bf16
  by name.

The card's CUDA-graph captures are held in tests/test_torch_serve_cuda.py.
"""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.serve import PosteriorSnapshot as JSnapshot  # noqa: E402
from repro.serve import PredictiveServer as JServer  # noqa: E402
from repro.serve import SnapshotStore as JStore  # noqa: E402
from repro_torch.core.flat import FlatPosterior  # noqa: E402
from repro_torch.gossip import gossip_state_from_numpy  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    PosteriorSnapshot,
    PredictiveServer,
    SnapshotStore,
    StalenessSLOError,
)
from repro_torch.vi.bayes_by_backprop import mc_predict  # noqa: E402

N_AGENTS = 3


def _tiny_spec(mod, n_rounds=3, seed=0, serve=None, gossip=True, engine="simulated"):
    """tests/test_serve.py:42's spec: a 3-agent gossip ring or a synchronous
    star, dim-8 3-class data."""
    if gossip:
        topo = mod.TopologySpec.gossip("ring", {"n": N_AGENTS})
        data = mod.DataSpec(dataset_params=dict(n_classes=3, dim=8, n_train_per_class=30),
                            partition_params=dict(n_agents=N_AGENTS), batch_size=4,
                            local_updates=2)
    else:
        topo = mod.TopologySpec.star(n_edge=2, a=0.5)
        data = mod.DataSpec(dataset_params=dict(n_classes=3, dim=8, n_train_per_class=30),
                            partition="star",
                            partition_params=dict(center_labels=[1, 2], edge_labels=[0],
                                                  n_edge=2),
                            batch_size=4, local_updates=2)
    return mod.ExperimentSpec(
        topology=topo, data=data,
        inference=mod.InferenceSpec(hidden=8, depth=1, lr=1e-2),
        run=mod.RunSpec(n_rounds=n_rounds, seed=seed, engine=engine),
        serve=serve or mod.ServeSpec(),
    )


def _build(**kw):
    return tapi.build_session(_tiny_spec(tapi, **kw), device="cpu")


def _x(sess, n=None):
    x = sess.data.x_test.cpu().numpy()
    return x if n is None else x[:n]


@pytest.fixture(scope="module")
def trained():
    sess = _build()
    sess.run()
    return sess


# -- snapshot isolation ---------------------------------------------------------


def test_snapshot_bit_stable_under_training():
    sess = _build()
    sess.run()
    snap = sess.snapshot()
    mean0, rho0 = snap.posterior.mean.clone(), snap.posterior.rho.clone()
    server = sess.attach_server(mc_samples=0, bucket_sizes=(4,))
    x = _x(sess, 4)
    probs0 = server.query(x, agent=0)[0].clone()
    sess.run(n_rounds=3)  # trains on; the published snapshot must not move
    assert not torch.equal(sess.posterior().mean, mean0)
    assert torch.equal(snap.posterior.mean, mean0) and torch.equal(snap.posterior.rho, rho0)
    assert torch.equal(server.query(x, agent=0)[0], probs0)


@pytest.mark.parametrize("engine", ["simulated", "launch"])
def test_training_bitwise_identical_with_serving_attached(engine):
    """Snapshots published and queries served between rounds leave the
    trajectory and the session generator bitwise as they were."""
    gossip = engine == "simulated"
    plain = _build(n_rounds=0, gossip=gossip, engine=engine)
    served = _build(n_rounds=0, gossip=gossip, engine=engine)
    server = None
    x = _x(served, 3)
    for r in range(4):
        plain.round()
        served.round()
        served.snapshot(dtype="bf16" if r % 2 else "f32")
        if server is None:
            server = served.attach_server(mc_samples=2, bucket_sizes=(2, 4))
        server.query(x, agent=r % N_AGENTS)
    p, s = plain.posterior(), served.posterior()
    assert torch.equal(p.mean, s.mean) and torch.equal(p.rho, s.rho)
    assert torch.equal(plain.generator.get_state(), served.generator.get_state())


def test_double_buffer_swap_keeps_old_reader():
    sess = _build()
    sess.run()
    old = sess.snapshot()
    sess.run(n_rounds=2)
    new = sess.snapshot()
    assert new.version == old.version + 1
    assert sess.serve_store.current() is new
    assert old.window != new.window
    assert not torch.equal(old.posterior.mean, new.posterior.mean)


def test_snapshot_shares_no_storage_and_astype_is_structural(trained):
    live = trained.posterior()
    for dt in ("f32", "bf16"):
        snap = trained.snapshot(dtype=dt)
        for a, b in ((snap.posterior.mean, live.mean), (snap.posterior.rho, live.rho)):
            assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    assert live.astype(torch.float32) is live
    f32 = trained.snapshot(dtype="f32")
    assert f32.decode() is f32.posterior
    wide = trained.snapshot(dtype="bf16").decode()
    assert wide.mean.dtype == torch.float32 and wide.layout is live.layout


# -- bf16 residency --------------------------------------------------------------


def test_bf16_snapshot_halves_live_bytes(trained):
    s32 = trained.snapshot(dtype="f32")
    s16 = trained.snapshot(dtype="bf16")
    assert s32.nbytes() == 2 * s16.nbytes()
    assert s16.posterior.mean.dtype == torch.bfloat16
    assert s32.nbytes() == 2 * N_AGENTS * s32.posterior.mean.shape[1] * 4


def test_bf16_snapshot_serves_close_to_f32(trained):
    x = _x(trained, 6)
    trained.snapshot(dtype="f32")
    server = trained.attach_server(mc_samples=0, bucket_sizes=(8,))
    p32, _ = server.query(x, agent=0)
    trained.snapshot(dtype="bf16")
    p16, _ = server.query(x, agent=0)
    np.testing.assert_allclose(p32.numpy(), p16.numpy(), atol=5e-2)
    np.testing.assert_allclose(p16.sum(-1).numpy(), 1.0, atol=1e-3)


def test_f32_snapshot_is_identity_dtype(trained):
    snap = trained.snapshot(dtype="f32")
    assert snap.dtype == "f32" and snap.posterior.mean.dtype == torch.float32
    assert torch.equal(snap.posterior.mean, trained.posterior().mean)


# -- staleness SLO ---------------------------------------------------------------


def test_staleness_slo_strict_refuses():
    sess = _build(serve=tapi.ServeSpec(max_staleness=2, staleness_policy="strict",
                                       mc_samples=1))
    sess.run()
    sess.snapshot()
    server = sess.attach_server()
    x = _x(sess, 2)
    _, meta = server.query(x)
    assert meta["slo_ok"] and meta["snapshot_age"] == 0
    sess.run(n_rounds=2)
    _, meta = server.query(x)
    assert meta["slo_ok"] and meta["snapshot_age"] == 2
    sess.run(n_rounds=1)
    with pytest.raises(StalenessSLOError, match="3 windows stale"):
        server.query(x)
    assert server.n_slo_breaches == 1
    sess.snapshot()
    _, meta = server.query(x)
    assert meta["slo_ok"] and meta["snapshot_age"] == 0


def test_staleness_slo_flag_serves_marked():
    sess = _build(serve=tapi.ServeSpec(max_staleness=1, staleness_policy="flag",
                                       mc_samples=1))
    sess.run()
    sess.snapshot()
    server = sess.attach_server()
    sess.run(n_rounds=3)
    probs, meta = server.query(_x(sess, 2))
    assert not meta["slo_ok"] and meta["snapshot_age"] == 3
    assert server.n_slo_breaches == 1
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)


def test_unbounded_slo_never_breaches(trained):
    trained.snapshot()
    server = trained.attach_server(max_staleness=None, mc_samples=0, bucket_sizes=(4,))
    ok, _ = server.check_slo()
    assert ok and server.n_slo_breaches == 0


def test_query_before_publish_raises():
    server = _build(n_rounds=0).attach_server()
    with pytest.raises(RuntimeError, match="no snapshot published"):
        server.query(np.zeros((2, 8), np.float32))


# -- padding buckets and the compiled-once programs ------------------------------


def test_bucket_trace_count_pinned(trained):
    trained.snapshot(dtype="f32")
    server = trained.attach_server(mc_samples=2, bucket_sizes=(2, 4, 8))
    x = _x(trained)
    stream = [x[: n % 9 + 1] for n in range(17)]  # sizes 1..9, ragged
    for rows in stream:
        server.query(rows, agent=0)
    assert server.n_traces == 3  # buckets {2, 4, 8}
    before = server.n_traces
    trained.snapshot(dtype="f32")  # republish: the same programs
    for rows in stream:
        server.query(rows, agent=1)  # another agent's row: the same programs
    assert server.n_traces == before
    server.query(x[:5], agent=0, mc_samples=5)  # a new mc: a new key
    assert server.n_traces == before + 1


def test_bucket_plan_shapes(trained):
    trained.snapshot()
    server = trained.attach_server(bucket_sizes=(2, 4, 8))
    assert server._bucket_plan(0) == []
    assert server._bucket_plan(1) == [2]
    assert server._bucket_plan(8) == [8]
    assert server._bucket_plan(9) == [8, 2]
    assert server._bucket_plan(21) == [8, 8, 8]


def test_request_reassembly_matches_unbatched(trained):
    trained.snapshot(dtype="f32")
    server = trained.attach_server(mc_samples=0, bucket_sizes=(2, 4))
    x = _x(trained)
    reqs = [x[:3], x[3:4], x[4:9]]
    outs, _ = server.serve(reqs, agents=[0, 1, 0])
    for r, out in zip(reqs, outs):
        assert tuple(out.shape) == (r.shape[0], 3)
    solo0, _ = server.query(reqs[0], agent=0)
    np.testing.assert_allclose(outs[0].numpy(), solo0.numpy(), rtol=1e-6, atol=1e-7)
    solo1, _ = server.query(reqs[1], agent=1)
    np.testing.assert_allclose(outs[1].numpy(), solo1.numpy(), rtol=1e-6, atol=1e-7)
    assert server.n_padded_rows == 0 + 1 + 1 + 1  # 8 rows -> 4,4; 1 -> 2; 3 -> 4; 1 -> 2


def test_point_estimate_matches_session_predictive(trained):
    trained.snapshot(dtype="f32")
    server = trained.attach_server(mc_samples=0, bucket_sizes=(8,))
    x = _x(trained, 6)
    for agent in range(N_AGENTS):
        served, _ = server.query(x, agent=agent)
        direct = trained.predictive(agent, x, n_mc=0)
        np.testing.assert_allclose(served.numpy(), direct.numpy(), rtol=1e-6, atol=1e-7)


def test_served_probabilities_are_mc_predict_on_the_same_noise(trained):
    snap = trained.snapshot(dtype="f32")
    p = snap.posterior.n_params()
    noise = {}

    def noise_fn(counter, mc, n_params):
        g = torch.Generator().manual_seed(1000 + counter)
        noise[counter] = torch.randn((mc, n_params), generator=g)
        return noise[counter]

    server = trained.attach_server(mc_samples=8, bucket_sizes=(4, 8), noise_fn=noise_fn)
    x = _x(trained, 7)
    got, _ = server.query(x, agent=2)
    post = trained.agent_posterior(2)
    want = mc_predict(post, trained.model.logits_fn, torch.from_numpy(x), eps=noise[0])[0]
    assert noise[0].shape == (8, p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_seeded_servers_sample_alike_and_slabs_draw_afresh(trained):
    trained.snapshot(dtype="f32")
    x = _x(trained, 3)
    a = trained.attach_server(mc_samples=4, bucket_sizes=(4,), seed=5)
    b = trained.attach_server(mc_samples=4, bucket_sizes=(4,), seed=5)
    first, second = a.query(x)[0], a.query(x)[0]
    assert torch.equal(first, b.query(x)[0])
    assert not torch.equal(first, second)


def test_bad_requests_rejected(trained):
    trained.snapshot()
    server = trained.attach_server(bucket_sizes=(4,))
    x = np.zeros((2, 8), np.float32)
    with pytest.raises(ValueError, match="agent 7 out of range"):
        server.query(x, agent=7)
    with pytest.raises(ValueError, match="agent ids"):
        server.serve([x, x], agents=[0])
    with pytest.raises(ValueError, match="wrap single rows"):
        server.serve([np.zeros((8,), np.float32)])
    with pytest.raises(ValueError, match="ascending"):
        trained.attach_server(bucket_sizes=(4, 2))
    with pytest.raises(ValueError, match="staleness_policy"):
        trained.attach_server(staleness_policy="maybe")
    with pytest.raises(ValueError, match="mc_samples"):
        trained.attach_server(mc_samples=-1)


# -- spec plumbing, telemetry, checkpoints ----------------------------------------


def test_serve_spec_validation_and_doc_roundtrip():
    spec = _tiny_spec(tapi, serve=tapi.ServeSpec(
        snapshot_dtype="bf16", mc_samples=4, bucket_sizes=[2, 8], max_staleness=3,
        staleness_policy="flag"))
    spec.validate()
    assert spec.serve.bucket_sizes == (2, 8)
    assert tapi.ExperimentSpec.from_doc(spec.to_doc()).serve == spec.serve
    for bad in (tapi.ServeSpec(snapshot_dtype="f64"), tapi.ServeSpec(mc_samples=-1),
                tapi.ServeSpec(bucket_sizes=()), tapi.ServeSpec(bucket_sizes=(4, 4)),
                tapi.ServeSpec(max_staleness=-2), tapi.ServeSpec(staleness_policy="never")):
        with pytest.raises(ValueError):
            bad.validate()


def test_snapshot_carries_gossip_telemetry(trained):
    snap = trained.snapshot()
    assert snap.telemetry["window"] == trained.round_idx
    assert {"p50", "p90", "max"} <= set(snap.telemetry["staleness"])
    assert snap.telemetry["merges_total"] >= 0


def test_evaluate_exposes_serving_block():
    sess = _build(serve=tapi.ServeSpec(max_staleness=0, staleness_policy="flag",
                                       mc_samples=1))
    sess.run()
    assert "serving" not in sess.evaluate(n_mc=1)
    sess.snapshot()
    assert sess.evaluate(n_mc=1)["serving"]["published"] == 1  # the store alone
    server = sess.attach_server()
    sess.run(n_rounds=1)
    server.query(_x(sess, 2))  # 1 window stale: a breach
    out = sess.evaluate(n_mc=1)
    serving = out["serving"]
    assert serving["slo"]["breaches"] == 1
    assert serving["snapshot_age"] == 1
    assert serving["published"] == 1 and serving["requests"] == 1
    assert "staleness" in out["engine"]


def test_snapshot_checkpoint_roundtrip(tmp_path, trained):
    for dt in ("f32", "bf16"):
        snap = trained.snapshot(dtype=dt)
        path = os.path.join(tmp_path, f"snap_{dt}.ckpt")
        snap.save(path)
        back = PosteriorSnapshot.load(path, device="cpu")
        assert (back.dtype, back.window, back.version) == (dt, snap.window, snap.version)
        assert back.telemetry == snap.telemetry
        assert back.posterior.mean.dtype == snap.posterior.mean.dtype
        assert torch.equal(back.posterior.mean, snap.posterior.mean)
        assert torch.equal(back.posterior.rho, snap.posterior.rho)
        assert back.posterior.layout.to_doc() == snap.posterior.layout.to_doc()
    path = os.path.join(tmp_path, "sess.ckpt")
    trained.save(path)
    with pytest.raises(ValueError, match="not a posterior-snapshot"):
        PosteriorSnapshot.load(path, device="cpu")


def test_store_age_and_version():
    store = SnapshotStore()
    with pytest.raises(RuntimeError, match="no snapshot published"):
        store.current()
    assert store.telemetry() == {"published": 0}
    sess = _build(n_rounds=0)
    sess.round()
    sess.snapshot()
    st = sess.serve_store
    assert st.age() == 0
    sess.round()
    sess.round()
    assert st.age() == 2 and st.age(now=10) == 9
    sess.snapshot()
    assert st.version == 2 and st.age() == 0


@pytest.mark.parametrize("engine", ["simulated", "launch"])
def test_synchronous_engines_serve_too(engine):
    sess = _build(gossip=False, engine=engine)
    sess.run()
    snap = sess.snapshot(dtype="bf16")
    assert snap.telemetry == {}  # no snapshot_meta hook on this engine
    server = sess.attach_server(mc_samples=1, bucket_sizes=(4,))
    probs, meta = server.query(_x(sess, 3), agent=1)
    assert tuple(probs.shape) == (3, 3) and meta["slo_ok"]


def test_conjugate_linreg_has_no_serving_path():
    spec = tapi.ExperimentSpec(
        topology=tapi.TopologySpec.complete(4),
        data=tapi.DataSpec(dataset="linreg", batch_size=10),
        inference=tapi.InferenceSpec(method="conjugate_linreg"),
        run=tapi.RunSpec(n_rounds=1, seed=0),
    )
    sess = tapi.build_session(spec, device="cpu")
    sess.run()
    with pytest.raises(ValueError, match="serves flat"):
        sess.snapshot()
    with pytest.raises(ValueError, match="classification model"):
        sess.attach_server()


# -- against the JAX package -------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """A JAX gossip session after 3 windows and the port session carrying
    its state."""
    js = japi.build_session(_tiny_spec(japi))
    js.run()
    ts = _build(n_rounds=0)
    st, opt = js.state, js.state.opt_state
    ts.state = gossip_state_from_numpy(
        np.asarray(st.posterior.mean), np.asarray(st.posterior.rho),
        layout=ts.posterior().layout,
        mu=(np.asarray(opt.mu.mean), np.asarray(opt.mu.rho)),
        nu=(np.asarray(opt.nu.mean), np.asarray(opt.nu.rho)),
        step=np.asarray(st.step), round=np.asarray(st.round),
        last_merge=np.asarray(st.last_merge), n_merges=np.asarray(st.n_merges),
        device="cpu")
    ts.round_idx = js.round_idx
    return js, ts


def _jax_noise(seed):
    base = jax.random.key(seed)

    def noise_fn(counter, mc, p):
        keys = jax.random.split(jax.random.fold_in(base, counter), mc)
        return np.stack([np.asarray(jax.random.normal(k, (p,), jnp.float32)) for k in keys])

    return noise_fn


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mc", [0, 8])
def test_apply_program_matches_the_reference(pair, dtype, mc):
    js, ts = pair
    jsnap, tsnap = js.snapshot(dtype=dtype), ts.snapshot(dtype=dtype)
    np.testing.assert_array_equal(tsnap.posterior.mean.float().numpy(),
                                  np.asarray(jsnap.posterior.mean.astype(jnp.float32)))
    jserver = JServer(js.serve_store, js.model.logits_fn, mc_samples=mc, bucket_sizes=(8,))
    tserver = PredictiveServer(ts.serve_store, ts.model.logits_fn, mc_samples=mc,
                               bucket_sizes=(8,), noise_fn=_jax_noise(0))
    x = _x(ts, 8)
    for agent in range(N_AGENTS):
        key = jax.random.fold_in(jax.random.key(7), agent)
        want = jserver._apply_for(jsnap.posterior.layout, 8, (8,), mc)(
            jsnap.posterior.mean[agent], jsnap.posterior.rho[agent], jnp.asarray(x), key)
        prog = tserver._program_for(tsnap.posterior, 8, (8,), mc)
        if mc:  # the reference's draws for this key: split(key, mc)
            prog.noise.copy_(torch.from_numpy(np.stack([
                np.asarray(jax.random.normal(k, (tsnap.posterior.n_params(),), jnp.float32))
                for k in jax.random.split(key, mc)])))
        got = prog(torch.from_numpy(x), tsnap.posterior.mean[agent], tsnap.posterior.rho[agent])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert tserver.n_traces == 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mc", [0, 8])
def test_ragged_stream_matches_the_reference_server(pair, dtype, mc):
    js, ts = pair
    js.snapshot(dtype=dtype)
    ts.snapshot(dtype=dtype)
    kw = dict(mc_samples=mc, bucket_sizes=(1, 2, 4, 8), seed=3)
    jserver = JServer(js.serve_store, js.model.logits_fn, **kw)
    tserver = PredictiveServer(ts.serve_store, ts.model.logits_fn, noise_fn=_jax_noise(3), **kw)
    x = _x(ts)
    reqs = [x[:3], x[3:4], x[4:15], x[15:17], x[17:30]]
    agents = [0, 2, 0, 1, 2]
    jout, jmeta = jserver.serve([jnp.asarray(r) for r in reqs], agents=agents)
    tout, tmeta = tserver.serve(reqs, agents=agents)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    assert tserver.n_traces == jserver.n_traces
    assert tserver._batch_counter == jserver._batch_counter
    assert {k: v for k, v in tmeta.items() if k != "latency_us"} == \
        {k: v for k, v in jmeta.items() if k != "latency_us"}
    jt, tt = jserver.telemetry(), tserver.telemetry()
    assert sorted(jt) == sorted(tt)
    assert {k: v for k, v in tt.items() if k != "latency"} == \
        {k: v for k, v in jt.items() if k != "latency"}
    assert sorted(jt["latency"]) == sorted(tt["latency"])


def test_snapshot_meta_and_telemetry_keys_match_jax(pair):
    js, ts = pair
    assert ts.engine.snapshot_meta(ts.state) == js.engine.snapshot_meta(js.state)
    jsnap, tsnap = js.snapshot(), ts.snapshot()
    assert tsnap.telemetry == jsnap.telemetry
    assert ts.serve_store.telemetry() == {**js.serve_store.telemetry(),
                                          "published": ts.serve_store.n_published,
                                          "snapshot_version": tsnap.version}
    assert sorted(ts.serve_store.telemetry()) == sorted(js.serve_store.telemetry())


def test_quarantined_snapshot_meta_matches_jax():
    chaos = {"kind": "failure_injected", "inner": {"kind": "poisson", "rate": 0.8, "seed": 0},
             "drop_rate": 0.1, "faults": {"crash_rate": 0.15, "recover_rate": 0.5,
                                          "corrupt_rate": 0.2, "corrupt_kind": "mix", "seed": 7}}

    def spec(mod):
        s = _tiny_spec(mod)
        return mod.ExperimentSpec(
            topology=mod.TopologySpec.gossip("ring", {"n": N_AGENTS}, clock=chaos),
            data=s.data, inference=mod.InferenceSpec(hidden=8, depth=1, lr=1e-2,
                                                     fault_policy="quarantine"),
            run=s.run)
    js = japi.build_session(spec(japi))
    js.run()
    ts = tapi.build_session(spec(tapi), device="cpu")
    st = js.state
    ts.state = gossip_state_from_numpy(
        np.asarray(st.posterior.mean), np.asarray(st.posterior.rho),
        layout=ts.posterior().layout, step=np.asarray(st.step), round=np.asarray(st.round),
        last_merge=np.asarray(st.last_merge), n_merges=np.asarray(st.n_merges),
        n_quarantined=np.asarray(st.n_quarantined), device="cpu")
    meta = ts.engine.snapshot_meta(ts.state)
    assert meta == js.engine.snapshot_meta(js.state)
    assert "quarantined_total" in meta


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_snapshot_checkpoints_cross_both_packages(tmp_path, pair, dtype):
    js, ts = pair
    jsnap, tsnap = js.snapshot(dtype=dtype), ts.snapshot(dtype=dtype)
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jsnap.save(jpath)
    tsnap.save(tpath)
    in_port = PosteriorSnapshot.load(jpath, device="cpu")
    in_jax = JSnapshot.load(tpath)
    for port_side, jax_side in ((in_port, jsnap), (tsnap, in_jax)):
        assert port_side.dtype == jax_side.dtype == dtype
        assert port_side.window == jax_side.window and port_side.telemetry == jax_side.telemetry
        assert str(port_side.posterior.mean.dtype).removeprefix("torch.") == \
            ("float32" if dtype == "f32" else "bfloat16") == jnp.dtype(jax_side.posterior.mean.dtype).name
        for f in ("mean", "rho"):
            np.testing.assert_array_equal(
                getattr(port_side.posterior, f).float().numpy(),
                np.asarray(getattr(jax_side.posterior, f).astype(jnp.float32)))


def test_store_without_a_clock_reports_no_age():
    post = FlatPosterior(torch.zeros((2, 3)), torch.zeros((2, 3)), None)
    store = SnapshotStore()
    snap = store.publish(post, window=4, dtype="bf16")
    assert "snapshot_age" not in store.telemetry() and store.age(now=6) == 2
    assert snap.nbytes() == 2 * 2 * 3 * 2
    jstore = JStore()
    assert sorted(jstore.telemetry()) == sorted(SnapshotStore().telemetry())
