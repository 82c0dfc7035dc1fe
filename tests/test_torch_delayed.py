"""Delayed delivery in repro_torch (the ``[K, N, P]`` history ring,
``core.flat.consensus_flat_delayed(_quarantined)``, the ``GossipEngine``'s
delayed windows) against the JAX package on the CPU, and the reference's
own bitwise rungs inside the port.

Inputs come from numpy seeds; the engine comparisons replay the JAX
session's key chain and inject its batch indices and BbB noise through the
port's seams (tests/test_torch_gossip.py).  Tolerance atol 1e-5 (rtol
1e-5): fp32 summation order, the port's stated tolerance for eq. (6).
The bitwise rungs hold inside the port only, never across the packages.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as japi  # noqa: E402
import repro.core.flat as jflat  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.core.flat as tflat  # noqa: E402
from repro.api import data as jdata  # noqa: E402
from repro_torch.core.numerics import softplus, softplus_inv  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.gossip import gossip_state_from_numpy  # noqa: E402

WIRES = ("f32", "bf16", "f16")
RINGS = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
         "f16": (jnp.float16, torch.float16)}
FAULTS = {"crash_rate": 0.15, "recover_rate": 0.5, "corrupt_rate": 0.3, "corrupt_kind": "mix",
          "seed": 7}
GEOMETRIC = {"kind": "geometric", "p": 0.5, "max": 3}


def _jax_to_torch(a, dtype=torch.float32):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    return torch.from_numpy(a.copy()).to(dtype)


def _bits(t):
    return t.reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)


# -- the flat functions against JAX ---------------------------------------------


def _flat_case(seed, n=6, p=37, k=4, n_pad=3):
    """A delayed window: events with lags up to K - 1, zero-weight (0, 0)
    pads at the end, an inactive row, a [K, N, P] ring."""
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(n, p)).astype(np.float32)
    rho = rng.uniform(-4.0, 0.5, (n, p)).astype(np.float32)
    hm = rng.normal(size=(k, n, p)).astype(np.float32)
    hr = rng.uniform(-4.0, 0.5, (k, n, p)).astype(np.float32)
    edges = [(1, 0), (2, 3), (1, 4), (0, 2), (4, 5), (2, 1), (0, 5)]
    weights = rng.uniform(0.05, 0.2, len(edges)).astype(np.float32)
    lags = rng.integers(0, k, len(edges)).astype(np.int32)
    edges = np.array(edges + [(0, 0)] * n_pad, np.int32)
    weights = np.concatenate([weights, np.zeros(n_pad, np.float32)])
    lags = np.concatenate([lags, np.zeros(n_pad, np.int32)])
    W = np.eye(n)
    for (i, j), w in zip(edges, weights):
        if i != j:
            W[i, j] = w
    for i in range(n):
        W[i, i] = 1.0 - (W[i].sum() - W[i, i])
    active = np.ones(n, bool)
    active[3] = False
    return dict(mean=mean, rho=rho, hm=hm, hr=hr, W=W, edges=edges, weights=weights,
                lags=lags, active=active, round=k + 2)


def _posts(c):
    jp = jflat.FlatPosterior(mean=jnp.asarray(c["mean"]), rho=jnp.asarray(c["rho"]), layout=None)
    tp = tflat.FlatPosterior(mean=torch.from_numpy(c["mean"]), rho=torch.from_numpy(c["rho"]),
                             layout=None)
    return jp, tp


def _rings(c, ring):
    jd, td = RINGS[ring]
    jh = (jnp.asarray(c["hm"]).astype(jd), jnp.asarray(c["hr"]).astype(jd))
    return jh, tuple(_jax_to_torch(x, td) for x in jh)


def _jargs(c):
    return (jnp.asarray(c["W"], jnp.float32), jnp.asarray(c["active"]), jnp.asarray(c["edges"]),
            jnp.asarray(c["weights"]), jnp.asarray(c["lags"]))


def _targs(c):
    return c["W"], c["active"], c["edges"], c["weights"], c["lags"]


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


# corrupted senders: 2 NaN, 4 huge (both invalid), 5 a finite fill (valid: merged)
CORRUPT = np.array([False, False, True, False, True, True])
FILL_MEAN = np.array([0, 0, np.nan, 0, 1e30, 0.25], np.float32)
FILL_RHO = np.array([0, 0, np.nan, 0, 0, -1.0], np.float32)


@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("fn", ["delayed", "quarantined", "corrupted"])
def test_delayed_flat_functions_match_jax(fn, wire, ring):
    c = _flat_case(seed=len(wire) + 3 * len(ring))
    jp, tp = _posts(c)
    jh, th = _rings(c, ring)
    r = c["round"]
    if fn == "delayed":
        want = jflat.consensus_flat_delayed(jp, *_jargs(c), *jh, jnp.int32(r), wire_dtype=wire)
        got = tflat.consensus_flat_delayed(tp, *_targs(c), *th, r, wire_dtype=wire)
    elif fn == "quarantined":
        want, jv = jflat.consensus_flat_delayed_quarantined(
            jp, *_jargs(c), *jh, jnp.int32(r), corrupt=jnp.asarray(CORRUPT),
            fill_mean=jnp.asarray(FILL_MEAN), fill_rho=jnp.asarray(FILL_RHO), wire_dtype=wire)
        got, tv = tflat.consensus_flat_delayed_quarantined(
            tp, *_targs(c), *th, r, corrupt=CORRUPT, fill_mean=FILL_MEAN, fill_rho=FILL_RHO,
            wire_dtype=wire)
        assert tv.tolist() == np.asarray(jv).tolist()
        assert not all(tv.tolist())  # events were dropped
    else:  # the strict engine's corruption: the ring copy with the fills written in
        cj = jnp.asarray(CORRUPT)[None, :, None]
        jh = tuple(jnp.where(cj, jnp.asarray(f).astype(h.dtype)[None, :, None], h)
                   for f, h in zip((FILL_MEAN, FILL_RHO), jh))
        want = jflat.consensus_flat_delayed(jp, *_jargs(c), *jh, jnp.int32(r), wire_dtype=wire)
        got = tflat.consensus_flat_delayed_corrupted(
            tp, *_targs(c), *th, r, corrupt=CORRUPT, fill_mean=FILL_MEAN, fill_rho=FILL_RHO,
            wire_dtype=wire)
    nan_j = np.isnan(np.asarray(want.mean))
    assert np.array_equal(np.isnan(got.mean.numpy()), nan_j)
    ok = ~nan_j
    np.testing.assert_allclose(got.mean.numpy()[ok], np.asarray(want.mean)[ok], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.rho.numpy()[ok], np.asarray(want.rho)[ok], rtol=1e-5,
                               atol=1e-5)
    inactive = ~c["active"]
    assert torch.equal(got.mean[inactive], tp.mean[inactive])
    assert torch.equal(got.rho[inactive], tp.rho[inactive])


@pytest.mark.parametrize("engine_path", ["direct", "strict_engine"])
def test_pad_slot_fault_follows_the_reference(engine_path):
    """ROADMAP queue C: a pad slot ((0, 0) at weight 0, lag 0) adds
    ``0 * prec(hist[round mod K, 0])``; with agent 0's ring rows (or its
    transmission) non-finite, agent 0's merge is NaN in the reference
    through the pads alone, and in the port too.  Without the pad it is
    finite in both."""
    n, p, k = 3, 4, 2
    rng = np.random.default_rng(5)
    mean = rng.normal(size=(n, p)).astype(np.float32)
    rho = rng.uniform(-2.0, 0.0, (n, p)).astype(np.float32)
    hm = rng.normal(size=(k, n, p)).astype(np.float32)
    hr = rng.uniform(-2.0, 0.0, (k, n, p)).astype(np.float32)
    corrupt = np.zeros(n, bool)
    fm, fr = np.zeros(n, np.float32), np.zeros(n, np.float32)
    if engine_path == "direct":
        hm[:, 0] = np.nan
    else:
        corrupt[0], fm[0], fr[0] = True, np.nan, np.nan
    W = np.array([[0.7, 0.3, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    active = np.array([True, False, False])
    jp = jflat.FlatPosterior(mean=jnp.asarray(mean), rho=jnp.asarray(rho), layout=None)
    tp = tflat.FlatPosterior(mean=torch.from_numpy(mean), rho=torch.from_numpy(rho), layout=None)
    for n_pad in (1, 0):
        edges = np.array([[0, 1]] + [[0, 0]] * n_pad, np.int32)
        weights = np.array([0.3] + [0.0] * n_pad, np.float32)
        lags = np.zeros(1 + n_pad, np.int32)
        jh = (jnp.asarray(hm), jnp.asarray(hr))
        if engine_path == "strict_engine":
            cj = jnp.asarray(corrupt)[None, :, None]
            jh = (jnp.where(cj, jnp.asarray(fm)[None, :, None], jh[0]),
                  jnp.where(cj, jnp.asarray(fr)[None, :, None], jh[1]))
        want = jflat.consensus_flat_delayed(
            jp, jnp.asarray(W, jnp.float32), jnp.asarray(active), jnp.asarray(edges),
            jnp.asarray(weights), jnp.asarray(lags), *jh, jnp.int32(1))
        targs = (tp, W, active, edges, weights, lags, torch.from_numpy(hm),
                 torch.from_numpy(hr), 1)
        got = (tflat.consensus_flat_delayed(*targs) if engine_path == "direct" else
               tflat.consensus_flat_delayed_corrupted(*targs, corrupt=corrupt, fill_mean=fm,
                                                      fill_rho=fr))
        poisoned = n_pad > 0
        assert np.isnan(np.asarray(want.mean)[0]).all() == poisoned
        assert torch.isnan(got.mean[0]).all().item() == poisoned
        assert np.isfinite(np.asarray(want.mean)[1:]).all()
        assert torch.isfinite(got.mean[1:]).all()


# -- the engine against JAX -----------------------------------------------------

N = 8
U, B = 4, 16
DATA = dict(n_classes=4, dim=32, n_train_per_class=120)
LABELS = [[c] for c in range(4) for _ in range(2)]
INNER = {"kind": "failure_injected", "inner": {"kind": "poisson", "rate": 0.8, "seed": 0},
         "drop_rate": 0.1}


def _spec(mod, clock, policy="strict", n=N, base="bidirectional_ring", rounds=3, **inf):
    labels = LABELS if n == N else [[c % 4] for c in range(n)]
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.gossip(base, {"n": n}, clock=clock),
        data=mod.DataSpec(dataset_params=DATA, partition="by_label",
                          partition_params=dict(label_sets=labels), batch_size=B,
                          local_updates=U),
        inference=mod.InferenceSpec(hidden=8, depth=1, lr=5e-3, kl_scale=1e-3,
                                    fault_policy=policy, **inf),
        run=mod.RunSpec(n_rounds=rounds, seed=0),
    )


def _delayed(latency=GEOMETRIC, faults=FAULTS, inner=INNER):
    return dict({"kind": "delayed", "inner": inner, "latency": latency},
                **({"faults": faults} if faults else {}))


def replay_round_draws(js):
    """The batch indices [N, U*B] and BbB noise [N, U, 1, P] the JAX
    session's next round() draws (tests/test_torch_gossip.py)."""
    n, p = js.state.posterior.mean.shape
    u, b = js.spec.data.local_updates, js.spec.data.batch_size
    sizes = [len(y) for _, y in jdata._partition(js.spec.data, js.data.dataset)]
    _, k_batch, k_round = jax.random.split(js.key, 3)
    idx = np.stack([np.asarray(jax.random.randint(k, (u * b,), 0, n_a))
                    for k, n_a in zip(jax.random.split(k_batch, n), sizes)])
    eps = np.empty((n, u, 1, p), np.float32)
    for a, k_a in enumerate(jax.random.split(k_round, n)):
        for t, k_t in enumerate(jax.random.split(k_a, u)):
            (k_s,) = jax.random.split(k_t, 1)
            eps[a, t, 0] = np.asarray(jax.random.normal(k_s, (p,), jnp.float32))
    return idx, eps


def carry(js, ts):
    """The JAX session's state into the port's session (numpy in between)."""
    st, opt = js.state, js.state.opt_state
    opt_np = lambda m: (np.asarray(m.mean), np.asarray(m.rho))  # noqa: E731
    ts.state = gossip_state_from_numpy(
        np.asarray(st.posterior.mean), np.asarray(st.posterior.rho),
        layout=ts.posterior().layout, mu=opt_np(opt.mu), nu=opt_np(opt.nu),
        step=np.asarray(st.step), round=np.asarray(st.round),
        last_merge=np.asarray(st.last_merge), n_merges=np.asarray(st.n_merges),
        hist_mean=None if st.hist_mean is None else np.asarray(st.hist_mean),
        hist_rho=None if st.hist_rho is None else np.asarray(st.hist_rho),
        n_quarantined=(None if st.n_quarantined is None else np.asarray(st.n_quarantined)),
        device="cpu",
    )
    ts.round_idx = js.round_idx


GARBAGE = 1e20  # QUARANTINE_BOUND: a lane beyond it is a payload the guard refuses


def assert_states_close(tst, jst):
    """Float leaves within atol/rtol 1e-5, integer leaves and dtypes equal.
    Under the strict policy a merged garbage fill leaves lanes NaN or beyond
    ``GARBAGE`` (~1e27 after a "huge" fill), and a local step on such an
    agent runs its MLP on 1e27-scale weights, where the two frameworks'
    kernels part at ~1e-5 relative: those lanes must be NaN where JAX's
    are, and beyond ``GARBAGE`` with the same sign where JAX's are."""
    tl, jl = tree_leaves(tst), jax.tree.leaves(jst)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name
        if t.is_floating_point():
            t, j = t.float().numpy(), j.astype(np.float32)
            assert np.array_equal(np.isnan(t), np.isnan(j))
            huge = np.abs(j) > GARBAGE
            assert np.array_equal(np.sign(t[huge]), np.sign(j[huge]))
            assert (np.abs(t[huge]) > GARBAGE).all()
            ok = ~np.isnan(j) & ~huge
            np.testing.assert_allclose(t[ok], j[ok], rtol=1e-5, atol=1e-5)
        else:
            assert t.tolist() == j.tolist()


def run_both(js, ts, windows=2):
    for _ in range(windows):
        idx, eps = replay_round_draws(js)
        jrec, trec = js.round(), ts.round(batch_idx=idx, eps=eps)
        for k in ("round", "n_trained", "n_crashed"):
            assert trec.get(k) == jrec.get(k), k
        if jrec["loss"] is None:
            assert trec["loss"] is None
        else:
            assert trec["loss"] == pytest.approx(jrec["loss"], rel=1e-5, abs=1e-5)
        assert_states_close(ts.state, js.state)
    assert ts.engine.telemetry(ts.state) == js.engine.telemetry(js.state)


@pytest.mark.parametrize("policy,ring", [("strict", None), ("quarantine", None),
                                         ("quarantine", "bf16"), ("strict", "f16")])
def test_delayed_windows_match_jax_with_injected_draws(policy, ring):
    js = japi.build_session(_spec(japi, _delayed(), policy, history_dtype=ring))
    ts = tapi.build_session(_spec(tapi, _delayed(), policy, history_dtype=ring), device="cpu")
    assert ts.engine.hist_slots == js.engine.hist_slots == 4
    while int(np.asarray(js.state.step).min()) == 0:  # every agent has trained
        js.round()
    carry(js, ts)
    run_both(js, ts)
    if policy == "quarantine":
        assert ts.health() == js.health()


# -- the reference's behaviour, as in-port rungs ----------------------------------


def _ring_spec(clock, n=6, rounds=4, seed=0, **inf):
    """tests/test_gossip.py:75's spec."""
    return tapi.ExperimentSpec(
        topology=tapi.TopologySpec.gossip("bidirectional_ring", {"n": n}, clock=clock),
        data=tapi.DataSpec(dataset_params=dict(n_classes=3, dim=8, n_train_per_class=30),
                           partition="iid", partition_params=dict(n_agents=n), batch_size=4,
                           local_updates=2),
        inference=tapi.InferenceSpec(hidden=8, depth=1, lr=1e-2, **inf),
        run=tapi.RunSpec(n_rounds=rounds, seed=seed),
    )


def _assert_posts_bitwise(a, b):
    assert torch.equal(a.posterior().mean, b.posterior().mean)
    assert torch.equal(a.posterior().rho, b.posterior().rho)


def test_latency_zero_is_instant_bitwise():
    """tests/test_gossip.py:653: a constant latency of 0 is the instant
    engine, bitwise, with no ring."""
    inner = {"kind": "poisson", "rate": 0.8, "seed": 1}
    plain = tapi.build_session(_ring_spec(inner), device="cpu")
    d0 = tapi.build_session(_ring_spec(_delayed({"kind": "constant", "delay": 0}, None, inner)),
                            device="cpu")
    plain.run()
    d0.run()
    assert d0.engine.hist_slots == 0 and d0.state.hist_mean is None
    _assert_posts_bitwise(plain, d0)
    assert torch.equal(plain.state.n_merges, d0.state.n_merges)


def test_delayed_merge_uses_the_posterior_as_of_fire_time():
    """tests/test_gossip.py:675: lr = 0, constant latency 1: agent 1's merge
    of the edge fired at window 1 mixes agent 0's initial posterior, though
    agent 0 itself merged at window 1."""
    n = 3
    W = np.full((n, n), 1.0 / n)
    trace = [[[0, 2]], [[1, 0]], [[2, 1]]]
    clock = {"kind": "delayed", "inner": {"kind": "trace", "trace": trace},
             "latency": {"kind": "constant", "delay": 1}}
    spec = tapi.ExperimentSpec(
        topology=tapi.TopologySpec.gossip("complete", {"n": n}, clock=clock),
        data=tapi.DataSpec(dataset_params=dict(n_classes=3, dim=8, n_train_per_class=30),
                           partition="iid", partition_params=dict(n_agents=n), batch_size=4,
                           local_updates=2),
        inference=tapi.InferenceSpec(hidden=8, depth=1, lr=0.0, shared_init=False),
        run=tapi.RunSpec(n_rounds=3, seed=0),
    )
    s = tapi.build_session(spec, device="cpu")
    mean0 = s.posterior().mean.clone()
    prec0 = 1.0 / torch.square(softplus(s.posterior().rho))
    s.run()
    out = s.posterior()

    def merge(dst, src, m_dst, p_dst, m_src, p_src):
        w_self, w = np.float32(1.0 - W[dst, src]), np.float32(W[dst, src])
        p = w_self * p_dst + w * p_src
        return (w_self * p_dst * m_dst + w * p_src * m_src) / p, p

    m1, p1 = merge(1, 0, mean0[1], prec0[1], mean0[0], prec0[0])
    torch.testing.assert_close(out.mean[1], m1, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(out.rho[1], softplus_inv(torch.rsqrt(p1)), atol=1e-6, rtol=1e-6)
    m0w1, p0w1 = merge(0, 2, mean0[0], prec0[0], mean0[2], prec0[2])
    torch.testing.assert_close(out.mean[0], m0w1, atol=1e-6, rtol=1e-6)
    m1_fresh, _ = merge(1, 0, mean0[1], prec0[1], m0w1, p0w1)
    assert float((m1_fresh - m1).abs().max()) > 1e-6  # the staleness is real


@pytest.mark.parametrize("ring", [None, "bf16"])
def test_delayed_resume_is_bitwise(tmp_path, ring):
    """tests/test_gossip.py:729 and tests/test_wire_dtype.py:546: the ring
    rides in the checkpoint (bf16 by name) and a resumed session continues
    bitwise, stale merges included."""
    clock = _delayed({"kind": "geometric", "p": 0.5, "max": 3}, None,
                     {"kind": "poisson", "rate": 0.9, "seed": 2})
    s = tapi.build_session(_ring_spec(clock, rounds=6, seed=2, history_dtype=ring),
                           device="cpu")
    assert s.engine.hist_slots == 4
    s.run(3)
    path = str(tmp_path / "delayed.ckpt")
    s.save(path)
    s2 = tapi.Session.load(path, device="cpu")
    assert s2.state.hist_mean.dtype == s.state.hist_mean.dtype
    s.run(3)
    s2.run(3)
    for a, b in zip(tree_leaves(s.state), tree_leaves(s2.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_instant_states_keep_their_leaf_list():
    """tests/test_gossip.py:755: instant states carry ``None`` rings, so
    their leaves are the pre-latency list; a delayed state adds two."""
    st = tapi.build_session(_ring_spec({"kind": "poisson", "rate": 0.8}), device="cpu").state
    assert st.hist_mean is None and st.hist_rho is None
    n_core = len(tree_leaves(st.posterior)) + len(tree_leaves(st.opt_state)) + 4
    assert len(tree_leaves(st)) == n_core
    d = tapi.build_session(_ring_spec(_delayed({"kind": "constant", "delay": 1}, None,
                                               {"kind": "poisson", "rate": 0.8})),
                           device="cpu").state
    assert len(tree_leaves(d)) == n_core + 2


def test_zero_fault_quarantine_is_strict_on_the_delayed_path():
    """tests/test_faults.py:370 (the delayed half)."""
    clock = {"kind": "delayed", "max_delay": 2, "seed": 5,
             "inner": {"kind": "poisson", "rate": 0.8, "seed": 3}}
    a = tapi.build_session(_ring_spec(clock, fault_policy="strict"), device="cpu")
    b = tapi.build_session(_ring_spec(clock, fault_policy="quarantine"), device="cpu")
    for _ in range(4):
        a.round()
        b.round()
    _assert_posts_bitwise(a, b)
    assert b.state.n_quarantined.tolist() == [0] * 6


def test_bf16_ring_halves_bytes_and_the_telemetry_names_it():
    """tests/test_wire_dtype.py:546: a bf16-resident ring holds exactly half
    the f32 ring's bytes, and ``evaluate()`` names its dtype."""
    clock = _delayed({"kind": "constant", "delay": 2}, None,
                     {"kind": "poisson", "rate": 0.9, "seed": 2})
    s16 = tapi.build_session(_ring_spec(clock, history_dtype="bf16"), device="cpu")
    s32 = tapi.build_session(_ring_spec(clock), device="cpu")
    b16 = sum(t.numel() * t.element_size() for t in (s16.state.hist_mean, s16.state.hist_rho))
    b32 = sum(t.numel() * t.element_size() for t in (s32.state.hist_mean, s32.state.hist_rho))
    assert s16.state.hist_mean.dtype == torch.bfloat16 and 2 * b16 == b32
    s16.run(2)
    assert s16.evaluate(n_mc=1)["engine"]["history_dtype"] == "bf16"
    assert "history_dtype" not in s32.evaluate(n_mc=1)["engine"]
    assert torch.isfinite(s16.posterior().mean).all()


def test_one_window_twice_from_one_state_gives_the_same_bits():
    """The ring slot is written into a new ring: a window run twice from the
    same state (and draws) gives the same bits, and the state is
    unchanged."""
    clock = _delayed(GEOMETRIC, FAULTS, {"kind": "poisson", "rate": 0.9, "seed": 2})
    s = tapi.build_session(_ring_spec(clock, fault_policy="quarantine"), device="cpu")
    s.run(2)
    before = s.state.to("cpu")
    g = torch.Generator().manual_seed(3)
    eps = torch.randn((6, 2, 1, s.posterior().n_params()), generator=g)
    idx = torch.randint(0, 10, (6, 8), generator=g)
    batches = s.data.sampler(s.generator, 2, idx=idx)
    W = s.spec.topology.w_schedule()(2)
    out = [s.engine.run_round(s.state, batches, W, eps=eps)[0] for _ in range(2)]
    for a, b, c in zip(tree_leaves(out[0]), tree_leaves(out[1]), tree_leaves(s.state)):
        assert torch.equal(_bits(a) if a.is_floating_point() else a,
                           _bits(b) if b.is_floating_point() else b)
    for a, b in zip(tree_leaves(before), tree_leaves(s.state)):
        assert torch.equal(a, b)


def test_delayed_construction_checks():
    with pytest.raises(ValueError, match="mean_only"):
        tapi.build_session(_ring_spec(_delayed(faults=None), consensus="mean_only"),
                           device="cpu")
    with pytest.raises(ValueError, match="no delay"):
        tapi.build_session(_ring_spec({"kind": "poisson", "rate": 0.8}, history_dtype="bf16"),
                           device="cpu")
    s = tapi.build_session(_ring_spec(_delayed(faults=None)), device="cpu")
    with pytest.raises(ValueError, match="does not match its stream"):
        s.round(W=np.eye(6))


# -- checkpoints across both packages ---------------------------------------------


def _tiny_delayed(mod, ring=None, n=5):
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.gossip("bidirectional_ring", {"n": n}, clock=_delayed(
            GEOMETRIC, FAULTS, {"kind": "poisson", "rate": 0.9, "seed": 2})),
        data=mod.DataSpec(dataset_params=dict(n_classes=3, dim=8, n_train_per_class=30),
                          partition="iid", partition_params=dict(n_agents=n), batch_size=4,
                          local_updates=2),
        inference=mod.InferenceSpec(hidden=8, depth=1, lr=1e-2, fault_policy="quarantine",
                                    history_dtype=ring),
        run=mod.RunSpec(n_rounds=6, seed=2),
    )


def _assert_leaves_bitwise(tstate, jstate):
    tl, jl = tree_leaves(tstate), jax.tree.leaves(jstate)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name
        if t.dtype == torch.bfloat16:
            t, j = t.view(torch.int16), j.view(np.int16)
        np.testing.assert_array_equal(t.cpu().numpy(), j)


@pytest.mark.parametrize("ring", [None, "bf16"])
def test_jax_delayed_checkpoint_resumes_in_the_port_on_jaxs_draws(tmp_path, ring):
    js = japi.build_session(_tiny_delayed(japi, ring))
    js.run(3)
    path = str(tmp_path / "j.ckpt")
    js.save(path)
    ts = tapi.Session.load(path, device="cpu")
    _assert_leaves_bitwise(ts.state, js.state)
    assert ts.health() == js.health()
    js = japi.Session.load(path)
    run_both(js, ts)


@pytest.mark.parametrize("ring", [None, "bf16"])
def test_port_delayed_checkpoint_loads_in_jax(tmp_path, ring):
    ts = tapi.build_session(_tiny_delayed(tapi, ring), device="cpu")
    ts.run(3)
    path = str(tmp_path / "t.ckpt")
    ts.save(path)
    js = japi.Session.load(path)
    assert js.round_idx == 3
    _assert_leaves_bitwise(ts.state, js.state)
    assert js.health() == ts.health()
