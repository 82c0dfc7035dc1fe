"""Edge-native segment windows in repro_torch (``kind="sparse"`` clocks,
``consensus_impl="segments"``, ``core.flat.consensus_flat_segments
(_quarantined)``) and the ragged term list under them
(``kernels.launch_plan.ragged_terms``, the plain version of
``consensus_fused_segments``), against the JAX package on the CPU, and the
reference's bitwise rungs inside the port.

Tolerance atol 1e-5 (rtol 1e-5): fp32 summation order.  Segments against
the dense masked engine below the guard: 1e-4, the reference's own bound
(tests/test_sparse_topology.py:515).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.api as japi  # noqa: E402
import repro.core.flat as jflat  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.core.flat as tflat  # noqa: E402
from repro.core.graphs import watts_strogatz_sparse as jws  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.kernels import consensus as tk  # noqa: E402
from repro_torch.kernels.launch_plan import ragged_terms  # noqa: E402

from test_torch_delayed import (  # noqa: E402
    _assert_leaves_bitwise,
    carry,
    run_both,
)

WIRES = ("f32", "bf16", "f16")
FAULTS = {"crash_rate": 0.1, "recover_rate": 0.5, "corrupt_rate": 0.25, "corrupt_kind": "mix",
          "seed": 7}


# -- the ragged term list ----------------------------------------------------------


def _brute_terms(n, dst, src, w, active):
    """Row by row, in the given order, the zero-weight repeats dropped."""
    rows = []
    for i in range(n):
        seen, row = set(), []
        for d, s, x in zip(dst, src, w):
            if d != i or not active[i]:
                continue
            if x == 0.0:
                if s in seen:
                    continue
                seen.add(s)
            row.append((int(s), np.float32(x)))
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_ragged_terms_keep_order_and_collapse_pads(seed):
    rng = np.random.default_rng(seed)
    n, e, n_pad = 9, 30, 12
    dst = np.concatenate([rng.integers(0, n, e), np.zeros(n_pad, int)])
    src = np.concatenate([rng.integers(0, 3 * n, e), np.zeros(n_pad, int)])
    w = np.concatenate([rng.choice([0.0, 0.1, 0.25], e), np.zeros(n_pad)]).astype(np.float32)
    active = rng.random(n) < 0.7
    active[0] = True
    t = ragged_terms(n, dst, src, w, active)
    want = _brute_terms(n, dst, src, w, active)
    assert t.row_ptr[0] == 0 and t.row_ptr.dtype == np.int32 and t.src.dtype == np.int32
    for i in range(n):
        a, b = t.row_ptr[i], t.row_ptr[i + 1]
        assert list(zip(t.src[a:b].tolist(), t.weight[a:b].tolist())) == \
            [(s, float(x)) for s, x in want[i]]
    # O(E + N) sizes: the 12 pads are one term of row 0
    assert t.n_terms <= e + 1 and len(t.row_ptr) == n + 1
    assert np.diff(t.row_ptr).tolist() == [len(row) for row in want]


def test_ragged_terms_refuse_bad_rows():
    with pytest.raises(ValueError, match="destinations"):
        ragged_terms(3, [3], [0], [0.5])
    with pytest.raises(ValueError, match="differ"):
        ragged_terms(3, [0, 1], [0], [0.5])


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("wp_first", [False, True])
def test_plain_version_blocks_lanes_without_changing_bits(wire, wp_first):
    """The plain version's lane blocks change nothing about a lane's sum,
    and a bf16 second buffer decodes to fp32 before the arithmetic."""
    rng = np.random.default_rng(1)
    n, p = 7, 300
    x_m = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    x_r = torch.from_numpy(rng.uniform(-3, 0, (n, p)).astype(np.float32))
    h_m = torch.from_numpy(rng.normal(size=(2 * n, p)).astype(np.float32)).to(torch.bfloat16)
    h_r = torch.from_numpy(rng.uniform(-3, 0, (2 * n, p)).astype(np.float32)).to(torch.bfloat16)
    dst = rng.integers(0, n, 25)
    src = rng.integers(0, 3 * n, 25)
    w = rng.uniform(0.0, 0.3, 25).astype(np.float32)
    t = ragged_terms(n, dst, src, w, np.arange(n) != 4)
    whole = tk.consensus_fused_segments(t, x_m, x_r, h_m, h_r, wire_dtype=wire,
                                        wp_first=wp_first)
    blocked = tk.consensus_segments_plain(t, x_m, x_r, h_m, h_r, wire, wp_first, block=128)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)
    assert torch.equal(whole[0][4], x_m[4])  # a row without terms passes through


# -- the flat functions against JAX ---------------------------------------------------


def _seg_case(seed, n=12, p=41):
    rng = np.random.default_rng(seed)
    g = jws(n, k=4, beta=0.3, seed=seed)
    dst, src, w = g.edge_arrays()
    off = dst != src
    fired = rng.random(off.sum()) < 0.6
    d, s, x = dst[off][fired], src[off][fired], w[off][fired].astype(np.float32)
    n_pad = 5
    d = np.concatenate([d, np.zeros(n_pad, np.int32)]).astype(np.int32)
    s = np.concatenate([s, np.zeros(n_pad, np.int32)]).astype(np.int32)
    x = np.concatenate([x, np.zeros(n_pad, np.float32)])
    self_w = 1.0 - np.bincount(d, weights=x, minlength=n)
    active = np.bincount(d[:-n_pad], minlength=n) > 0
    mean = rng.normal(size=(n, p)).astype(np.float32)
    rho = rng.uniform(-4.0, 0.5, (n, p)).astype(np.float32)
    return dict(dst=d, src=s, w=x, self_w=self_w, active=active, mean=mean, rho=rho, n=n)


def _both(c, mean=None):
    mean = c["mean"] if mean is None else mean
    return (jflat.FlatPosterior(mean=jnp.asarray(mean), rho=jnp.asarray(c["rho"]), layout=None),
            tflat.FlatPosterior(mean=torch.from_numpy(mean), rho=torch.from_numpy(c["rho"]),
                                layout=None))


def _assert_close_nan(got, want):
    want = np.asarray(want)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("rows", ["all", "masked", "lonely"])
def test_segments_flat_matches_jax(wire, rows):
    """``lonely``: an active row that no edge reaches sums nothing, and its
    0 / 0 is the reference's NaN, not a pass-through."""
    c = _seg_case(seed=len(wire))
    n = c["n"]
    ar = np.arange(n, dtype=np.int32)
    d, s = np.concatenate([c["dst"], ar]), np.concatenate([c["src"], ar])
    w = np.concatenate([c["w"], c["self_w"].astype(np.float32)])
    if rows == "lonely":
        keep = d != 3
        d, s, w = d[keep], s[keep], w[keep]
    jp, tp = _both(c)
    act = c["active"] | (ar == 3) if rows != "all" else None
    want = jflat.consensus_flat_segments(jp, jnp.asarray(d), jnp.asarray(s), jnp.asarray(w),
                                         active=None if act is None else jnp.asarray(act),
                                         wire_dtype=wire)
    got = tflat.consensus_flat_segments(tp, d, s, w, active=act, wire_dtype=wire)
    _assert_close_nan(got.mean, want.mean)
    _assert_close_nan(got.rho, want.rho)
    assert torch.isnan(got.mean[3]).all() == (rows == "lonely")


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("poison", ["sources", "resident", "none"])
def test_segments_quarantined_matches_jax(wire, poison):
    c = _seg_case(seed=7 + len(wire))
    n = c["n"]
    mean, mean_src, rho_src = c["mean"].copy(), c["mean"].copy(), c["rho"].copy()
    if poison == "sources":  # two bad transmissions, one valid corrupted one
        mean_src[int(c["src"][0])] = np.nan
        mean_src[0] = 1e30
        mean_src[int(c["src"][1])] = 0.5
        rho_src[int(c["src"][1])] = -1.0
    elif poison == "resident":
        mean[int(c["dst"][0])] = np.inf
        mean_src = mean.copy()
    jp, tp = _both(c, mean)
    args = (c["dst"], c["src"], c["w"], c["self_w"].astype(np.float32))
    want, jv = jflat.consensus_flat_segments_quarantined(
        jp, *(jnp.asarray(a) for a in args), active=jnp.asarray(c["active"]),
        mean_src=jnp.asarray(mean_src), rho_src=jnp.asarray(rho_src), wire_dtype=wire)
    got, tv = tflat.consensus_flat_segments_quarantined(
        tp, *args, active=c["active"], mean_src=torch.from_numpy(mean_src),
        rho_src=torch.from_numpy(rho_src), wire_dtype=wire)
    assert tv.tolist() == np.asarray(jv).tolist()
    _assert_close_nan(got.mean, want.mean)
    _assert_close_nan(got.rho, want.rho)
    if poison == "none":  # zero faults: the unguarded call's bits
        ar = np.arange(n, dtype=np.int32)
        plain = tflat.consensus_flat_segments(
            tp, np.concatenate([c["dst"], ar]), np.concatenate([c["src"], ar]),
            np.concatenate([c["w"], c["self_w"].astype(np.float32)]), active=c["active"],
            wire_dtype=wire)
        assert torch.equal(plain.mean, got.mean) and torch.equal(plain.rho, got.rho)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("policy", ["quarantine", "strict"])
def test_segments_fill_rows_match_jax_transmitted_copy(wire, policy):
    """The engine's corruption (``corrupt`` agents send constant fill rows,
    read from [C, P] rows after the posterior) against the reference's full
    transmitted copy: a NaN fill, a huge one, a valid one on an active
    agent and a valid one on an idle agent (which the reference's
    quarantined merge passes through as its new state)."""
    c = _seg_case(seed=11 + len(wire))
    n = c["n"]
    idle = int(np.setdiff1d(np.arange(n), c["src"][:3])[0])
    c["active"][idle] = False
    corrupt = np.zeros(n, bool)
    fill_mean, fill_rho = np.zeros(n, np.float32), np.zeros(n, np.float32)
    for agent, fm, fr in ((int(c["src"][0]), np.nan, 0.0), (int(c["src"][1]), 1e30, 0.0),
                          (int(c["src"][2]), 0.5, -1.0), (idle, -0.25, -2.0)):
        corrupt[agent], fill_mean[agent], fill_rho[agent] = True, fm, fr
    mean_src = np.where(corrupt[:, None], fill_mean[:, None], c["mean"]).astype(np.float32)
    rho_src = np.where(corrupt[:, None], fill_rho[:, None], c["rho"]).astype(np.float32)
    jp, tp = _both(c)
    kw = dict(corrupt=corrupt, fill_mean=fill_mean, fill_rho=fill_rho, wire_dtype=wire)
    if policy == "quarantine":
        args = (c["dst"], c["src"], c["w"], c["self_w"].astype(np.float32))
        want, jv = jflat.consensus_flat_segments_quarantined(
            jp, *(jnp.asarray(a) for a in args), active=jnp.asarray(c["active"]),
            mean_src=jnp.asarray(mean_src), rho_src=jnp.asarray(rho_src), wire_dtype=wire)
        got, tv = tflat.consensus_flat_segments_quarantined(tp, *args, active=c["active"], **kw)
        assert tv.tolist() == np.asarray(jv).tolist()
        want_mean, want_rho = want.mean, want.rho
    else:
        ar = np.arange(n, dtype=np.int32)
        d, s = np.concatenate([c["dst"], ar]), np.concatenate([c["src"], ar])
        w = np.concatenate([c["w"], c["self_w"].astype(np.float32)])
        merged = jflat.consensus_flat_segments(
            jflat.FlatPosterior(mean=jnp.asarray(mean_src), rho=jnp.asarray(rho_src),
                                layout=None),
            jnp.asarray(d), jnp.asarray(s), jnp.asarray(w), active=jnp.asarray(c["active"]),
            wire_dtype=wire)
        act = c["active"][:, None]
        want_mean = jnp.where(act, merged.mean, jp.mean)
        want_rho = jnp.where(act, merged.rho, jp.rho)
        got = tflat.consensus_flat_segments_corrupted(tp, d, s, w, active=c["active"], **kw)
    _assert_close_nan(got.mean, want_mean)
    _assert_close_nan(got.rho, want_rho)


def test_segments_active_rows_pass_through_bitwise():
    """tests/test_sparse_topology.py:243."""
    n, p = 12, 33
    rng = np.random.default_rng(5)
    mean = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    rho = torch.from_numpy(rng.uniform(-3, 0, (n, p)).astype(np.float32))
    post = tflat.FlatPosterior(mean=mean, rho=rho, layout=None)
    ar = np.arange(n)
    dst = np.concatenate([ar, ar, ar])
    src = np.concatenate([ar, (ar + 1) % n, (ar - 1) % n])
    w = np.concatenate([np.full(n, 0.5), np.full(2 * n, 0.25)]).astype(np.float32)
    active = np.zeros(n, bool)
    active[[2, 3, 7]] = True
    out = tflat.consensus_flat_segments(post, dst, src, w, active=active)
    assert torch.equal(out.mean[~active], mean[~active])
    assert torch.equal(out.rho[~active], rho[~active])
    assert not torch.equal(out.mean[active], mean[active])


# -- the engine ----------------------------------------------------------------------


def _clocked(mod, n=16, impl="segments", wire="f32", policy="strict", faults=None, rounds=2,
             rate=1.0, data=None):
    """tests/test_sparse_topology.py:489's spec."""
    clock = {"kind": "poisson", "rate": rate, "seed": 3, **({"faults": faults} if faults else {})}
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.sparse("watts_strogatz", n=n, k=4, beta=0.2, seed=1,
                                         clock=clock),
        data=mod.DataSpec(dataset_params=data or dict(n_classes=3, dim=8, n_train_per_class=30),
                          partition="iid", partition_params=dict(n_agents=n), batch_size=4,
                          local_updates=2),
        inference=mod.InferenceSpec(hidden=8, depth=1, lr=1e-2, consensus_impl=impl,
                                    wire_dtype=wire, fault_policy=policy),
        run=mod.RunSpec(n_rounds=rounds, seed=0),
    )


@pytest.mark.parametrize("wire", WIRES)
def test_segments_engine_matches_masked_engine_per_wire(wire):
    """tests/test_sparse_topology.py:515: one SparseWindow stream run
    edge-native and through its dense view agree to 1e-4, window by window
    from the same state.  (Over several windows the fp32 order's last bits
    reach the next local step, whose Adam turns a gradient of rounding noise
    on a lane no sample has moved, v ~ 1e-9, into a step of ~lr: chip_smoke
    adam_noise_lanes.)"""
    seg = tapi.build_session(_clocked(tapi, wire=wire, rounds=3), device="cpu")
    msk = tapi.build_session(_clocked(tapi, impl="masked", wire=wire, rounds=3), device="cpu")
    assert seg.engine.consensus_impl == "segments"
    g = torch.Generator().manual_seed(4)
    for _ in range(3):
        msk.state, msk.round_idx = seg.state.to("cpu"), seg.round_idx
        idx = torch.randint(0, 5, (16, 8), generator=g)  # every shard holds >= 5 rows
        eps = torch.randn((16, 2, 1, seg.posterior().n_params()), generator=g)
        seg.round(batch_idx=idx, eps=eps)
        msk.round(batch_idx=idx, eps=eps)
        assert float((seg.posterior().mean - msk.posterior().mean).abs().max()) <= 1e-4
        assert float((seg.posterior().rho - msk.posterior().rho).abs().max()) <= 1e-4
        assert torch.equal(seg.state.n_merges, msk.state.n_merges)


def test_zero_fault_quarantine_is_strict_on_the_segments_path():
    """tests/test_faults.py:282 (the segments form of the rung)."""
    a = tapi.build_session(_clocked(tapi, policy="strict", rounds=3), device="cpu")
    b = tapi.build_session(_clocked(tapi, policy="quarantine", rounds=3), device="cpu")
    a.run()
    b.run()
    assert torch.equal(a.posterior().mean, b.posterior().mean)
    assert torch.equal(a.posterior().rho, b.posterior().rho)
    assert b.state.n_quarantined.tolist() == [0] * 16


@pytest.mark.parametrize("policy", ["strict", "quarantine"])
def test_segments_windows_match_jax_with_injected_draws(policy):
    spec = lambda mod: _clocked(mod, policy=policy, faults=FAULTS, rounds=4)  # noqa: E731
    js = japi.build_session(spec(japi))
    ts = tapi.build_session(spec(tapi), device="cpu")
    assert ts.engine.consensus_impl == js.engine.consensus_impl == "segments"
    while int(np.asarray(js.state.step).min()) == 0:
        js.round()
    carry(js, ts)
    run_both(js, ts)
    if policy == "quarantine":
        assert ts.health() == js.health()


def test_segments_construction_checks():
    with pytest.raises(ValueError, match="edge-native"):
        tapi.build_session(tapi.ExperimentSpec(
            topology=tapi.TopologySpec.gossip("bidirectional_ring", {"n": 6},
                                              clock={"kind": "poisson", "rate": 1.0}),
            data=_clocked(tapi, n=6).data,
            inference=tapi.InferenceSpec(hidden=8, depth=1, consensus_impl="segments")),
            device="cpu")
    with pytest.raises(ValueError, match="EventWindows"):
        tapi.build_session(_clocked(tapi, n=12, impl="ppermute"), device="cpu")
    s = tapi.build_session(_clocked(tapi, n=12), device="cpu")
    with pytest.raises(ValueError, match="array-like W"):
        s.round(W=np.eye(12))


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def test_no_n_by_n_tensor_above_the_dense_guard():
    """At N = 4,200 (above SPARSE_DENSE_GUARD = 4096) no tensor of a
    segments window, quarantined under faults, has two dimensions equal to
    N; the dense view is refused (benchmarks/bench_consensus.py:218 walks
    the jaxpr for the same check)."""
    n = 4200
    data = dict(n_classes=3, dim=8, n_train_per_class=5600)
    s = tapi.build_session(_clocked(tapi, n=n, policy="quarantine", faults=FAULTS, rate=0.05,
                                    data=data), device="cpu")
    s.round()
    with _Shapes() as rec:
        s.round()
    assert rec.shapes and not [sh for sh in rec.shapes if sh.count(n) >= 2]
    assert s.health()["all_ok"]
    with pytest.raises(ValueError, match="SPARSE_DENSE_GUARD"):
        tapi.build_session(_clocked(tapi, n=n, impl="masked", data=data), device="cpu")


# -- checkpoints across both packages --------------------------------------------------


def test_jax_sparse_checkpoint_resumes_in_the_port_on_jaxs_draws(tmp_path):
    spec = lambda mod: _clocked(mod, policy="quarantine", faults=FAULTS, rounds=6)  # noqa: E731
    js = japi.build_session(spec(japi))
    js.run(3)
    path = str(tmp_path / "j.ckpt")
    js.save(path)
    ts = tapi.Session.load(path, device="cpu")
    _assert_leaves_bitwise(ts.state, js.state)
    js = japi.Session.load(path)
    run_both(js, ts)


def test_port_sparse_checkpoint_loads_in_jax_and_resumes_bitwise(tmp_path):
    ts = tapi.build_session(_clocked(tapi, policy="quarantine", faults=FAULTS, rounds=6),
                            device="cpu")
    ts.run(3)
    path = str(tmp_path / "t.ckpt")
    ts.save(path)
    js = japi.Session.load(path)
    assert js.round_idx == 3
    _assert_leaves_bitwise(ts.state, js.state)
    assert js.health() == ts.health()
    t2 = tapi.Session.load(path, device="cpu")
    ts.run(2)
    t2.run(2)
    for a, b in zip(tree_leaves(ts.state), tree_leaves(t2.state)):
        assert torch.equal(a, b)
