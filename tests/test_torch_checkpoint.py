"""Checkpoints of repro_torch (``checkpoint.io``, ``Session.save/load``)
against the JAX package's (``repro.checkpoint.io``, ``repro.api.Session``),
on the CPU.

* The port's MessagePack codec writes the bytes ``msgpack.packb(doc,
  use_bin_type=True)`` writes and reads what it writes.
* A checkpoint crosses the packages in both directions with every state
  leaf bitwise: the synchronous BbB session, a quarantined chaos gossip
  session and the conjugate linreg session.
* Resume is bitwise inside the port (tests/test_api.py:196, :220,
  tests/test_gossip.py:350).  Across the packages the random streams do not
  continue, so a port session resumed from a JAX checkpoint is fed JAX's
  post-load draws through its ``batch_idx=``/``eps=`` seams and matches
  JAX's resumed round at tests/test_torch_round.py's tolerance (atol and
  rtol 1e-5: fp32 reduction order).
"""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import zlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as japi  # noqa: E402
import repro.checkpoint.io as jio  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.checkpoint.io as tio  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, _msgpack  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402

U, B = 2, 4  # the tiny spec's local updates and batch
CHAOS = {"kind": "failure_injected", "inner": {"kind": "poisson", "rate": 0.8, "seed": 0},
         "drop_rate": 0.1, "faults": {"crash_rate": 0.15, "recover_rate": 0.5,
                                      "corrupt_rate": 0.2, "corrupt_kind": "mix", "seed": 7}}


def _tiny(mod, n_rounds=3, seed=0):
    """tests/test_api.py:24's spec: a 3-agent star, 8-dim 3-class data."""
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.star(n_edge=2, a=0.5),
        data=mod.DataSpec(
            dataset_params=dict(n_classes=3, dim=8, n_train_per_class=30),
            partition="star",
            partition_params=dict(center_labels=[1, 2], edge_labels=[0], n_edge=2),
            batch_size=B, local_updates=U,
        ),
        inference=mod.InferenceSpec(hidden=8, depth=1, lr=1e-2),
        run=mod.RunSpec(n_rounds=n_rounds, seed=seed),
    )


def _gossip(mod, clock=None, policy="quarantine", n=5, seed=2):
    """tests/test_gossip.py:65's data on a 5-agent ring under a clock."""
    clock = clock or CHAOS
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.gossip("bidirectional_ring", {"n": n}, clock=clock),
        data=mod.DataSpec(dataset_params=dict(n_classes=3, dim=8, n_train_per_class=30),
                          partition="iid", partition_params=dict(n_agents=n),
                          batch_size=4, local_updates=2),
        inference=mod.InferenceSpec(hidden=8, depth=1, lr=1e-2, fault_policy=policy),
        run=mod.RunSpec(n_rounds=6, seed=seed),
    )


def _linreg(mod):
    return mod.ExperimentSpec(
        topology=mod.TopologySpec.complete(4),
        data=mod.DataSpec(dataset="linreg", batch_size=10),
        inference=mod.InferenceSpec(method="conjugate_linreg"),
        run=mod.RunSpec(n_rounds=5, seed=0),
    )


SPECS = {"bbb": _tiny, "gossip_quarantine": _gossip, "conjugate": _linreg}


def _assert_leaves_bitwise(tstate, jstate):
    tl, jl = tree_leaves(tstate), jax.tree.leaves(jstate)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name
        np.testing.assert_array_equal(t.cpu().numpy(), j)


def _raw(path):
    with open(path, "rb") as f:
        return tio._decompress(f.read())


# -- the codec ------------------------------------------------------------------

EDGE_INTS = [0, 1, -1, 31, -31, 32, -32, -33, 127, 128, -128, -129, 255, 256, 32767, -32768,
             -32769, 65535, 65536, 2 ** 31 - 1, 2 ** 31, -2 ** 31, -2 ** 31 - 1, 2 ** 32 - 1,
             2 ** 32, 2 ** 63 - 1, -2 ** 63, 2 ** 64 - 1]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]
CODEC_CASES = (
    [("int", v) for v in EDGE_INTS]
    + [("str", "s" * n) for n in LENGTHS] + [("str_utf8", "é" * 40)]
    + [("bin", b"\x00\xff" * (n // 2) + b"b" * (n % 2)) for n in LENGTHS]
    + [("list", list(range(n))) for n in (0, 15, 16, 65535, 65536)]
    + [("map", {f"k{i}": i for i in range(n)}) for n in (0, 15, 16, 65536)]
    + [("scalars", [None, True, False, 0.0, -0.0, 1.5, 1e300, float("inf"), -2.5e-308])]
    + [("nested", {"a": [1, {"b": (2, 3.25)}], "c": None, "d": b"xy", "e": "é"})]
)


@pytest.mark.parametrize("kind,obj", CODEC_CASES,
                         ids=[f"{k}{i}" for i, (k, _) in enumerate(CODEC_CASES)])
def test_codec_writes_msgpacks_bytes_and_reads_both(kind, obj):
    want = msgpack.packb(obj, use_bin_type=True)
    got = _msgpack.packb(obj)
    assert got == want
    back = msgpack.unpackb(want, raw=False)
    assert _msgpack.unpackb(got) == back
    assert _msgpack.unpackb(want) == back


@pytest.mark.parametrize("name", sorted(SPECS))
def test_codec_on_session_documents(tmp_path, name):
    """Both packages' session documents: the port's codec re-encodes the JAX
    document to its exact bytes and ``msgpack`` the port's."""
    js = japi.build_session(SPECS[name](japi))
    js.run(2)
    js.save(str(tmp_path / "j.ckpt"))
    ts = tapi.build_session(SPECS[name](tapi), device="cpu")
    ts.run(2)
    ts.save(str(tmp_path / "t.ckpt"))
    for path in ("j.ckpt", "t.ckpt"):
        raw = _raw(tmp_path / path)
        doc = msgpack.unpackb(raw, raw=False)
        assert _msgpack.unpackb(raw) == doc
        assert _msgpack.packb(doc) == raw == msgpack.packb(doc, use_bin_type=True)


@pytest.mark.parametrize("raw,match", [
    (b"\xd4\x01\x00", "ext type"), (b"\xc7\x01\x05\x00", "ext type"),
    (b"\xc1", "invalid"), (b"\xda\x00\x05ab", "truncated"), (b"\x01\x02", "extra bytes"),
])
def test_codec_refuses_ext_and_malformed_data(raw, match):
    with pytest.raises(ValueError, match=match):
        _msgpack.unpackb(raw)


def test_codec_refuses_what_msgpack_refuses():
    with pytest.raises(OverflowError):
        _msgpack.packb(2 ** 64)
    with pytest.raises(TypeError):
        _msgpack.packb(np.float32(1.0))


# -- across the packages --------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SPECS))
def test_jax_checkpoint_loads_in_the_port(tmp_path, name):
    js = japi.build_session(SPECS[name](japi))
    js.run(3)
    path = str(tmp_path / "j.ckpt")
    js.save(path)
    ts = tapi.Session.load(path, device="cpu")
    assert ts.round_idx == 3
    assert ts.spec.to_doc() == js.spec.to_doc()
    assert type(ts.engine).__name__ == type(js.engine).__name__
    _assert_leaves_bitwise(ts.state, js.state)
    assert ts.health() == js.health()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_port_checkpoint_loads_in_jax(tmp_path, name):
    ts = tapi.build_session(SPECS[name](tapi), device="cpu")
    ts.run(3)
    path = str(tmp_path / "t.ckpt")
    ts.save(path)
    js = japi.Session.load(path)
    assert js.round_idx == 3
    assert js.spec.to_doc() == ts.spec.to_doc()
    _assert_leaves_bitwise(ts.state, js.state)
    assert js.health() == ts.health()
    seed_key = jax.random.key(ts.spec.run.seed)  # the port writes the seed's key
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(js.key)),
                                  np.asarray(jax.random.key_data(seed_key)))


def _tiny_shard_sizes():
    ds = jsyn.make_synthetic_classification(n_classes=3, dim=8, n_train_per_class=30)
    return [len(y) for _, y in jpart.star_partition(
        ds.x_train, ds.y_train, center_labels=[1, 2], edge_labels=[0], n_edge=2)]


def _replay_round_draws(session):
    """The batch indices [N, U*B] and BbB noise [N, U, 1, P] the JAX
    session's next round() draws (tests/test_torch_round.py)."""
    n, p = session.state.posterior.mean.shape
    _, k_batch, k_round = jax.random.split(session.key, 3)
    idx = np.stack([np.asarray(jax.random.randint(k, (U * B,), 0, n_a))
                    for k, n_a in zip(jax.random.split(k_batch, n), _tiny_shard_sizes())])
    eps = np.empty((n, U, 1, p), np.float32)
    for a, k_a in enumerate(jax.random.split(k_round, n)):
        for t, k_t in enumerate(jax.random.split(k_a, U)):
            (k_s,) = jax.random.split(k_t, 1)
            eps[a, t, 0] = np.asarray(jax.random.normal(k_s, (p,), jnp.float32))
    return idx, eps


def test_port_resumes_a_jax_checkpoint_on_jaxs_draws(tmp_path):
    js = japi.build_session(_tiny(japi))
    js.run(2)
    path = str(tmp_path / "j.ckpt")
    js.save(path)
    ts = tapi.Session.load(path, device="cpu")
    js = japi.Session.load(path)  # JAX's own resume, from the same file
    for _ in range(2):
        idx, eps = _replay_round_draws(js)
        jrec = js.round()
        trec = ts.round(batch_idx=idx, eps=eps)
        assert trec["loss"] == pytest.approx(jrec["loss"], rel=1e-5, abs=1e-5)
        for t, j in zip(tree_leaves(ts.state), jax.tree.leaves(js.state)):
            if t.dtype == torch.float32:
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert ts.round_idx == js.round_idx == 4


# -- resume inside the port ------------------------------------------------------


def _assert_states_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_session_checkpoint_roundtrip_and_resume(tmp_path):
    """tests/test_api.py:196 in the port: load rebuilds the session from the
    embedded spec, and both sessions resume bit-identically (the
    generator's state rides in the checkpoint)."""
    s = tapi.build_session(_tiny(tapi, n_rounds=5), device="cpu")
    s.run(2)
    path = str(tmp_path / "sess.ckpt")
    gen_before = s.generator.get_state().clone()
    s.save(path)
    assert torch.equal(s.generator.get_state(), gen_before)  # save is a pure read
    s2 = tapi.Session.load(path, device="cpu")
    assert s2.round_idx == 2
    assert s2.spec == s.spec
    _assert_states_bitwise(s2.state, s.state)
    s.run(2)
    s2.run(2)
    _assert_states_bitwise(s2.state, s.state)


def test_session_checkpoint_zlib_fallback(tmp_path, monkeypatch):
    """tests/test_api.py:220 in the port: without ``zstandard`` the
    document is zlib-compressed, and both packages read it."""
    monkeypatch.setattr(tio, "zstandard", None)
    s = tapi.build_session(_tiny(tapi, n_rounds=2), device="cpu")
    s.run()
    path = str(tmp_path / "sess_zlib.ckpt")
    s.save(path)
    with open(path, "rb") as f:
        comp = f.read()
    assert comp[:4] != tio._ZSTD_MAGIC
    zlib.decompress(comp)  # actually took the zlib path
    s2 = tapi.Session.load(path, device="cpu")
    _assert_states_bitwise(s2.state, s.state)
    assert s2.spec == s.spec
    _assert_leaves_bitwise(s.state, japi.Session.load(path).state)


def test_zstd_checkpoint_refused_without_zstandard(tmp_path, monkeypatch):
    path = tmp_path / "z.ckpt"
    path.write_bytes(tio._ZSTD_MAGIC + b"\x00" * 16)
    monkeypatch.setattr(tio, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstd-compressed but the zstandard module"):
        tapi.Session.load(str(path), device="cpu")


@pytest.mark.parametrize("clock,policy", [
    ({"kind": "poisson", "rate": 0.6, "seed": 11}, "strict"), (CHAOS, "quarantine"),
], ids=["poisson_strict", "chaos_quarantine"])
def test_gossip_session_save_load_resume_bitwise(tmp_path, clock, policy):
    """tests/test_gossip.py:350 in the port, and the same under chaos
    faults and quarantine (``n_quarantined`` is a leaf)."""
    s = tapi.build_session(_gossip(tapi, clock, policy), device="cpu")
    s.run(3)
    path = str(tmp_path / "gossip.ckpt")
    s.save(path)
    s2 = tapi.Session.load(path, device="cpu")
    assert s2.round_idx == 3
    assert s2.spec == s.spec
    assert (s2.state.n_quarantined is None) == (policy == "strict")
    s.run(3)
    s2.run(3)
    _assert_states_bitwise(s2.state, s.state)
    assert s2.engine.telemetry(s2.state) == s.engine.telemetry(s.state)


def test_conjugate_session_resume_bitwise(tmp_path):
    s = tapi.build_session(_linreg(tapi), device="cpu")
    s.run(3)
    path = str(tmp_path / "lin.ckpt")
    s.save(path)
    s2 = tapi.Session.load(path, device="cpu")
    assert isinstance(s2.state, type(s.state))
    _assert_states_bitwise(s2.state, s.state)
    s.run(2)
    s2.run(2)
    _assert_states_bitwise(s2.state, s.state)
    assert s2.evaluate() == s.evaluate()


def test_load_without_a_card_needs_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    s = tapi.build_session(_tiny(tapi), device="cpu")
    path = str(tmp_path / "s.ckpt")
    s.save(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.Session.load(path)


def test_a_foreign_generator_state_is_not_restored(tmp_path):
    """A checkpoint whose generator came from another device type (here: a
    CPU state tagged as the card's) leaves the rebuilt session's generator
    as a fresh build's."""
    s = tapi.build_session(_tiny(tapi), device="cpu")
    s.run(2)
    path = str(tmp_path / "s.ckpt")
    s.save(path)
    doc = msgpack.unpackb(_raw(path), raw=False)
    assert doc["torch_generator"]["device"] == "cpu"
    doc["torch_generator"]["device"] = "cuda"
    tio._write_doc(path, doc)
    fresh = tapi.build_session(_tiny(tapi), device="cpu")
    s2 = tapi.Session.load(path, device="cpu")
    assert torch.equal(s2.generator.get_state(), fresh.generator.get_state())
    _assert_states_bitwise(s2.state, s.state)


# -- leaf documents ---------------------------------------------------------------

DTYPES = [("bfloat16", jnp.bfloat16, torch.bfloat16), ("float16", jnp.float16, torch.float16),
          ("float32", jnp.float32, torch.float32), ("int32", jnp.int32, torch.int32)]


@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_leaf_dtypes_cross_both_ways(tmp_path, name, jdt, tdt):
    vals = np.random.default_rng(3).normal(0, 40, (3, 5)).astype(np.float32)
    jtree = {"b": jnp.asarray(vals, jdt), "a": jnp.arange(4, dtype=jnp.int32)}
    ttree = {"b": torch.from_numpy(vals).to(tdt), "a": torch.arange(4, dtype=torch.int32)}
    jio.save_pytree(str(tmp_path / "j.ckpt"), jtree)
    tio.save_pytree(str(tmp_path / "t.ckpt"), ttree)
    for path in ("j.ckpt", "t.ckpt"):
        doc = msgpack.unpackb(_raw(tmp_path / path), raw=False)
        tags = [leaf["dtype"] for leaf in doc["leaves"]]
        assert tags == ["<i4", name if name == "bfloat16" else np.dtype(name).str]
    like_t = {"b": torch.zeros((3, 5), dtype=tdt), "a": torch.zeros(4, dtype=torch.int32)}
    got_t = tio.restore_pytree(str(tmp_path / "j.ckpt"), like_t)
    got_j = jio.restore_pytree(str(tmp_path / "t.ckpt"), jax.tree.map(jnp.zeros_like, jtree))
    for got, want in ((got_t["b"], ttree["b"]), (got_t["a"], ttree["a"])):
        assert got.dtype == want.dtype and torch.equal(got, want)
    np.testing.assert_array_equal(np.asarray(got_j["b"]).view(np.uint8),
                                  np.asarray(jtree["b"]).view(np.uint8))
    assert np.asarray(got_j["b"]).dtype == np.asarray(jtree["b"]).dtype


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5])
def test_key_data_is_jaxs_for_the_seed(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    got = tio.seed_key_data(seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_flat_posterior_checkpoints_cross_both_ways(tmp_path):
    ts = tapi.build_session(_tiny(tapi), device="cpu")
    js = japi.build_session(_tiny(japi))
    assert ts.posterior().layout.to_doc() == js.posterior().layout.to_doc()
    tio.save_flat_posterior(str(tmp_path / "t.ckpt"), ts.posterior())
    jio.save_flat_posterior(str(tmp_path / "j.ckpt"), js.posterior())
    from_j = tio.restore_flat_posterior(str(tmp_path / "j.ckpt"))
    from_t = jio.restore_flat_posterior(str(tmp_path / "t.ckpt"))
    assert from_j.layout == ts.posterior().layout
    assert from_t.layout.to_doc() == js.posterior().layout.to_doc()
    np.testing.assert_array_equal(from_j.mean.numpy(), np.asarray(js.posterior().mean))
    np.testing.assert_array_equal(np.asarray(from_t.rho), ts.posterior().rho.numpy())


# -- CheckpointManager -------------------------------------------------------------


def test_checkpoint_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    for step in range(1, 6):
        mgr.save(step, {"w": torch.full((3,), float(step)), "n": torch.tensor(step)})
    assert mgr.all_steps() == [4, 5]
    assert mgr.latest_step() == 5
    step, tree = mgr.restore({"w": torch.zeros(3), "n": torch.tensor(0)})
    assert step == 5 and torch.equal(tree["w"], torch.full((3,), 5.0))
    step, tree = mgr.restore({"w": torch.zeros(3), "n": torch.tensor(0)}, step=4)
    assert int(tree["n"]) == 4
    assert not [n for n in os.listdir(mgr.root) if n.endswith(".tmp")]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": torch.zeros(3)})


def test_checkpoint_manager_commit_is_atomic(tmp_path, monkeypatch):
    """A writer that dies before the rename leaves only a ``.tmp`` file:
    the committed checkpoint is intact and no step appears for it."""
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(1, {"w": torch.ones(4)})

    def crash(src, dst):
        raise OSError("preempted")

    monkeypatch.setattr(tio.os, "replace", crash)
    with pytest.raises(OSError, match="preempted"):
        mgr.save(2, {"w": torch.zeros(4)})
    monkeypatch.undo()
    assert mgr.all_steps() == [1]
    assert os.path.exists(os.path.join(mgr.root, "step_000000002.ckpt.tmp"))
    _, tree = mgr.restore({"w": torch.zeros(4)})
    assert torch.equal(tree["w"], torch.ones(4))
    # the JAX package's manager reads the port's files
    step, jtree = jio.CheckpointManager(mgr.root).restore({"w": jnp.zeros(4)})
    assert step == 1 and np.array_equal(np.asarray(jtree["w"]), np.ones(4, np.float32))
