"""The port's LM serving steps (``repro_torch.launch.steps``) and the
synthetic token sampler against the JAX package on the CPU, at ``reduced()``
sizes, weights carried across by ``models.params_from_numpy``.

The port runs A agents as a leading axis in one pass where the reference
``jax.vmap``s ``forward``; A = 3 agents with distinct weights here.  The
MoE configs run over agents at float32 only: at bf16 their routing is
held token by token in tests/test_torch_zoo_models.py (a near-tie of the
router goes either way on a one-ulp change, and the reference does not
agree with itself there).
Tolerances: float32 logits atol 1e-4 (fp32 sums in another order); bf16
compute BF16_ATOL = 0.125 (four bf16 ulps at the reduced models' logit
scale, |logits| < 8); eq. (6) on the zoo posterior rtol/atol 1e-6; the
serving cast bitwise.  The sampler's logits are bit for bit the reference's;
its tokens are its own draws, held to the Zipf(1.2) law by a chi-square
test over the top 32 tokens and the rest (31 + 1 degrees of freedom; the
bound 80 is the 0.99995 quantile, so a sound sampler fails once in 20,000
seeds, and this seed is fixed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import graphs as jgraphs  # noqa: E402
from repro.data.pipeline import make_lm_batch_sampler as j_sampler  # noqa: E402
from repro.launch import steps as js  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.flat import FlatPosterior  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.data.pipeline import lm_logits, make_lm_batch_sampler  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

A = 3
BF16_ATOL = 0.125
F32_ATOL = 1e-4


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jget(arch).reduced(), dtype=dtype, **kw),
            dataclasses.replace(tget(arch).reduced(), dtype=dtype, **kw))


def _agent_params(jcfg):
    """A agents' reference weights stacked on a leading axis, and the port's copy."""
    ps = [jm.init_params(jcfg, jax.random.key(10 + a)) for a in range(A)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *ps)
    return stacked, tm.params_from_numpy(jax.tree.map(np.asarray, stacked), device="cpu")


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-20b", "repro-100m", "olmoe-1b-7b",
                                  "recurrentgemma-9b", "xlstm-1.3b"])
def test_init_train_state_layout_equals_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jstate = js.init_train_state(jax.random.key(0), jcfg, 2, jadam(), init_sigma=0.02)
    tstate = ts.init_train_state(tcfg, 2, adam(), torch.Generator().manual_seed(0),
                                 init_sigma=0.02, device="cpu")
    jl, tl = jstate.posterior.layout, tstate.posterior.layout
    assert [dataclasses.asdict(s) for s in tl.specs] == [dataclasses.asdict(s) for s in jl.specs]
    assert tl.n_params == jl.n_params == tstate.posterior.mean.shape[1]
    assert tl.to_doc() == jl.to_doc()
    post = tstate.posterior
    assert post.mean.shape == (2, jl.n_params)
    assert torch.equal(post.mean[0], post.mean[1])  # every agent starts from one draw
    np.testing.assert_array_equal(post.rho.numpy(), np.asarray(jstate.posterior.rho))
    assert tstate.step.dtype == torch.int32 and int(tstate.step) == 0
    assert torch.count_nonzero(tstate.opt_state.mu.mean) == 0
    tree = ts.init_train_state(tcfg, 2, adam(), torch.Generator().manual_seed(0), flat=False,
                               device="cpu")
    assert torch.equal(tree.posterior.mean["embed"]["emb"][1], post.layout.unflatten(
        post.mean)["embed"]["emb"][0])


def test_consensus_and_serve_params_on_the_zoo_posterior():
    jcfg, tcfg = _cfgs("repro-100m")
    jstate = js.init_train_state(jax.random.key(0), jcfg, 3, jadam(), init_sigma=0.02)
    rng = np.random.default_rng(0)
    shape = jstate.posterior.mean.shape
    mean = rng.normal(size=shape).astype(np.float32) * 0.1
    rho = rng.uniform(-5, -3, size=shape).astype(np.float32)
    jpost = dataclasses.replace(jstate.posterior, mean=jnp.asarray(mean), rho=jnp.asarray(rho))
    tlayout = ts.init_train_state(tcfg, 3, adam(), torch.Generator().manual_seed(0),
                                  device="cpu").posterior.layout
    tpost = FlatPosterior(mean=torch.from_numpy(mean), rho=torch.from_numpy(rho), layout=tlayout)
    W = jgraphs.ring_w(3)
    jout = js.make_consensus_step(jcfg, jnp.asarray(W, jnp.float32))(jpost)
    tout = ts.make_consensus_step(tcfg, torch.as_tensor(W, dtype=torch.float32))(tpost)
    np.testing.assert_allclose(tout.mean.numpy(), np.asarray(jout.mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tout.rho.numpy(), np.asarray(jout.rho), rtol=1e-6, atol=1e-6)
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        jserve = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                              js.serve_params(jpost, jdt))
        tserve = ts.serve_params(tpost, tdt)
        assert tserve["stacks"]["attn"]["mlp"]["w_up"].dtype == tdt
        got = tm.params_to_numpy(tserve)
        assert jax.tree.structure(got) == jax.tree.structure(jserve)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jserve)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,s", [("qwen3-8b", 20), ("granite-20b", 600),
                                    ("mistral-nemo-12b", 20)])
def test_prefill_and_decode_over_agents_against_the_reference(arch, s, dtype):
    """make_prefill_step then three make_decode_step calls for A = 3 agents
    against the reference's vmapped steps (S = 600 takes the kernel route's
    pad); logits each step and the cache after."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _agent_params(jcfg)
    cap, b = s + 3, 2
    kv = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    jcache = js.make_agent_cache(jcfg, A, b, cap, kv[dtype][0])
    tcache = ts.make_agent_cache(tcfg, A, b, cap, kv[dtype][1], device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (A, b, s + 3))
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    lj, jcache = js.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks[..., :s])}, jcache)
    lt, tcache = ts.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks[..., :s])},
                                            tcache)
    assert lt.shape == (A, b, 1, jcfg.padded_vocab)
    _close(lt, lj, atol)
    for t in range(s, s + 3):
        lj, jcache = js.make_decode_step(jcfg)(jp, jnp.asarray(toks[..., t:t + 1]),
                                               jnp.asarray(t), jcache)
        lt, tcache = ts.make_decode_step(tcfg)(tp, torch.from_numpy(toks[..., t:t + 1]), t,
                                               tcache)
        _close(lt, lj, atol)
    np.testing.assert_array_equal(tcache["stacks"]["attn"]["pos"].numpy(),
                                  np.asarray(jcache["stacks"]["attn"]["pos"]))
    _close(tcache["stacks"]["attn"]["k"], np.asarray(jcache["stacks"]["attn"]["k"],
                                                     np.float32), atol)


_RECURRENT_STATE = {"rglru": ("h", "conv"), "mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


@pytest.mark.parametrize("arch,dtype", [("olmoe-1b-7b", "float32"),
                                        ("phi3.5-moe-42b-a6.6b", "float32"),
                                        ("recurrentgemma-9b", "float32"),
                                        ("recurrentgemma-9b", "bfloat16"),
                                        ("xlstm-1.3b", "float32"), ("xlstm-1.3b", "bfloat16")])
def test_prefill_and_decode_new_kinds_over_agents(arch, dtype):
    """make_prefill_step then three make_decode_step calls for A = 3 agents
    against the reference's vmapped steps, for the MoE and recurrent
    configs: logits each step, and the caches after (the KV slots, and the
    recurrent states, fp32 whatever the KV dtype)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _agent_params(jcfg)
    s, b = 21, 2
    cap = s + 3
    kv = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    jcache = js.make_agent_cache(jcfg, A, b, cap, kv[dtype][0])
    tcache = ts.make_agent_cache(tcfg, A, b, cap, kv[dtype][1], device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (A, b, s + 3))
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    lj, jcache = js.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks[..., :s])}, jcache)
    lt, tcache = ts.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks[..., :s])},
                                            tcache)
    _close(lt, lj, atol)
    for t in range(s, s + 3):
        lj, jcache = js.make_decode_step(jcfg)(jp, jnp.asarray(toks[..., t:t + 1]),
                                               jnp.asarray(t), jcache)
        lt, tcache = ts.make_decode_step(tcfg)(tp, torch.from_numpy(toks[..., t:t + 1]), t,
                                               tcache)
        _close(lt, lj, atol)
    for kind, names in _RECURRENT_STATE.items():
        if kind not in tcache["stacks"]:
            continue
        for name in names:
            got = tcache["stacks"][kind][name]
            assert got.dtype == torch.float32, (kind, name)
            if dtype == "float32":
                want = np.asarray(jcache["stacks"][kind][name], np.float32)
                np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    for kind in ("moe", "local_attn"):
        if kind in tcache["stacks"]:
            np.testing.assert_array_equal(tcache["stacks"][kind]["pos"].numpy(),
                                          np.asarray(jcache["stacks"][kind]["pos"]))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_decode_writes_the_recurrent_state_in_place(arch):
    """A decode step writes each recurrent state into the cache's own
    tensors (the layer loop drops what a block returns): after the step the
    states differ from before, the tensors are the same objects, and a
    second step from them equals the reference's."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _agent_params(jcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (A, 2, 10))
    tcache = ts.make_agent_cache(tcfg, A, 2, 12, torch.float32, device="cpu")
    jcache = js.make_agent_cache(jcfg, A, 2, 12, jnp.float32)
    _, tcache = ts.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks[..., :8])},
                                           tcache)
    _, jcache = js.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks[..., :8])}, jcache)
    leaves = {(kind, name): tcache["stacks"][kind][name] for kind, names in
              _RECURRENT_STATE.items() if kind in tcache["stacks"] for name in names}
    before = {key: leaf.clone() for key, leaf in leaves.items()}
    for t in (8, 9):
        lt, out = ts.make_decode_step(tcfg)(tp, torch.from_numpy(toks[..., t:t + 1]), t, tcache)
        lj, jcache = js.make_decode_step(jcfg)(jp, jnp.asarray(toks[..., t:t + 1]),
                                               jnp.asarray(t), jcache)
        assert out is tcache
        _close(lt, lj, F32_ATOL)
    for (kind, name), leaf in leaves.items():
        assert tcache["stacks"][kind][name] is leaf
        if name != "m":  # the stabiliser may stay put
            assert not torch.equal(leaf, before[kind, name]), (kind, name)
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jcache["stacks"][kind][name]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_windowed_ring_and_int8_caches_over_agents(kv, monkeypatch):
    """window_override with a ring cache of capacity = window < S over A = 3
    agents, against the reference; and an int8 cache, held as
    tests/test_torch_zoo_int8.py holds it (the port's codes at most one
    apart, at the reference's ties; its decode on the reference's cache)
    at this test's draw, seed 2 (ROADMAP C.4)."""
    if kv == "int8":
        from test_torch_zoo_int8 import held_int8

        held_int8("qwen3-8b", 2, monkeypatch)
        return
    jcfg, tcfg = _cfgs("qwen3-8b")
    jp, tp = _agent_params(jcfg)
    s, window = 30, 8
    jcache = js.make_agent_cache(jcfg, A, 1, window, jnp.float32)
    tcache = ts.make_agent_cache(tcfg, A, 1, window, torch.float32, device="cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (A, 1, s + 2))
    lj, jcache = js.make_prefill_step(jcfg, window)(jp, {"tokens": jnp.asarray(toks[..., :s])},
                                                    jcache)
    lt, tcache = ts.make_prefill_step(tcfg, window)(
        tp, {"tokens": torch.from_numpy(toks[..., :s])}, tcache)
    _close(lt, lj, F32_ATOL)
    for t in (s, s + 1):
        lj, jcache = js.make_decode_step(jcfg, window)(jp, jnp.asarray(toks[..., t:t + 1]),
                                                       jnp.asarray(t), jcache)
        lt, tcache = ts.make_decode_step(tcfg, window)(tp, torch.from_numpy(toks[..., t:t + 1]),
                                                       torch.tensor(t), tcache)
        _close(lt, lj, F32_ATOL)
    np.testing.assert_array_equal(tcache["stacks"]["attn"]["pos"].numpy(),
                                  np.asarray(jcache["stacks"]["attn"]["pos"]))


def test_agent_folded_prefill_equals_per_agent_calls():
    _, tcfg = _cfgs("deepseek-7b")
    _, tp = _agent_params(_cfgs("deepseek-7b")[0])
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, tcfg.vocab_size, (A, 2, 24)))
    cache = ts.make_agent_cache(tcfg, A, 2, 30, torch.float32, device="cpu")
    logits, cache = ts.make_prefill_step(tcfg)(tp, {"tokens": toks}, cache)
    for a in range(A):
        one = tree_map(lambda x: x[a], tp)
        c1 = tm.init_cache(tcfg, 2, 30, torch.float32, device="cpu")
        l1, c1, _ = tm.forward(one, tcfg, toks[a], cache=c1, logits_tail=1)
        torch.testing.assert_close(logits[a], l1, atol=1e-5, rtol=0)
        torch.testing.assert_close(cache["stacks"]["attn"]["k"][a], c1["stacks"]["attn"]["k"],
                                   atol=1e-5, rtol=0)


# -- the synthetic token sampler ------------------------------------------------------


@pytest.mark.parametrize("dist", ["zipf", "uniform"])
def test_sampler_logits_bit_for_bit(dist):
    ref = j_sampler(1000, 2, 8, distribution=dist)
    impl = ref.__closure__[0].cell_contents.__wrapped__
    want = np.asarray(dict(zip(impl.__code__.co_freevars,
                               (c.cell_contents for c in impl.__closure__)))["logits"])
    got = lm_logits(1000, dist)
    assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32))
    with pytest.raises(ValueError):
        lm_logits(10, "bimodal")


def test_sampler_shapes_shift_seam_and_zipf_law():
    vocab, b, s = 5000, 8, 256
    sampler = make_lm_batch_sampler(vocab, b, s, n_agents=4, device="cpu")
    batch = sampler(torch.Generator().manual_seed(0), 0)
    assert batch["tokens"].shape == batch["targets"].shape == (4, b, s)
    assert batch["tokens"].dtype == torch.int32
    assert torch.equal(batch["tokens"][..., 1:], batch["targets"][..., :-1])
    again = sampler(torch.Generator().manual_seed(0), 7)
    assert torch.equal(again["tokens"], batch["tokens"])
    toks = np.random.default_rng(0).integers(0, vocab, (4, b, s + 1))
    injected = sampler(None, 0, toks=toks)
    assert np.array_equal(injected["tokens"].numpy(), toks[..., :-1])
    assert np.array_equal(injected["targets"].numpy(), toks[..., 1:])
    one = make_lm_batch_sampler(vocab, b, s, device="cpu")(torch.Generator().manual_seed(1), 0)
    assert one["tokens"].shape == (b, s)
    # chi-square of the draws against Zipf(1.2): the top 32 tokens and the rest
    draws = torch.cat([batch["tokens"].reshape(-1), batch["targets"][..., -1].reshape(-1)])
    counts = np.bincount(draws.numpy(), minlength=vocab).astype(np.float64)
    p = np.exp(lm_logits(vocab).astype(np.float64))
    p /= p.sum()
    obs = np.append(counts[:32], counts[32:].sum())
    exp = np.append(p[:32], p[32:].sum()) * counts.sum()
    chi2 = float(np.sum((obs - exp) ** 2 / exp))
    assert chi2 < 80.0, chi2
