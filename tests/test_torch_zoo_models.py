"""The port's model zoo (``repro_torch.models``) against the JAX package's
``repro.models`` on the CPU, at ``reduced()`` sizes, with the reference's
``init_params`` weights carried across by ``params_from_numpy``: the dense
kinds, and the MoE (OLMoE-1B-7B, Phi-3.5-MoE) and recurrent
(RecurrentGemma-9B, xLSTM-1.3B) configs.

Tolerances.  float32: modules at atol 1e-6; attention and logits at 1e-4
(the same fp32 arithmetic summed in another order; the port's prefill and
no-cache attention run the ``flash_attention`` plain version, one block,
where the reference runs ``chunked_attention`` over 512-key chunks).
bfloat16 compute: logits within BF16_ATOL = 0.125, four bf16 ulps at the
reduced models' logit scale (|logits| < 8, ulp 2^-5): both packages round
every matmul and the attention output to bf16, and a rounding tie decided
the other way moves a logit by an ulp (measured: at most 0.055).  The int8
KV quantiser: codes equal, scales within one float32 ulp.  The mirrors of
``tests/test_models.py`` keep its tolerances (5e-2 for decode against
forward, 1e-5 for ``window_override`` against ``local_attn``).

The MoE configs at bf16.  Routing is discrete: a router logit one bf16
place from a tie goes either way on a one-ulp change upstream, the token
then takes another expert (its logits move by ~1), and the capacity slots
of every later token of that agent shift with it.  The reference does not
agree with itself there (its jitted and eager forwards differ by up to
1.85 in a logit on these configs), so the bf16 MoE forward is held where
the routing is the same: both packages' top-k choices are read at every
layer (the reference run eagerly), every choice that differs must sit at a
near-tie of the reference's router logits (within 2^-5 of max(1,
|logit|), four bf16 places), and every token that no difference reaches
(its own kept experts at each layer, and a causal path from a differing
token through a later attention layer) is held to BF16_ATOL, with the NLL
over those tokens at rtol 1e-2; at least half the tokens must be held.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import modules as jmod  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

DENSE = ["qwen3-8b", "mistral-nemo-12b", "deepseek-7b", "granite-20b", "repro-100m"]
MOE = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
RECURRENT = ["recurrentgemma-9b", "xlstm-1.3b"]
NEW = MOE + RECURRENT
BF16_ATOL = 0.125
F32_ATOL = 1e-4


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jget(arch).reduced(), dtype=dtype, **kw),
            dataclasses.replace(tget(arch).reduced(), dtype=dtype, **kw))


def _params(jcfg, seed):
    p = jm.init_params(jcfg, jax.random.key(seed))
    return p, tm.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _toks(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want, atol, rtol=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# -- modules ------------------------------------------------------------------


def test_modules_against_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w = {"w_gate": rng.normal(size=(16, 24)).astype(np.float32) * 0.3,
         "w_up": rng.normal(size=(16, 24)).astype(np.float32) * 0.3,
         "w_down": rng.normal(size=(24, 16)).astype(np.float32) * 0.3}
    scale = rng.normal(size=(16,)).astype(np.float32)
    emb = rng.normal(size=(40, 16)).astype(np.float32)
    toks = rng.integers(0, 40, (2, 5))
    f32 = torch.float32
    _close(tmod.rmsnorm({"scale": _t(scale)}, _t(x)),
           jmod.rmsnorm({"scale": scale}, x), 1e-6)
    _close(tmod.swiglu({k: _t(v) for k, v in w.items()}, _t(x), f32),
           jmod.swiglu(w, x, jnp.float32), 1e-6)
    _close(tmod.linear({"w": _t(w["w_up"])}, _t(x), f32),
           jmod.linear({"w": w["w_up"]}, x, jnp.float32), 1e-6)
    _close(tmod.embed({"emb": _t(emb)}, _t(toks), f32),
           jmod.embed({"emb": emb}, toks, jnp.float32), 0)
    _close(tmod.unembed({"emb": _t(emb)}, _t(x), f32),
           jmod.unembed({"emb": emb}, x, jnp.float32), 1e-6)
    q = rng.normal(size=(2, 7, 3, 8)).astype(np.float32)
    pos = np.arange(3, 10)
    _close(tmod.rope(_t(q), _t(pos), 1e4), jmod.rope(q, jnp.asarray(pos), 1e4), 1e-6)
    logits = rng.normal(size=(2, 5, 40)).astype(np.float32)
    _close(tmod.softmax_xent(_t(logits), _t(toks)),
           jmod.softmax_xent(logits, jnp.asarray(toks)), 1e-4)


def test_modules_broadcast_over_the_agent_axis():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, 2, 5, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 16, 24)).astype(np.float32))
    scale = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    emb = torch.from_numpy(rng.normal(size=(3, 40, 16)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 40, (3, 2, 5)))
    for a in range(3):
        torch.testing.assert_close(tmod.matmul(x, w)[a], x[a] @ w[a], atol=1e-6, rtol=0)
        torch.testing.assert_close(tmod.rmsnorm({"scale": scale}, x)[a],
                                   tmod.rmsnorm({"scale": scale[a]}, x[a]), atol=0, rtol=0)
        torch.testing.assert_close(tmod.embed({"emb": emb}, toks, torch.float32)[a],
                                   emb[a][toks[a]], atol=0, rtol=0)


def test_truncated_normal_init():
    g = torch.Generator().manual_seed(0)
    w = tmod.truncated_normal_init(g, (256, 512), 1.0, lead=(2, 3))
    assert w.shape == (2, 3, 256, 512) and w.dtype == torch.float32
    std = 1.0 / 16.0  # scale / sqrt(fan_in = 256)
    assert float(w.abs().max()) <= 2 * std
    # a standard normal truncated to [-2, 2] has std 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01
    again = tmod.truncated_normal_init(torch.Generator().manual_seed(0), (256, 512), 1.0,
                                       lead=(2, 3))
    assert torch.equal(w, again)
    bf = tmod.truncated_normal_init(torch.Generator().manual_seed(0), (256, 512), 1.0,
                                    torch.bfloat16, lead=(2, 3))
    assert torch.equal(bf, w.to(torch.bfloat16))


# -- attention -------------------------------------------------------------------


@pytest.mark.parametrize("case", ["causal", "window", "offset_valid_positions", "pad", "gqa"])
def test_chunked_attention(case):
    """Against the reference; ``gqa``: the port reads 2 KV heads for 6 query
    heads where the reference is given them repeated (``_repeat_kv``)."""
    rng = np.random.default_rng(2)
    b, sq, sk, h, hd = 2, 5, 37, 6, 8
    if case in ("causal", "window", "pad"):
        sq = sk
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, 2 if case == "gqa" else h, hd)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    kw = dict(causal=True, chunk_size=16)
    if case == "window":
        kw["window"] = 6
    if case == "pad":
        kw["chunk_size"] = 512
    if case in ("offset_valid_positions", "gqa"):
        valid = rng.random((b, sk)) < 0.7
        kpos = rng.permutation(sk)[None].repeat(b, 0) + 3
        kw.update(q_offset=30, k_valid=valid, k_positions=kpos, window=12)
    rk, rv = (np.repeat(t, h // t.shape[2], axis=2) for t in (k, v))
    want = ja.chunked_attention(q, rk, rv, **{k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray)
                                                 else v_) for k_, v_ in kw.items()})
    got = ta.chunked_attention(_t(q), _t(k), _t(v), **{
        k_: (_t(v_) if isinstance(v_, np.ndarray) else v_) for k_, v_ in kw.items()})
    _close(got, want, 1e-5)


def test_int8_quantiser_codes_equal_scales_within_an_ulp():
    x = np.random.default_rng(3).normal(size=(4, 9, 2, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 floor
    jq, js = ja._quantize_kv(jnp.asarray(x))
    tq, ts = ta._quantize_kv(_t(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    js = np.asarray(js)
    assert np.all(np.abs(ts.numpy() - js) <= np.spacing(js))
    for tdt, jdt, rtol in ((torch.float32, jnp.float32, 2e-7), (torch.bfloat16, jnp.bfloat16,
                                                                2.0 ** -8)):
        back = ta._dequantize_kv(tq, ts, tdt)
        assert back.dtype == tdt  # one ulp of the scale, then one rounding to the dtype
        want = np.asarray(ja._dequantize_kv(jq, js, jdt)).astype(np.float32)
        _close(back, want, 0, rtol)


def _block_case(kv_dtype, cap, s, seed=4):
    jcfg, tcfg = _cfgs("qwen3-8b")
    p = ja.attn_init(jax.random.key(seed), jcfg)
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    x = np.random.default_rng(seed).normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    jdt = {"f32": jnp.float32, "int8": jnp.int8}[kv_dtype]
    tdt = {"f32": torch.float32, "int8": torch.int8}[kv_dtype]
    return (jcfg, tcfg, p, tp, x, ja.init_kv_cache(jcfg, 2, cap, jdt),
            ta.init_kv_cache(tcfg, 2, cap, tdt))


def _close_cache(got, want, atol_f32=1e-5):
    for name in want:
        atol = 0 if name in ("pos", "k", "v") and want[name].dtype != jnp.float32 else atol_f32
        _close(got[name].float(), np.asarray(want[name]).astype(np.float32), atol)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("cap", [24, 8], ids=["full", "ring"])
def test_attention_block_prefill_then_decode(kv_dtype, cap):
    """Prefill into the cache (full, and a ring buffer with cap < S), then two
    decode steps over it, against the reference branch for branch."""
    s = 12
    jcfg, tcfg, p, tp, x, jc, tc = _block_case(kv_dtype, cap, s + 2)
    window = cap if cap < s else 0
    y, jc = ja.attention_block(p, jnp.asarray(x[:, :s]), jcfg, window=window, cache=jc)
    ty, tc = ta.attention_block(tp, _t(x[:, :s]), tcfg, window=window, cache=tc)
    _close(ty, y, F32_ATOL)
    _close_cache(tc, jc)
    for t in (s, s + 1):
        pos = jnp.asarray([t])
        y, jc = ja.attention_block(p, jnp.asarray(x[:, t:t + 1]), jcfg, window=window,
                                   positions=pos, cache=jc)
        ty, tc = ta.attention_block(tp, _t(x[:, t:t + 1]), tcfg, window=window,
                                    positions=torch.tensor([t]), cache=tc)
        _close(ty, y, F32_ATOL)
        _close_cache(tc, jc)


@pytest.mark.parametrize("s", [20, 600])
def test_attention_block_without_cache(s):
    jcfg, tcfg, p, tp, x, _, _ = _block_case("f32", 1, s)
    y, _ = ja.attention_block(p, jnp.asarray(x), jcfg, window=7)
    ty, none = ta.attention_block(tp, _t(x), tcfg, window=7)
    assert none is None
    _close(ty, y, F32_ATOL)


def test_kernel_route_pads_refuses_a_non_causal_pad_and_has_no_backward():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 600, 2, 8)).astype(np.float32))
               for _ in range(3))
    got = ta.kernel_attention(q, k, v, causal=True, window=100)
    want = ta.chunked_attention(q, k, v, causal=True, window=100)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert ta._padded_len(600) == 1024 and ta._padded_len(512) == 512
    assert ta._padded_len(300) == 300
    with pytest.raises(ValueError, match="causal"):
        ta.kernel_attention(q, k, v, causal=False)
    ta.kernel_attention(q[:, :300], k[:, :300], v[:, :300], causal=False)  # no pad: fine
    qg = q.clone().requires_grad_()
    out = ta.kernel_attention(qg, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        out.sum().backward()


# -- the whole model ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + RECURRENT)
def test_forward_and_nll_against_the_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    p, tp = _params(jcfg, 0)
    toks = _toks(jcfg, (2, 33), 1)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    lj, _, aux = jm.forward(p, jcfg, jnp.asarray(toks))
    lt, cache, taux = tm.forward(tp, tcfg, _t(toks))
    assert cache is None and lt.dtype == torch.float32
    assert lt.shape == (2, 33, jcfg.padded_vocab) and float(taux) == float(aux) == 0.0
    _close(lt, lj, atol)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "loss_mask": (np.arange(32) % 3 > 0).astype(np.float32)[None].repeat(2, 0)}
    nj, _ = jm.nll_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    nt, _ = tm.nll_loss(tp, tcfg, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("s", [600, 512, 40])
def test_prefill_logits_tail_and_cache(s):
    """A prefill of S tokens into a cache: the last position's logits and
    the cache against the reference (S = 600 takes the kernel route's pad)."""
    jcfg, tcfg = _cfgs("qwen3-8b")
    p, tp = _params(jcfg, 2)
    toks = _toks(jcfg, (1, s), 3)
    jc = jm.init_cache(jcfg, 1, s + 4, jnp.float32)
    tc = tm.init_cache(tcfg, 1, s + 4, torch.float32, device="cpu")
    lj, jc, _ = jm.forward(p, jcfg, jnp.asarray(toks), cache=jc, logits_tail=1)
    lt, tc, _ = tm.forward(tp, tcfg, _t(toks), cache=tc, logits_tail=1)
    assert lt.shape == (1, 1, jcfg.padded_vocab)
    _close(lt, lj, F32_ATOL)
    _close_cache(tc["stacks"]["attn"], jc["stacks"]["attn"], F32_ATOL)


def test_a_tail_of_blocks_against_the_reference():
    jcfg, tcfg = _cfgs("deepseek-7b", n_layers=3, pattern=("attn", "local_attn"),
                       sliding_window=5)
    assert jcfg.tail == ("attn",)
    p, tp = _params(jcfg, 4)
    toks = _toks(jcfg, (2, 17), 5)
    lj, _, _ = jm.forward(p, jcfg, jnp.asarray(toks))
    lt, _, _ = tm.forward(tp, tcfg, _t(toks))
    _close(lt, lj, F32_ATOL)


def test_agent_stacked_forward_equals_per_agent_calls():
    _, tcfg = _cfgs("granite-20b")
    agents = [tm.init_params(tcfg, torch.Generator().manual_seed(a), device="cpu")
              for a in range(3)]
    from repro_torch.core.tree import tree_map
    stacked = tree_map(lambda *xs: torch.stack(xs), *agents)
    toks = _t(_toks(tcfg, (3, 2, 19), 6))
    out, _, _ = tm.forward(stacked, tcfg, toks)
    for a in range(3):
        one, _, _ = tm.forward(agents[a], tcfg, toks[a])
        torch.testing.assert_close(out[a], one, atol=1e-5, rtol=0)


def test_params_round_trip_and_layout():
    jcfg, tcfg = _cfgs("qwen3-8b")
    p = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.key(0)))
    tp = tm.params_from_numpy(p, device="cpu")
    back = tm.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    mine = tm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(tm.params_to_numpy(mine)) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(tm.params_to_numpy(mine)), jax.tree.leaves(p)):
        assert a.shape == b.shape and a.dtype == b.dtype
    bf = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), p)
    tbf = tm.params_from_numpy(bf, device="cpu")
    assert tbf["embed"]["emb"].dtype == torch.bfloat16
    assert np.array_equal(tm.params_to_numpy(tbf)["embed"]["emb"],
                          np.asarray(bf["embed"]["emb"]).astype(np.float32))


def test_params_from_numpy_defaults_to_the_card(monkeypatch):
    tree = {"w": np.ones((2, 3), np.float32)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.params_from_numpy(tree)
    asked = []

    def resolve(device=None):
        asked.append(device)
        return torch.device("cpu")

    from repro_torch.kernels import dispatch
    monkeypatch.setattr(dispatch, "resolve_device", resolve)
    out = tm.params_from_numpy(tree)
    assert asked == [None] and out["w"].device == torch.device("cpu")


def test_bf16_init_is_the_f32_draw_cast():
    _, tcfg = _cfgs("qwen3-8b")
    f32 = tm.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    bf = tm.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu",
                        dtype=torch.bfloat16)
    from repro_torch.core.tree import tree_leaves
    for a, b in zip(tree_leaves(f32), tree_leaves(bf)):
        assert torch.equal(a.to(torch.bfloat16), b)


# -- the MoE and recurrent configs -------------------------------------------------


def _record_routing(monkeypatch, module):
    """Each ``route_topk`` call's (router logits fp32, chosen experts) while
    ``module``'s is patched."""
    calls, orig = [], module.route_topk

    def route(logits, k):
        out = orig(logits, k)
        calls.append((_close_np(logits), np.asarray(out[1]).reshape(-1, k)))
        return out

    monkeypatch.setattr(module, "route_topk", route)
    return calls


def _close_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _kept(idx, cap, n_experts):
    """[T, k] chosen experts -> [T, k] kept (the token-major slot count)."""
    flat = idx.reshape(-1)
    seen = np.zeros(n_experts, int)
    keep = np.zeros(flat.shape, bool)
    for j, e in enumerate(flat):
        keep[j] = seen[e] < cap
        seen[e] += 1
    return keep.reshape(idx.shape)


def _routing_held_tokens(cfg, ref_calls, port_calls, b, s):
    """[b, s] mask of the tokens no routing difference reaches (see the
    module docstring); raises where a difference is not a near-tie."""
    cap = tmoe._capacity(b * s, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    reached = np.zeros((b, s), bool)
    assert len(ref_calls) == len(port_calls) == cfg.n_layers
    for layer, ((lj, ij), (_, it)) in enumerate(zip(ref_calls, port_calls)):
        kj, kt = _kept(ij, cap, cfg.n_experts), _kept(it, cap, cfg.n_experts)
        upstream = reached.copy()  # reached through an earlier layer
        for tok in range(b * s):
            row, pos = divmod(tok, s)
            chosen_j, chosen_t = set(ij[tok].tolist()), set(it[tok].tolist())
            if chosen_j != chosen_t and not upstream[row, pos]:
                for e_ref in chosen_j - chosen_t:
                    for e_port in chosen_t - chosen_j:
                        gap = abs(lj[tok, e_ref] - lj[tok, e_port])
                        assert gap <= 2.0 ** -5 * max(1.0, abs(lj[tok, e_ref])), (
                            f"layer {layer}, token {tok}: experts {e_ref} / {e_port}, "
                            f"reference logits {lj[tok]}")
            if set(ij[tok][kj[tok]].tolist()) != set(it[tok][kt[tok]].tolist()):
                reached[row, pos] = True
        if layer + 1 < cfg.n_layers:  # a later attention layer carries it along the row
            reached |= np.maximum.accumulate(reached, axis=1)
    return ~reached


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_and_nll_against_the_reference(arch, dtype, monkeypatch):
    jcfg, tcfg = _cfgs(arch, dtype)
    p, tp = _params(jcfg, 0)
    toks = _toks(jcfg, (2, 33), 1)
    lt, cache, taux = tm.forward(tp, tcfg, _t(toks))
    assert cache is None and lt.shape == (2, 33, jcfg.padded_vocab) and taux.shape == ()
    if dtype == "float32":
        lj, _, aux = jm.forward(p, jcfg, jnp.asarray(toks))
        _close(lt, lj, F32_ATOL)
        np.testing.assert_allclose(float(taux), float(aux), atol=1e-5, rtol=0)
        held = np.ones((2, 33), bool)
    else:
        ref_calls = _record_routing(monkeypatch, jmoe)
        port_calls = _record_routing(monkeypatch, tmoe)
        with jax.disable_jit():
            lj, _, aux = jm.forward(p, jcfg, jnp.asarray(toks))
        tm.forward(tp, tcfg, _t(toks))
        held = _routing_held_tokens(jcfg, ref_calls, port_calls, 2, 33)
        assert held.sum() >= held.size // 2, held.sum()
        np.testing.assert_allclose(_close_np(lt)[held], np.asarray(lj)[held], atol=BF16_ATOL,
                                   rtol=0)
        monkeypatch.undo()
    assert float(taux) > 0
    mask = held[:, :-1].astype(np.float32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "loss_mask": mask}
    with jax.disable_jit():
        nj, _ = jm.nll_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    nt, _ = tm.nll_loss(tp, tcfg, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("arch", NEW)
def test_agent_stacked_new_kinds_equal_per_agent_calls(arch):
    """Three agents with their own weights in one pass: logits and, for the
    MoE configs, one router loss per agent, each its own forward's."""
    _, tcfg = _cfgs(arch)
    agents = [tm.init_params(tcfg, torch.Generator().manual_seed(a), device="cpu")
              for a in range(3)]
    from repro_torch.core.tree import tree_map
    stacked = tree_map(lambda *xs: torch.stack(xs), *agents)
    toks = _t(_toks(tcfg, (3, 2, 19), 6))
    out, _, aux = tm.forward(stacked, tcfg, toks)
    assert aux.shape == (3,)
    for a in range(3):
        one, _, one_aux = tm.forward(agents[a], tcfg, toks[a])
        torch.testing.assert_close(out[a], one, atol=1e-5, rtol=0)
        torch.testing.assert_close(aux[a], one_aux, atol=1e-6, rtol=0)
    assert (float(aux.min()) > 0) == (arch in MOE)


@pytest.mark.parametrize("arch", NEW)
def test_new_kinds_params_round_trip_and_layout(arch):
    """The MoE and recurrent leaves (``router``, ``w_*`` [E, ...], ``lam_raw``,
    ``conv_*``, ``r_*`` [H, hd, hd], ``out_norm``) cross leaf for leaf; the
    port's own draw has the reference's tree."""
    jcfg, tcfg = _cfgs(arch)
    p = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.key(0)))
    back = tm.params_to_numpy(tm.params_from_numpy(p, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    mine = tm.params_to_numpy(tm.init_params(tcfg, torch.Generator().manual_seed(0),
                                             device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(p)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_a_recurrent_tail_against_the_reference():
    """RecurrentGemma's layout cut to 5 layers: one period of (rglru, rglru,
    local_attn) and a tail list (rglru, rglru), as the full config's 12
    periods and tail: forward, a prefill into the cache (the tail's states
    written in place) and two decode steps, against the reference."""
    jcfg, tcfg = _cfgs("recurrentgemma-9b", n_layers=5,
                       pattern=("rglru", "rglru", "local_attn"))
    assert jcfg.tail == ("rglru", "rglru")
    p, tp = _params(jcfg, 7)
    assert isinstance(tp["tail"], list) and len(tp["tail"]) == 2
    toks = _toks(jcfg, (2, 14), 8)
    lj, _, _ = jm.forward(p, jcfg, jnp.asarray(toks))
    lt, _, _ = tm.forward(tp, tcfg, _t(toks))
    _close(lt, lj, F32_ATOL)
    jc = jm.init_cache(jcfg, 2, 16, jnp.float32)
    tc = tm.init_cache(tcfg, 2, 16, torch.float32, device="cpu")
    lj, jc, _ = jm.forward(p, jcfg, jnp.asarray(toks[:, :12]), cache=jc, logits_tail=1)
    lt, tc, _ = tm.forward(tp, tcfg, _t(toks[:, :12]), cache=tc, logits_tail=1)
    _close(lt, lj, F32_ATOL)
    for t in (12, 13):
        lj, jc = jm.decode_step(p, jcfg, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t), jc)
        lt, tc = tm.decode_step(tp, tcfg, _t(toks[:, t:t + 1]), t, tc)
        _close(lt, lj, F32_ATOL)
    for i in range(2):
        for name in ("h", "conv"):
            _close(tc["tail"][i][name], np.asarray(jc["tail"][i][name], np.float32), 1e-5)
    _close(tc["stacks"]["rglru"]["h"], np.asarray(jc["stacks"]["rglru"]["h"]), 1e-5)


# -- mirrors of tests/test_models.py, inside the port ------------------------------


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-20b", "xlstm-1.3b", "recurrentgemma-9b"])
def test_decode_matches_forward(arch):
    _, cfg = _cfgs(arch)
    params = tm.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    b, s = 2, 12
    toks = _t(_toks(cfg, (b, s), 2))
    full, _, _ = tm.forward(params, cfg, toks)
    cache = tm.init_cache(cfg, b, capacity=s, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = tm.decode_step(params, cfg, toks[:, t:t + 1], t, cache)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=5e-2, rtol=5e-2)


def test_prefill_then_decode_continuation():
    _, cfg = _cfgs("qwen3-8b")
    params = tm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b, s = 2, 10
    toks = _t(_toks(cfg, (b, s + 2), 4))
    full, _, _ = tm.forward(params, cfg, toks)
    cache = tm.init_cache(cfg, b, capacity=s + 2, dtype=torch.float32, device="cpu")
    _, cache, _ = tm.forward(params, cfg, toks[:, :s], cache=cache)
    lg1, cache = tm.decode_step(params, cfg, toks[:, s:s + 1], torch.tensor(s), cache)
    lg2, cache = tm.decode_step(params, cfg, toks[:, s + 1:s + 2], s + 1, cache)
    torch.testing.assert_close(lg1[:, 0], full[:, s], atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(lg2[:, 0], full[:, s + 1], atol=5e-2, rtol=5e-2)


def test_sliding_window_ring_buffer_decode():
    _, base = _cfgs("qwen3-8b")
    cfg = dataclasses.replace(base, sliding_window=8, pattern=("local_attn", "local_attn"))
    cfg.validate()
    params = tm.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    toks = _t(_toks(cfg, (1, 24), 6))
    full, _, _ = tm.forward(params, cfg, toks)
    cache = tm.init_cache(cfg, 1, capacity=8, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(24):
        lg, cache = tm.decode_step(params, cfg, toks[:, t:t + 1], t, cache)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=5e-2, rtol=5e-2)


def test_window_override_matches_local_attn():
    _, base = _cfgs("deepseek-7b")
    params = tm.init_params(base, torch.Generator().manual_seed(7), device="cpu")
    toks = _t(_toks(base, (2, 20), 8))
    out_override, _, _ = tm.forward(params, base, toks, window_override=6)
    local = dataclasses.replace(base, pattern=("local_attn", "local_attn"), sliding_window=6)
    params_local = dict(params, stacks={"local_attn": params["stacks"]["attn"]})
    out_local, _, _ = tm.forward(params_local, local, toks)
    torch.testing.assert_close(out_override, out_local, atol=1e-5, rtol=1e-5)
