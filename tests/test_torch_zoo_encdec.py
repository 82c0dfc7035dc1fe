"""The port's encoder-decoder kinds (``enc_attn``, ``dec_attn``) and modality
frontends (``audio_stub``, ``vision_stub``) against the JAX package on the
CPU: Whisper-tiny and Pixtral-12B at ``reduced()`` size (2 + 2 layers and
16 frames; 16 patches), the reference's weights carried across by
``models.params_from_numpy``, frames and patches ``normal x 0.1`` and
tokens from a numpy seed.

Tolerances, as tests/test_torch_zoo_models.py holds the other configs:
float32 logits atol 1e-4 (the same fp32 arithmetic summed in another
order: the port's encoder and cross-attention run the ``flash_attention``
plain version in one block where the reference runs ``chunked_attention``
over 512-key chunks); bf16 compute within BF16_ATOL = 0.125 (four bf16
ulps at the reduced models' logit scale); the mirrors of
tests/test_models.py keep its 5e-2; inside the port, agent-stacked against
each agent alone 1e-5.  The training side (the NLL and its gradient, a
round step, ``remat``) is in tests/test_torch_zoo_encdec_train.py, which
imports this file's helpers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import steps as js  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

ARCHS = ["whisper-tiny", "pixtral-12b"]
BF16_ATOL = 0.125
F32_ATOL = 1e-4
A = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jget(arch).reduced(), dtype=dtype),
            dataclasses.replace(tget(arch).reduced(), dtype=dtype))


def _params(jcfg, seed):
    p = jm.init_params(jcfg, jax.random.key(seed))
    return p, tm.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _agent_params(jcfg):
    """A agents' reference weights stacked on a leading axis, and the port's copy."""
    ps = [jm.init_params(jcfg, jax.random.key(10 + a)) for a in range(A)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *ps)
    return stacked, tm.params_from_numpy(jax.tree.map(np.asarray, stacked), device="cpu")


def _frontend(cfg, lead, seed):
    """The config's stub inputs ``[*lead, F or P, D]`` (``normal x 0.1``):
    {"frames": ...} for the audio stub, {"patches": ...} for the vision stub."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": (rng.normal(size=lead + (cfg.encoder_seq, cfg.d_model)) * 0.1)
                .astype(np.float32)}
    return {"patches": (rng.normal(size=lead + (cfg.n_patches, cfg.d_model)) * 0.1)
            .astype(np.float32)}


def _n_front(cfg):
    """Positions the frontend adds before the text (the patches)."""
    return cfg.n_patches if cfg.frontend == "vision_stub" else 0


def _toks(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in d.items()}


def _close(got, want, atol, rtol=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol)


# -- the pieces ---------------------------------------------------------------------


def test_sinusoid_against_the_reference():
    """The same fp32 operations in the same order; the two libraries' ``exp``
    may differ by an ulp in a frequency, which moves the angle at position
    p by up to p ulps of that frequency: held per row at 2^-22 (p + 1),
    two ulps of a frequency near 1 (exactly equal at p = 0, 1)."""
    pos = np.array([0, 1, 7, 223, 1499, 4095])
    got = ttr._sinusoidal(torch.from_numpy(pos), 384)
    want = np.asarray(jtr._sinusoidal(jnp.asarray(pos), 384))
    assert got.dtype == torch.float32 and got.shape == (6, 384)
    err = np.abs(got.numpy() - want).max(axis=1)
    assert np.all(err <= 2.0 ** -22 * (pos + 1)), err


@pytest.mark.parametrize("sq", [9, 1], ids=["prefill", "decode"])
def test_cross_attention_block_against_the_reference(sq, monkeypatch):
    """``attention_block(..., cross_x=)`` over 37 encoder rows (no RoPE, no
    mask, K/V from ``cross_x``): S = 9 takes ``kernel_attention_full``, a
    decode step's S = 1 the plain ``chunked_attention`` in one chunk."""
    jcfg, tcfg = _cfgs("whisper-tiny")
    p = ja.attn_init(jax.random.key(3), jcfg, cross=True)
    assert "q_norm" not in p
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, sq, jcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 37, jcfg.d_model)).astype(np.float32)
    pos = np.arange(5, 5 + sq)
    y, _ = ja.attention_block(p, jnp.asarray(x), jcfg, causal=False, positions=jnp.asarray(pos),
                              cross_x=jnp.asarray(enc), use_rope=False)
    calls = []
    orig = ta.kernel_attention_full

    def counted(*args):
        calls.append(args[0].shape)
        return orig(*args)

    monkeypatch.setattr(ta, "kernel_attention_full", counted)
    ty, none = ta.attention_block(tp, torch.from_numpy(x), tcfg, causal=False,
                                  positions=torch.from_numpy(pos),
                                  cross_x=torch.from_numpy(enc), use_rope=False)
    assert none is None and len(calls) == (sq > 1)
    _close(ty, y, F32_ATOL)


def test_full_kernel_route_ragged_lengths_and_the_causal_pad_still_refused():
    """``kernel_attention_full`` at Sq = 224 over Sk = 1500 and at S = Sk =
    600 (no pad either way) against ``chunked_attention``; ``kernel_attention``
    still refuses the non-causal pad of S = 600."""
    rng = np.random.default_rng(5)
    for sq, sk in ((224, 1500), (600, 600)):
        q = torch.from_numpy(rng.normal(size=(1, sq, 2, 16)).astype(np.float32))
        k, v = (torch.from_numpy(rng.normal(size=(1, sk, 2, 16)).astype(np.float32))
                for _ in range(2))
        got = ta.kernel_attention_full(q, k, v)
        assert got.shape == q.shape
        torch.testing.assert_close(got, ta.chunked_attention(q, k, v, causal=False),
                                   atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="causal"):
        ta.kernel_attention(q, k, v, causal=False)
    qg = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        ta.kernel_attention_full(qg, k, v).sum().backward()


# -- the whole model ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_against_the_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    p, tp = _params(jcfg, 0)
    toks = _toks(jcfg, (2, 21), 1)
    front = _frontend(jcfg, (2,), 2)
    lj, _, _ = jax.jit(lambda p, t, f: jm.forward(p, jcfg, t, **f))(p, jnp.asarray(toks),
                                                                  _j(front))
    lt, cache, aux = tm.forward(tp, tcfg, torch.from_numpy(toks), **_t(front))
    assert cache is None and float(aux) == 0.0 and lt.dtype == torch.float32
    assert lt.shape == (2, _n_front(jcfg) + 21, jcfg.padded_vocab)
    _close(lt, lj, F32_ATOL if dtype == "float32" else BF16_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_layouts(arch):
    """``enc_stack`` (leaves ``[encoder_layers, 1, ...]``), ``enc_norm``,
    ``dec_attn``'s ``norm_x`` / ``xattn`` (no qk-norm) and ``patch_proj``
    cross leaf for leaf; the port's own draw has the reference's tree, and
    its flat layout (``init_train_state``) is the reference's spec for spec."""
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
    extra = ("enc_norm", "enc_stack") if jcfg.is_encdec else ("patch_proj",)
    assert all(k in mine for k in extra)
    if jcfg.is_encdec:
        assert mine["enc_stack"]["attn"]["wq"].shape[:2] == (jcfg.encoder_layers, 1)
        assert set(mine["stacks"]["dec_attn"]) == {"norm1", "attn", "norm2", "mlp", "norm_x",
                                                   "xattn"}
    jstate = js.init_train_state(jax.random.key(0), jcfg, 2, jadam(), init_sigma=0.02)
    tstate = ts.init_train_state(tcfg, 2, adam(), torch.Generator().manual_seed(0),
                                 init_sigma=0.02, device="cpu")
    jl, tl = jstate.posterior.layout, tstate.posterior.layout
    assert [dataclasses.asdict(s) for s in tl.specs] == [dataclasses.asdict(s) for s in jl.specs]
    assert tl.to_doc() == jl.to_doc() and tl.n_params == jl.n_params


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_against_the_reference(arch):
    """A prefill of 10 tokens into a cache (after the patches for the VLM),
    then two decode steps (Whisper's encoder re-run over the frames each
    step), against the reference step by step: logits and the KV cache."""
    jcfg, tcfg = _cfgs(arch)
    p, tp = _params(jcfg, 3)
    toks = _toks(jcfg, (2, 12), 4)
    front = _frontend(jcfg, (2,), 5)
    n0 = _n_front(jcfg) + 10
    jc = jm.init_cache(jcfg, 2, n0 + 2, jnp.float32)
    tc = tm.init_cache(tcfg, 2, n0 + 2, torch.float32, device="cpu")
    lj, jc, _ = jax.jit(lambda p, t, c, f: jm.forward(p, jcfg, t, cache=c, logits_tail=1, **f))(
        p, jnp.asarray(toks[:, :10]), jc, _j(front))
    lt, tc, _ = tm.forward(tp, tcfg, torch.from_numpy(toks[:, :10]), cache=tc, logits_tail=1,
                           **_t(front))
    _close(lt, lj, F32_ATOL)
    frames = front.get("frames")
    jdecode = jax.jit(lambda p, t, pos, c, f: jm.decode_step(p, jcfg, t, pos, c,
                                                               enc_out_frames=f))
    for t in (10, 11):
        lj, jc = jdecode(p, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(n0 + t - 10), jc,
                         None if frames is None else jnp.asarray(frames))
        lt, tc = tm.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]), n0 + t - 10, tc,
                                enc_out_frames=None if frames is None
                                else torch.from_numpy(frames))
        _close(lt, lj, F32_ATOL)
    kind = jcfg.pattern[0]
    for name in ("k", "v", "pos"):
        _close(tc["stacks"][kind][name].float(),
               np.asarray(jc["stacks"][kind][name]).astype(np.float32), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_over_agents_against_the_reference(arch):
    """``make_prefill_step`` then two ``make_decode_step`` calls for A = 2
    agents with their own weights, the frames ``[A, B, F, D]`` (or patches)
    carried per agent, against the reference's vmapped steps."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _agent_params(jcfg)
    toks = _toks(jcfg, (A, 2, 10), 6)
    front = _frontend(jcfg, (A, 2), 7)
    cap = _n_front(jcfg) + 10
    jcache = js.make_agent_cache(jcfg, A, 2, cap, jnp.float32)
    tcache = ts.make_agent_cache(tcfg, A, 2, cap, torch.float32, device="cpu")
    lj, jcache = jax.jit(js.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks[..., :8]), **_j(front)}, jcache)
    lt, tcache = ts.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks[..., :8]),
                                                 **_t(front)}, tcache)
    assert lt.shape == (A, 2, 1, jcfg.padded_vocab)
    _close(lt, lj, F32_ATOL)
    frames = front.get("frames")
    jdecode = jax.jit(js.make_decode_step(jcfg))
    for t in (8, 9):
        pos = _n_front(jcfg) + t
        lj, jcache = jdecode(
            jp, jnp.asarray(toks[..., t:t + 1]), jnp.asarray(pos), jcache,
            None if frames is None else jnp.asarray(frames))
        lt, tcache = ts.make_decode_step(tcfg)(
            tp, torch.from_numpy(toks[..., t:t + 1]), pos, tcache,
            None if frames is None else torch.from_numpy(frames))
        _close(lt, lj, F32_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_agent_stacked_forward_equals_per_agent_calls(arch):
    """Three agents with their own weights in one pass (``enc_stack``'s axis
    of 1 under the agent axis) against each agent's own forward."""
    _, tcfg = _cfgs(arch)
    agents = [tm.init_params(tcfg, torch.Generator().manual_seed(a), device="cpu")
              for a in range(3)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *agents)
    toks = torch.from_numpy(_toks(tcfg, (3, 2, 11), 8))
    front = _t(_frontend(tcfg, (3, 2), 9))
    out, _, _ = tm.forward(stacked, tcfg, toks, **front)
    for a in range(3):
        one, _, _ = tm.forward(agents[a], tcfg, toks[a], **{k: v[a] for k, v in front.items()})
        torch.testing.assert_close(out[a], one, atol=1e-5, rtol=0)


# -- mirrors of tests/test_models.py, inside the port -------------------------------------


def test_whisper_decode_matches_forward():
    """tests/test_models.py:74-93 for Whisper: 12 decode steps, each
    re-running the encoder over constant frames, against one forward."""
    _, cfg = _cfgs("whisper-tiny")
    params = tm.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    b, s = 2, 12
    toks = torch.from_numpy(_toks(cfg, (b, s), 2))
    fr = torch.ones((b, cfg.encoder_seq, cfg.d_model)) * 0.1
    full, _, _ = tm.forward(params, cfg, toks, frames=fr)
    cache = tm.init_cache(cfg, b, capacity=s, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = tm.decode_step(params, cfg, toks[:, t:t + 1], t, cache, enc_out_frames=fr)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=5e-2, rtol=5e-2)


def test_vlm_prefill_then_decode():
    """tests/test_models.py:185-199: the patches prepended in the prefill;
    decode continues from the cache at the post-patch position."""
    _, cfg = _cfgs("pixtral-12b")
    params = tm.init_params(cfg, torch.Generator().manual_seed(9), device="cpu")
    b, s = 2, 8
    toks = torch.from_numpy(_toks(cfg, (b, s + 2), 10))
    patches = torch.from_numpy(_frontend(cfg, (b,), 11)["patches"])
    full, _, _ = tm.forward(params, cfg, toks, patches=patches)
    total0 = cfg.n_patches + s
    cache = tm.init_cache(cfg, b, capacity=total0 + 2, dtype=torch.float32, device="cpu")
    _, cache, _ = tm.forward(params, cfg, toks[:, :s], patches=patches, cache=cache)
    lg, cache = tm.decode_step(params, cfg, toks[:, s:s + 1], torch.tensor(total0), cache)
    torch.testing.assert_close(lg[:, 0], full[:, total0], atol=5e-2, rtol=5e-2)


def test_encdec_decode_with_frames():
    """tests/test_models.py:201-215: greedy decode consuming the encoder's
    output afresh each step: finite logits of the right shape."""
    _, cfg = _cfgs("whisper-tiny")
    params = tm.init_params(cfg, torch.Generator().manual_seed(12), device="cpu")
    b = 2
    fr = torch.from_numpy(_frontend(cfg, (b,), 13)["frames"])
    cache = tm.init_cache(cfg, b, capacity=8, dtype=torch.float32, device="cpu")
    tok = torch.zeros((b, 1), dtype=torch.long)
    for t in range(4):
        lg, cache = tm.decode_step(params, cfg, tok, t, cache, enc_out_frames=fr)
        assert lg.shape == (b, 1, cfg.padded_vocab) and bool(torch.isfinite(lg).all())
        tok = lg[..., :cfg.vocab_size].argmax(-1)


def test_missing_frames_and_unknown_kinds_raise():
    _, cfg = _cfgs("whisper-tiny")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="frame embeddings"):
        tm.forward(params, cfg, torch.zeros((1, 3), dtype=torch.long))
    for fn in (lambda: ttr.block_init(None, "conv", cfg),
               lambda: ttr.block_cache_init("enc_attn", cfg, 1, 4, device="cpu")):
        with pytest.raises(ValueError):
            fn()
