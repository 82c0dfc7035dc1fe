"""The model zoo's serving path on an NVIDIA GPU: prefill attention through
the ``flash_attention`` kernels (the kernel route) against its plain
version, and the agent-folded steps against per-agent calls.  A CUDA kernel
has no CPU mode, so every test here is marked ``cuda`` and skips without a
card.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_zoo_cuda.py

Tolerances: the route against the plain version at 2e-5 for f32 (the SIMT
kernel) and 2e-2 for bf16 (the tensor-core kernel; the output is rounded to
bf16), as ``tests/test_torch_kernels_cuda.py`` holds the kernel itself.
Agent-folded against per-agent calls: f32 1e-4 (cuBLAS may pick another
algorithm for another batch count), bf16 0.25 (8 bf16 ulps at |logits| < 8).
The card against the CPU for a whole reduced model (a Whisper's prefill and
decode steps among them): f32 1e-4, bf16 0.25.  The non-causal route of an
encoder or a cross-attention, at a ragged Sk, as the causal one.
The recurrent states a reduced RecurrentGemma or xLSTM wrote into its
cache over a prefill and four decode steps, card against CPU: f32 1e-4
(their logits, and the MoE configs', are held card against CPU by
``chip_smoke.py``'s phase 3.lm_zoo_reduced).  One f32 training round
(``launch.train``'s u > 1 form: eq. (6) on the kernel, then two local
steps) of each served kind at ``reduced()`` size, card against CPU: by
``chip_smoke.py``'s ``train_parity`` (1e-4, Adam's noise lanes within
2 u lr, at most 1% of the lanes beyond 1e-4), and the round on the agents'
tokens swapped must fail it.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LOGIT_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.25}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(arch, dtype):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=2, d_model=512, n_heads=8,
                               n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=64, d_ff=1024,
                               vocab_size=2048, dtype=str(dtype).removeprefix("torch."))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window", [(512, 0), (600, 0), (1025, 128), (64, 16)])
def test_kernel_route_against_the_plain_version(dev, dtype, s, window):
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn((2, 3, s, 8, 64), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, 3, s, 2, 64), generator=g, device=dev).to(dtype)
            .repeat_interleave(4, dim=-2) for _ in range(2))
    dispatch.reset_launch_counts()
    got = att.kernel_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["flash_attention"] == 1
    assert got.shape == q.shape and got.dtype == dtype
    heads = [t.reshape(6, s, 8, 64).transpose(1, 2) for t in (q, k, v)]
    want = fa.flash_attention_plain(*heads, causal=True, window=window).transpose(1, 2)
    err = (got.reshape(6, s, 8, 64).float() - want.float()).abs()
    assert bool(torch.all(err <= TOL[dtype] + TOL[dtype] * want.float().abs())), float(err.max())


@pytest.mark.cuda
def test_kernel_route_refuses_a_non_causal_pad_and_a_backward(dev):
    q = torch.randn((1, 600, 2, 64), device=dev)
    with pytest.raises(ValueError, match="causal"):
        att.kernel_attention(q, q, q, causal=False)
    qg = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        att.kernel_attention(qg, q, q, causal=True).sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(300, 300), (96, 300), (1, 300)],
                         ids=["encoder", "cross", "cross_decode"])
def test_full_route_against_the_plain_version(dev, dtype, sq, sk):
    """The encoder's and cross-attention's non-causal route
    (``kernel_attention_full``, block_q = Sq, block_k = Sk, nothing padded)
    at Sk = 300, a ragged key tile, and a ragged query tile at Sq = 96, and
    ``attention_block``'s cross-attention of one query row (a decode step:
    the plain ``chunked_attention``, no launch)."""
    g = torch.Generator(device=dev).manual_seed(sq + sk)
    q = torch.randn((2, 3, sq, 4, 64), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, 3, sk, 4, 64), generator=g, device=dev).to(dtype) for _ in range(2))
    heads = [t.reshape(6, t.shape[2], 4, 64).transpose(1, 2) for t in (q, k, v)]
    want = fa.flash_attention_plain(*heads, causal=False).transpose(1, 2)
    dispatch.reset_launch_counts()
    if sq > 1:
        got = att.kernel_attention_full(q, k, v)
    else:
        got = att.chunked_attention(q, k, v, causal=False, chunk_size=sk)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["flash_attention"] == (sq > 1)
    assert got.shape == q.shape and got.dtype == dtype
    err = (got.reshape(6, sq, 4, 64).float() - want.float()).abs()
    assert bool(torch.all(err <= TOL[dtype] + TOL[dtype] * want.float().abs())), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whisper_prefill_and_decode_card_against_the_cpu(dev, dtype):
    """A reduced Whisper (2 + 2 layers, d 256, 300 frames: the encoder's and
    the cross-attention's keys a ragged tile) for A = 2 agents: a prefill of
    40 tokens and two decode steps, each re-running the encoder, on the card
    against the CPU; 6 kernel launches a prefill (the encoder's, the
    decoder's and the cross-attention, two layers each), 2 a decode step."""
    cfg = dataclasses.replace(get_config("whisper-tiny").reduced(), encoder_seq=300,
                              dtype=str(dtype).removeprefix("torch."))
    agents = [tm.init_params(cfg, torch.Generator().manual_seed(a), device="cpu")
              for a in range(2)]
    params = tree_map(lambda *xs: torch.stack(xs).to(dtype), *agents)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2, 42)))
    frames = torch.from_numpy((rng.normal(size=(2, 2, 300, cfg.d_model)) * 0.1)
                              .astype(np.float32))
    outs = {}
    for device in (dev, torch.device("cpu")):
        p = tree_map(lambda x: x.to(device), params)
        fr = frames.to(device)
        cache = steps.make_agent_cache(cfg, 2, 2, 42, dtype=dtype, device=device)
        dispatch.reset_launch_counts()
        lg, cache = steps.make_prefill_step(cfg)(p, {"tokens": toks[..., :40].to(device),
                                                     "frames": fr}, cache)
        got = [lg]
        for t in (40, 41):
            lg, cache = steps.make_decode_step(cfg)(p, toks[..., t:t + 1].to(device), t, cache,
                                                    fr)
            got.append(lg)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert dispatch.launch_counts()["flash_attention"] == 6 + 2 * 2
        outs[device.type] = [x.cpu() for x in got]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, atol=LOGIT_TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-20b"])
def test_agent_folded_steps_equal_per_agent_calls(dev, arch, dtype):
    """One prefill and three decode steps for A = 3 agents in one pass (each
    kernel launched once a layer) against each agent's own calls."""
    cfg = _cfg(arch, dtype)
    agents = [tm.init_params(cfg, torch.Generator(device=dev).manual_seed(a), device=dev,
                             dtype=dtype) for a in range(3)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *agents)
    s = 600
    toks = torch.randint(0, cfg.vocab_size, (3, 2, s + 3), device=dev)
    cache = steps.make_agent_cache(cfg, 3, 2, s + 3, dtype=dtype, device=dev)
    dispatch.reset_launch_counts()
    logits, cache = steps.make_prefill_step(cfg)(stacked, {"tokens": toks[..., :s]}, cache)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["flash_attention"] == cfg.n_layers
    decoded = []
    for t in range(s, s + 3):
        lg, cache = steps.make_decode_step(cfg)(stacked, toks[..., t:t + 1], t, cache)
        decoded.append(lg)
    for a in range(3):
        c1 = tm.init_cache(cfg, 2, s + 3, dtype=dtype, device=dev)
        l1, c1, _ = tm.forward(agents[a], cfg, toks[a, :, :s], cache=c1, logits_tail=1)
        torch.testing.assert_close(logits[a], l1, atol=LOGIT_TOL[dtype], rtol=0)
        for i, t in enumerate(range(s, s + 3)):
            l1, c1 = tm.decode_step(agents[a], cfg, toks[a, :, t:t + 1], t, c1)
            torch.testing.assert_close(decoded[i][a], l1, atol=LOGIT_TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_against_the_cpu_and_decode_continuation(dev, dtype):
    """A reduced Qwen3-8B prefill (S = 600: the pad) and two decode steps on
    the card against the same steps on the CPU; decode at S against the
    prefill of S + 1."""
    cfg = _cfg("qwen3-8b", dtype)
    params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                            dtype=dtype)
    cpu_params = tree_map(lambda x: x.cpu(), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 603)))
    outs = {}
    for device, p in ((dev, params), (torch.device("cpu"), cpu_params)):
        cache = tm.init_cache(cfg, 2, 603, dtype=dtype, device=device)
        lg, cache, _ = tm.forward(p, cfg, toks[:, :600].to(device), cache=cache, logits_tail=1)
        d1, cache = tm.decode_step(p, cfg, toks[:, 600:601].to(device), 600, cache)
        d2, cache = tm.decode_step(p, cfg, toks[:, 601:602].to(device), 601, cache)
        outs[device.type] = [x.cpu() for x in (lg, d1, d2)]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, atol=LOGIT_TOL[dtype], rtol=0)
    full, _, _ = tm.forward(params, cfg, toks[:, :601].to(dev), logits_tail=1)
    torch.testing.assert_close(outs["cuda"][1], full.cpu(), atol=LOGIT_TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_recurrent_states_card_against_the_cpu(dev, arch):
    """Two agents' prefill of 64 tokens and four decode steps (the same
    tokens) at ``reduced()`` size and f32: every recurrent state the steps
    wrote into the cache, the tail's included, card against CPU."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    agents = [tm.init_params(cfg, torch.Generator().manual_seed(a), device="cpu")
              for a in range(2)]
    params = tree_map(lambda *xs: torch.stack(xs), *agents)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 2, 68)))
    caches = {}
    for device in (dev, torch.device("cpu")):
        p = tree_map(lambda x: x.to(device), params)
        cache = steps.make_agent_cache(cfg, 2, 2, 68, dtype=torch.float32, device=device)
        _, cache = steps.make_prefill_step(cfg)(p, {"tokens": toks[..., :64].to(device)}, cache)
        for t in range(64, 68):
            _, cache = steps.make_decode_step(cfg)(p, toks[..., t:t + 1].to(device), t, cache)
        caches[device.type] = cache
    recurrent = ("rglru", "mlstm", "slstm")
    pairs = [(caches["cuda"]["stacks"][kind], caches["cpu"]["stacks"][kind])
             for kind in recurrent if kind in cfg.pattern]
    pairs += [(caches["cuda"]["tail"][i], caches["cpu"]["tail"][i])
              for i, kind in enumerate(cfg.tail) if kind in recurrent]
    assert pairs
    for got, want in pairs:
        assert got.keys() == want.keys()
        for name in want:
            torch.testing.assert_close(got[name].cpu(), want[name], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["repro-100m", "olmoe-1b-7b", "recurrentgemma-9b",
                                  "xlstm-1.3b"])
def test_training_round_card_against_the_cpu(dev, arch):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    from repro_torch.data.pipeline import make_lm_batch_sampler
    from repro_torch.optim import adam

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    g = torch.Generator().manual_seed(0)
    state = steps.init_train_state(cfg, 2, adam(), g, device="cpu")
    state.posterior.mean[1] += 1e-2 * torch.randn(state.posterior.mean.shape[1], generator=g)
    sampler = make_lm_batch_sampler(cfg.vocab_size, 2, 32, n_agents=2, device="cpu")
    batches = [sampler(g, i) for i in range(2)]
    eps = [torch.randn(state.posterior.mean.shape, generator=g) for _ in range(2)]
    dispatch.reset_launch_counts()
    card, card_losses = cs.train_round(cfg, state, batches, eps, dev)
    assert dispatch.launch_counts()["consensus_fused_network"] == 1
    assert dispatch.launch_counts()["flash_attention"] == 0
    cpu, cpu_losses = cs.train_round(cfg, state, batches, eps, torch.device("cpu"))
    noise = functools.reduce(torch.logical_or,
                             [cs.adam_noise_lanes(x, y) for x, y in zip(card, cpu)])
    fields = cs.train_parity(card[-1], cpu[-1], noise, 2 * 2 * cs.TRAIN_LR)
    assert not fields["failures"], fields
    np.testing.assert_allclose(card_losses, cpu_losses, atol=1e-4, rtol=0)
    swapped = [{k: v.flip(0) for k, v in batch.items()} for batch in batches]
    wrong, _ = cs.train_round(cfg, state, swapped, eps, dev)
    assert cs.train_parity(wrong[-1], cpu[-1], noise, 2 * 2 * cs.TRAIN_LR)["failures"]
