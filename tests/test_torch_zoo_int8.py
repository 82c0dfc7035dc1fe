"""The int8 KV cache of the port's LM serving steps against the JAX
package on the CPU, at ``reduced()`` sizes in float32, A = 3 agents with
distinct weights, over the three cache-carrying kinds: Qwen3-8B (``attn``),
OLMoE-1B-7B (``moe``) and RecurrentGemma-9B (``local_attn``: a ring of 8
slots, beside the recurrent states), at seeds 0-3 of the prompts.

Both packages quantise with the same formula, ``round(x / scale)`` with
``scale = absmax / 127``, but x comes from fp32 sums in another order, so
an x / scale within rounding of a half-integer can round either way: a
one-code flip, whose dequantised value is a scale (1/127 of the row's
absmax) apart, moves the logits past 1e-4 at some seeds (ROADMAP C.4).  So
the two are held apart:

* the port's own codes (the prefill's, and each decode step's new slot)
  against the reference's: at most one code apart, and in the prefill only
  where the reference's x / scale (its f32 cache's x over its int8 cache's
  scale) lies within ``TIE_ULPS`` ulps of the top binade's spacing
  (2^-17, [64, 128)) of a half-integer: measured at most 14 over these
  twelve cases, and the packages' x / scale agree within about 58;
* the port's decode on the reference's cache: before each step every
  leaf of the reference's cache is carried into the port's, and the new
  slot's codes and scales the port writes are replaced by the reference's
  before attention reads them; the logits are then held at ``F32_ATOL`` =
  1e-4, not loosened.  The prefill's logits (attention over the fresh
  k/v, not the cache) are held at 1e-4 too.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import steps as js  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402

A = 3
F32_ATOL = 1e-4
TIE_ULPS = 32
TIE_BAND = TIE_ULPS * 2.0 ** -17
CASES = {"qwen3-8b": (30, 1), "olmoe-1b-7b": (21, 2), "recurrentgemma-9b": (21, 2)}  # S, B
N_DECODE = 2
ATTN_KINDS = ("attn", "local_attn", "moe")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (dataclasses.replace(jget(arch).reduced(), dtype="float32"),
            dataclasses.replace(tget(arch).reduced(), dtype="float32"))


def _attention_layers(cfg):
    """(kind, period, offset) of each attention layer, in ``forward``'s order."""
    layers = []
    for p in range(cfg.n_periods):
        seen: dict = {}
        for kind in cfg.pattern:
            o = seen[kind] = seen.get(kind, -1) + 1
            if kind in ATTN_KINDS:
                layers.append((kind, p, o))
    assert not cfg.tail
    return layers


def _carry(tcache, jcache):
    """Every leaf of the reference's cache into the port's, in place."""
    for t, j in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
        t.copy_(torch.from_numpy(np.array(j)))


def _half_integer_distance(r):
    a = np.abs(r)
    return np.abs(a - np.floor(a) - 0.5)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """The configs, A agents' weights (agent a from key 10 + a) in both
    packages, and the reference's jitted steps: one compile a config."""
    jcfg, tcfg = _cfgs(arch)
    ps = [jm.init_params(jcfg, jax.random.key(10 + a)) for a in range(A)]
    jp = jax.tree.map(lambda *xs: jnp.stack(xs), *ps)
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return (jcfg, tcfg, jp, tp, jax.jit(js.make_prefill_step(jcfg)),
            jax.jit(js.make_decode_step(jcfg)))


def held_int8(arch, seed, monkeypatch):
    """The checks of the module docstring for one (config, seed); returns
    the number of prefill codes the two packages round apart."""
    s, b = CASES[arch]
    jcfg, tcfg, jp, tp, prefill, decode = _model(arch)
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (A, b, s + N_DECODE))
    cap = s + N_DECODE
    prompt = jnp.asarray(toks[..., :s])
    lj, jc = prefill(jp, {"tokens": prompt}, js.make_agent_cache(jcfg, A, b, cap, jnp.int8))
    _, jf = prefill(jp, {"tokens": prompt}, js.make_agent_cache(jcfg, A, b, cap, jnp.float32))
    tc = ts.make_agent_cache(tcfg, A, b, cap, torch.int8, device="cpu")
    lt, tc = ts.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks[..., :s])}, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=F32_ATOL, rtol=0)

    flips = 0
    for kind in tc["stacks"]:
        if kind not in ATTN_KINDS:
            continue
        valid = np.asarray(jc["stacks"][kind]["pos"]) >= 0
        for name in ("k", "v"):
            want = np.asarray(jc["stacks"][kind][name]).astype(np.int32)
            got = tc["stacks"][kind][name].numpy().astype(np.int32)
            assert np.abs(got - want).max() <= 1, (kind, name)
            apart = (got != want) & valid[..., None, None]
            scale = np.broadcast_to(np.asarray(jc["stacks"][kind][name + "_scale"])[..., None],
                                    apart.shape)
            r = np.asarray(jf["stacks"][kind][name])[apart] / scale[apart]
            assert np.all(_half_integer_distance(r) <= TIE_BAND), (
                kind, name, _half_integer_distance(r) / 2.0 ** -17)
            flips += int(apart.sum())

    layers = _attention_layers(tcfg)
    update = att.cache_update
    for t in range(s, s + N_DECODE):
        _carry(tc, jc)
        lj, jc = decode(jp, jnp.asarray(toks[..., t:t + 1]), jnp.asarray(t), jc)
        order = iter(layers)

        def carried(cache, k_new, v_new, position, order=order, jc=jc):
            update(cache, k_new, v_new, position)  # the port's codes for the new slot
            kind, p, o = next(order)
            ref = jc["stacks"][kind]
            for name in ("k", "v"):
                own = cache[name].numpy().astype(np.int32)
                assert np.abs(own - np.asarray(ref[name][:, p, o])).max() <= 1, (kind, name)
            for name, leaf in cache.items():
                leaf.copy_(torch.from_numpy(np.array(ref[name][:, p, o])))
            return cache

        monkeypatch.setattr(att, "cache_update", carried)
        lt, tc = ts.make_decode_step(tcfg)(tp, torch.from_numpy(toks[..., t:t + 1]), t, tc)
        monkeypatch.setattr(att, "cache_update", update)
        assert next(order, None) is None  # every attention layer wrote its slot once
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=F32_ATOL, rtol=0)
    return flips


@pytest.mark.parametrize("arch,seed", [
    (arch, seed) for arch in CASES for seed in range(4)
    if (arch, seed) != ("qwen3-8b", 2)])  # tests/test_torch_zoo_steps.py's int8 case
def test_int8_codes_and_decode_on_the_reference_cache(arch, seed, monkeypatch):
    held_int8(arch, seed, monkeypatch)
