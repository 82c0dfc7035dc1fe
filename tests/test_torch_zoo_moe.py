"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe`` on the CPU, at ``reduced()`` sizes of
both MoE configs (OLMoE-1B-7B: 4 experts top-2 after the cut; Phi-3.5-MoE:
4 experts top-2), weights from the reference's ``moe_init`` carried across
by ``params_from_numpy``, inputs from numpy seeds.

Tolerances.  Routing (the top-k experts, which assignments drop) and
``_capacity``: exact.  float32 modules: 1e-5 (the same fp32 arithmetic,
summed in another order).  bf16 modules on identical inputs: the same
routing, the outputs within four bf16 places of |y| plus four of 1 (rtol =
atol = 2^-5): both round the expert products g, u and silu(g) u to bf16,
and a rounding decided the other way in one of the down product's d_ff
terms moves an output by an ulp or two (measured: at most 0.047 at
|y| = 3.98, 1.5 places).  The
mirror of ``tests/test_models.py::test_moe_capacity_factor_effect`` keeps
its tolerance (1e-4).  The agent-stacked FFN against per-agent calls:
1e-6 (another batching of the same products).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

MOE = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
BF16_ATOL = 2.0 ** -5


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jget(arch).reduced(), dtype=dtype, **kw),
            dataclasses.replace(tget(arch).reduced(), dtype=dtype, **kw))


def _params(jcfg, seed):
    p = jmoe.moe_init(jax.random.key(seed), jcfg)
    return p, tm.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _skewed(rng, shape):
    """Normal inputs plus one shared direction, so the router favours the
    same experts for every token and capacity binds."""
    return (rng.normal(size=shape) + 2.0 * rng.normal(size=shape[-1:])).astype(np.float32)


def _dropped(idx, cap, n_experts):
    """Assignments past their expert's capacity, in the token-major order of
    the reference's slot count (numpy, from the chosen experts)."""
    counts = np.zeros(n_experts, int)
    dropped = 0
    for e in np.asarray(idx).reshape(-1):
        dropped += counts[e] >= cap
        counts[e] += 1
    return dropped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_route_topk_and_load_balance_loss(arch, dtype):
    jcfg, _ = _cfgs(arch)
    logits = np.random.default_rng(0).normal(size=(3, 40, jcfg.n_experts)).astype(np.float32)
    jl = jnp.asarray(logits, dtype)
    tl = _t(logits).to(getattr(torch, dtype))
    for a in range(3):
        wj, ij, pj = jmoe.route_topk(jl[a], jcfg.top_k)
        wt, it, pt = tmoe.route_topk(tl[a], jcfg.top_k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6, rtol=0)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
        np.testing.assert_allclose(float(tmoe.load_balance_loss(pt, it, jcfg.n_experts)),
                                   float(jmoe.load_balance_loss(pj, ij, jcfg.n_experts)),
                                   atol=1e-6, rtol=0)
    # leading axes: one loss per agent
    _, it, pt = tmoe.route_topk(tl, jcfg.top_k)
    aux = tmoe.load_balance_loss(pt, it, jcfg.n_experts)
    assert aux.shape == (3,)
    for a in range(3):
        assert float(aux[a]) == float(tmoe.load_balance_loss(pt[a], it[a], jcfg.n_experts))


@pytest.mark.parametrize("n,e,k,f", [(66, 4, 2, 1.25), (8192, 64, 8, 1.25), (8194, 64, 8, 8.0),
                                     (2, 64, 8, 1.25), (16, 4, 2, 16.0), (8192, 16, 2, 1.25),
                                     (7, 3, 1, 0.5)])
def test_capacity(n, e, k, f):
    assert tmoe._capacity(n, e, k, f) == jmoe._capacity(n, e, k, f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_with_drops_against_the_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    p, tp = _params(jcfg, 0)
    b, s = 2, 33
    x = _skewed(np.random.default_rng(1), (b, s, jcfg.d_model))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    yj, aj = jmoe.moe_ffn(p, jnp.asarray(x, jdt), jcfg)
    yt, at = tmoe.moe_ffn(tp, _t(x).to(tdt), tcfg)
    assert yt.dtype == tdt and yt.shape == (b, s, jcfg.d_model) and at.shape == ()
    # the reference's routing on these inputs drops some assignments
    logits = jnp.asarray(x, jdt).reshape(-1, jcfg.d_model) @ p["router"].astype(jdt)
    _, idx, _ = jmoe.route_topk(logits, jcfg.top_k)
    cap = jmoe._capacity(b * s, jcfg.n_experts, jcfg.top_k, jcfg.capacity_factor)
    assert _dropped(idx, cap, jcfg.n_experts) > 0
    _, tidx, _ = tmoe.route_topk(_t(x).to(tdt).reshape(-1, jcfg.d_model) @ tp["router"].to(tdt),
                                 jcfg.top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    if dtype == "float32":
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(_f32(yt), _f32(yj), atol=BF16_ATOL, rtol=BF16_ATOL)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", MOE)
def test_ties_go_to_the_lower_expert(arch):
    """A zero router: every expert ties, so every token routes to experts
    0..k-1, each with weight 1/k, as ``jax.lax.top_k`` orders ties."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=16.0)
    p, tp = _params(jcfg, 1)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(2).normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    w, idx, _ = tmoe.route_topk(torch.zeros((18, jcfg.n_experts)), jcfg.top_k)
    assert torch.equal(idx, torch.arange(jcfg.top_k).expand(18, jcfg.top_k))
    assert torch.all(w == 1.0 / jcfg.top_k)
    # a partial tie: experts 1 and 3 tie above the rest, then 0 and 2
    tie = torch.tensor([[0.1, 0.5, 0.1, 0.5]])
    assert tmoe.route_topk(tie, 3)[1].tolist() == [[1, 3, 0]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(tie.numpy()), 3)[1]).tolist() == [[1, 3, 0]]
    yj, _ = jmoe.moe_ffn(p, jnp.asarray(x), jcfg)
    yt, _ = tmoe.moe_ffn(tp, _t(x), tcfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=0)


def test_moe_capacity_factor_effect():
    """Mirror of tests/test_models.py: at capacity factor 16 nothing drops
    and the dispatch equals the dense computation; the aux loss is positive."""
    _, cfg = _cfgs("olmoe-1b-7b", capacity_factor=16.0)
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 8, cfg.d_model))
                         .astype(np.float32))
    y, aux = tmoe.moe_ffn(p, x, cfg)

    def dense_ref(p, x):
        b, s, d = x.shape
        xt = x.reshape(-1, d)
        probs = torch.softmax(xt @ p["router"], -1)
        w, idx = torch.topk(probs, cfg.top_k)
        w = w / w.sum(-1, keepdim=True)
        g = torch.einsum("td,edf->tef", xt, p["w_gate"])
        u = torch.einsum("td,edf->tef", xt, p["w_up"])
        yo = torch.einsum("tef,efd->ted", torch.nn.functional.silu(g) * u, p["w_down"])
        sel = torch.take_along_dim(yo, idx[:, :, None], dim=1)
        return (sel * w[:, :, None]).sum(1).reshape(b, s, d)

    torch.testing.assert_close(y, dense_ref(p, x), atol=1e-4, rtol=1e-4)
    assert float(aux) > 0
    # and a lower factor drops assignments, so the output differs
    low, _ = tmoe.moe_ffn(p, x, dataclasses.replace(cfg, capacity_factor=0.25))
    assert not torch.allclose(low, y, atol=1e-3)


def test_agent_stacked_moe_ffn_equals_per_agent_calls():
    """Three agents with their own weights and inputs, with drops: the
    stacked call equals each agent's own call (its own capacity), and the
    reference's; folding the agents into the tokens would not."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    ps = [_params(jcfg, 10 + a) for a in range(3)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *[tp for _, tp in ps])
    x = _skewed(np.random.default_rng(3), (3, 2, 17, jcfg.d_model))
    y, aux = tmoe.moe_ffn(stacked, _t(x), tcfg)
    assert y.shape == x.shape and aux.shape == (3,)
    cap = jmoe._capacity(2 * 17, jcfg.n_experts, jcfg.top_k, jcfg.capacity_factor)
    for a, (jp, tp) in enumerate(ps):
        one, one_aux = tmoe.moe_ffn(tp, _t(x[a]), tcfg)
        torch.testing.assert_close(y[a], one, atol=1e-6, rtol=0)
        assert float(aux[a]) == float(one_aux)
        yj, aj = jmoe.moe_ffn(jp, jnp.asarray(x[a]), jcfg)
        np.testing.assert_allclose(y[a].numpy(), np.asarray(yj), atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(aux[a]), float(aj), atol=1e-6, rtol=0)
        _, idx, _ = jmoe.route_topk(jnp.asarray(x[a]).reshape(-1, jcfg.d_model)
                                    @ jp["router"], jcfg.top_k)
        assert _dropped(idx, cap, jcfg.n_experts) > 0
    folded, _ = tmoe.moe_ffn(ps[0][1], _t(x.reshape(1, 6, 17, -1)), tcfg)
    assert not torch.allclose(folded[0, :2], y[0], atol=1e-3)


def test_moe_init_matches_the_reference_tree():
    jcfg, tcfg = _cfgs("phi3.5-moe-42b-a6.6b")
    ref = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(0), jcfg))
    mine = tm.params_to_numpy(tmoe.moe_init(torch.Generator().manual_seed(0), tcfg,
                                            device="cpu", lead=(2,)))
    assert sorted(mine) == sorted(ref)
    for name in ref:
        assert mine[name].shape == (2,) + ref[name].shape and mine[name].dtype == np.float32
        std = 1.0 / np.sqrt(ref[name].shape[-2])  # scale / sqrt(fan_in), truncated at 2 std
        assert np.abs(mine[name]).max() <= 2 * std
        assert abs(mine[name].std() / std - 0.8796) < 0.05
