"""Production step functions (port of ``repro.launch.steps``) over a
``BayesTrainState`` whose posterior is a ``FlatPosterior`` end to end (the
default), or a ``GaussianPosterior`` over the agent-stacked parameter dict
(``init_train_state(flat=False)``): one train round of the paper's rule
(``make_train_round_step``: eq. (6), then one Bayes-by-Backprop step from
that prior on the language-model objective), one local step against an
explicit prior (the LM objective, or a per-agent ``nll_fn``), the
standalone eq. (6) consensus; and, over the model zoo,
``init_train_state``, ``serve_params`` and the prefill and decode steps
for A agents at once.

Agent axis: the reference ``jax.vmap``s its steps over agents.  The
flash-attention kernels launch through raw pointers, which
``torch.func.vmap`` cannot trace, so the port carries the agents as the
leading axis of every params and cache leaf and of the tokens, and runs
them in one pass (``models.transformer``): each kernel launches once per
step for all agents.  A training step runs its autograd over agent blocks
(``vi.bayes_by_backprop.agent_blocks``: at most 1 GiB of ``[b, P]``
float32 a buffer, so repro-100m's two agents run one at a time), each
block's gradient that of its share of the mean over all A agents.

Noise seam: the LM steps take ``eps [A, P]``, one standard-normal draw an
agent (the reference's ``post_a.sample(key_a)``), or, for a pytree
posterior, a dict of ``[A, ...]`` draws shaped like its mean (the
reference's draw of each leaf); without it they draw from ``generator``
(a pytree's leaves in sorted-key order).  ``launch`` imports the model
zoo only inside the LM functions.

Placed inputs: where the params (prefill, decode) or the state's
posterior (the train round) are placed on a ``launch.mesh.Mesh`` by
``launch.spmd.device_put``, the step runs SPMD over its positions
(``launch.spmd_steps``), as the reference's ``jit`` reads its inputs'
shardings; tokens, caches, batches and ``eps`` given as plain tensors are
placed by the reference's specs on the way in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.flat import FlatPosterior, make_flat_nll
from repro_torch.core.posterior import consensus_all_agents, kl_gaussian_agents
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import spmd
from repro_torch.optim import Optimizer
from repro_torch.optim.schedules import Schedule
from repro_torch.vi.bayes_by_backprop import blocked_update, grads_like, vi_step

PyTree = Any


@dataclasses.dataclass
class BayesTrainState:
    """Leaves in ``jax.tree.leaves`` order: ``posterior.mean``,
    ``posterior.rho``, the optimizer state's, then ``step``."""

    posterior: FlatPosterior  # [A, P], or a GaussianPosterior of [A, ...] leaves
    opt_state: Any
    step: torch.Tensor  # 0-d int32: local steps taken

    def to(self, device) -> "BayesTrainState":
        """A copy of the whole state on ``device``."""
        return tree_map(lambda x: x.to(device, copy=True), self)


def _n_agents(posterior) -> int:
    return tree_leaves(posterior.mean)[0].shape[0]


def _lm_grad_fn(cfg, n_agents: int, kl_scale: float, bayesian: bool, remat: bool):
    """``blocked_update``'s ``grad_fn`` for the language-model objective
    (reference ``launch/steps.py:158-172``): per agent
    ``(nll + router_aux_weight aux ntok) / ntok + kl_scale KL(q || prior) /
    ntok`` on ``theta = mean + softplus(rho) eps`` (the mean and KL = 0 when
    not ``bayesian``), the prior held fixed; the gradient is that of the
    mean over all ``n_agents`` agents.  Flat or pytree blocks alike (the
    flat theta crosses to the parameter dict at ``layout.unflatten``).
    Metrics: (loss, nll / ntok, KL)."""
    from repro_torch.models import nll_loss

    def grad_fn(block, prior, batch: dict, eps):
        q = dataclasses.replace(
            block, mean=tree_map(lambda x: x.detach().requires_grad_(True), block.mean),
            rho=tree_map(lambda x: x.detach().requires_grad_(bayesian), block.rho))
        wrt = tree_leaves(q.mean) + (tree_leaves(q.rho) if bayesian else [])
        ntok = float(batch["targets"][0].numel())
        with torch.enable_grad():
            if bayesian:
                theta = q.sample(noise=eps)
                kl = kl_gaussian_agents(q, tree_map(torch.Tensor.detach, prior))
            else:
                theta = q.mean
                kl = torch.zeros(wrt[0].shape[0], dtype=torch.float32, device=wrt[0].device)
            params = block.layout.unflatten(theta) if isinstance(block, FlatPosterior) else theta
            nll, aux = nll_loss(params, cfg, batch, remat=remat)
            loss = (nll + cfg.router_aux_weight * aux * ntok) / ntok + kl_scale * kl / ntok
            grads = grads_like(q, wrt, loss.sum() / n_agents)
        return (loss.detach(), (nll / ntok).detach(), kl.detach()), grads

    return grad_fn


def _draw(post, eps, generator, bayesian: bool):
    """The step's noise: ``eps`` as given, else one standard-normal draw of
    the posterior's shape (a pytree's leaves in sorted-key order)."""
    if not bayesian:
        return None
    if eps is None:
        eps = tree_map(lambda m: torch.randn(m.shape, generator=generator, device=m.device),
                       post.mean)
    return eps


def _ring_axis(posterior_shardings) -> str:
    """The ring's mesh axis: the first spec entry of the posterior mean's
    sharding, else ``"pod"`` (the reference's rule)."""
    spec0 = getattr(getattr(posterior_shardings, "mean", None), "spec", None)
    return spec0[0] if spec0 and spec0[0] is not None else "pod"


def make_train_round_step(cfg, W, opt: Optimizer | None = None,
                          lr_schedule: Schedule | None = None, kl_scale: float = 1e-4,
                          remat: bool = True, bayesian: bool = True,
                          consensus_impl: str = "einsum", consensus_wire_dtype=None,
                          mesh=None, posterior_shardings=None):
    """One communication round of the paper's rule as one step:

        step_fn(state, batch, eps=None, generator=None)
            -> (state', {"loss": 0-d, "nll": [A], "kl": [A]})

    1. eq. (6) over the agent axis -> the prior (``consensus_impl``:
       ``"einsum"`` is ``core.posterior.consensus_all_agents``, the network
       kernel on the card for a flat posterior, the leaf loop for a pytree,
       or ``launch.consensus_opt.consensus_einsum_flat`` /
       ``consensus_einsum`` when ``consensus_wire_dtype`` is set;
       ``"ppermute"`` is ``consensus_ppermute_ring_flat`` for a flat
       posterior, over the axis of ``posterior_shardings.mean``'s first spec
       entry, else ``"pod"``, and ``consensus_ppermute_pod`` over ``mesh``'s
       ``"pod"`` axis with ``posterior_shardings`` for a pytree, wire bf16
       unless ``consensus_wire_dtype`` says otherwise; ``"none"`` keeps the
       posterior);
    2. one Bayes-by-Backprop step from that prior on the LM objective
       (``_lm_grad_fn``; the KL is against the prior itself, so 0), Adam on
       the prior.  ``nll`` is each agent's per token, ``loss`` the mean.

    ``bayesian=False`` is the deterministic baseline (decentralized
    FedAvg): the NLL at the posterior mean, KL = 0 and a zero gradient in
    rho, so from equal rho eq. (6) averages the means with W's weights.
    ``batch``: ``{"tokens", "targets"}`` ``[A, B, S]`` (and ``"frames"`` /
    ``"patches"`` ``[A, B, F or P, D]`` for an enc-dec or VLM config; a
    VLM's targets may cover the patches); ``eps [A, P]`` (flat) or a dict
    like the posterior's mean (pytree).  ``mesh`` is a ``launch.mesh.Mesh``
    (an ``AgentMesh`` serves the flat ring over its axis when the shardings
    name it), ``posterior_shardings`` the posterior's part of
    ``launch.sharding.param_shardings(state, mesh, agent_leading=True)``."""
    from repro_torch.optim import adam
    from repro_torch.optim.schedules import exponential_decay

    if consensus_impl not in ("einsum", "ppermute", "none"):
        raise ValueError(f"unknown consensus_impl {consensus_impl!r}")
    opt = opt or adam()
    lr_schedule = lr_schedule or exponential_decay(1e-3, 0.9999)
    if not isinstance(W, torch.Tensor):
        W = torch.as_tensor(W, dtype=torch.float32)
    n_agents = W.shape[0]
    grad_fn = _lm_grad_fn(cfg, n_agents, kl_scale, bayesian, remat)

    def consensus(post):
        if consensus_impl == "none":
            return post
        flat = isinstance(post, FlatPosterior)
        wire = consensus_wire_dtype
        if consensus_impl == "ppermute":
            if mesh is None:
                raise ValueError("consensus_impl='ppermute' needs the agent mesh")
            from repro_torch.launch import consensus_opt as co

            if flat:
                return co.consensus_ppermute_ring_flat(
                    post, mesh, _ring_axis(posterior_shardings), wire_dtype=wire or torch.bfloat16,
                    W=W)
            if posterior_shardings is None:
                raise ValueError("consensus_impl='ppermute' on a pytree posterior needs "
                                 "posterior_shardings")
            return co.consensus_ppermute_pod(post, W, mesh, posterior_shardings,
                                             wire_dtype=wire or torch.bfloat16)
        if wire is not None:
            from repro_torch.launch import consensus_opt as co

            return (co.consensus_einsum_flat(post, W, wire_dtype=wire) if flat
                    else co.consensus_einsum(post, W, wire_dtype=wire))
        return consensus_all_agents(post, W)

    def step_fn(state: BayesTrainState, batch: dict, eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        if spmd.is_placed(state.posterior.mean):
            from repro_torch.launch import spmd_steps

            return spmd_steps.train_round(
                cfg, state, batch, eps, generator, W=W, opt=opt, lr_schedule=lr_schedule,
                kl_scale=kl_scale, bayesian=bayesian, remat=remat, consensus_impl=consensus_impl,
                wire_dtype=consensus_wire_dtype)
        prior = consensus(state.posterior)
        new_post, opt_state, (losses, nll, kl) = blocked_update(
            prior, prior, opt, state.opt_state, grad_fn, batch,
            _draw(prior, eps, generator, bayesian), lr_schedule(state.step), state.step)
        return (BayesTrainState(posterior=new_post, opt_state=opt_state, step=state.step + 1),
                {"loss": losses.mean(), "nll": nll, "kl": kl})

    return step_fn


def make_local_step(cfg, opt: Optimizer, lr_schedule: Schedule, kl_scale: float = 1e-4,
                    remat: bool = True, *,
                    nll_fn: Callable[[PyTree, Any], torch.Tensor] | None = None,
                    n_mc_samples: int = 1):
    """One local VI step against an explicit prior (u > 1 rounds in
    ``launch.train``):

        step_fn(state, prior, batch, eps=None, generator=None) -> (state', loss)

    Default (``nll_fn=None``): the language-model objective on ``cfg``,
    ``make_train_round_step``'s against ``prior`` (per token, the gradient
    that of the mean over agents); ``loss`` is that mean, ``eps [A, P]``
    (a dict of ``[A, ...]`` draws for a pytree posterior).

    ``nll_fn`` (the ``api.LaunchEngine`` path; ``cfg`` unused): each
    agent's free energy ``kl_scale * KL(q||prior) + E_q[nll]`` (eq. 5,
    ``vi.free_energy`` over ``n_mc_samples`` samples); the gradient is that
    of their sum, so each agent's is its own; ``loss [A]``,
    ``eps [A, S, P]`` (a dict of ``[A, S, ...]`` leaves for a pytree
    posterior).  ``nll_fn(params, batch) -> [A]`` takes the parameter dict;
    a flat theta crosses to it at the model-apply boundary.

    Either way the optimizer takes the scalar ``state.step`` and the
    learning rate ``lr_schedule(state.step)``, and the noise is drawn from
    ``generator`` without ``eps``."""
    if nll_fn is None:
        if cfg is None:
            raise ValueError("make_local_step needs a model config or an nll_fn")

        def lm_step(state: BayesTrainState, prior: FlatPosterior, batch: dict,
                    eps: torch.Tensor | None = None, generator: torch.Generator | None = None):
            post = state.posterior
            grad_fn = _lm_grad_fn(cfg, _n_agents(post), kl_scale, True, remat)
            new_post, opt_state, (losses, _, _) = blocked_update(
                post, prior, opt, state.opt_state, grad_fn, batch,
                _draw(post, eps, generator, True), lr_schedule(state.step), state.step)
            return (BayesTrainState(posterior=new_post, opt_state=opt_state,
                                    step=state.step + 1), losses.mean())

        return lm_step

    def step_fn(state: BayesTrainState, prior: FlatPosterior, batch: dict,
                eps: torch.Tensor | None = None, generator: torch.Generator | None = None):
        post = state.posterior
        flat = isinstance(post, FlatPosterior)
        if eps is None:
            eps = tree_map(lambda m: torch.randn((m.shape[0], n_mc_samples) + tuple(m.shape[1:]),
                                                 generator=generator, device=m.device),
                           post.mean)
        new_post, opt_state, loss = vi_step(
            post, prior, opt, state.opt_state,
            make_flat_nll(nll_fn, post.layout) if flat else nll_fn, batch,
            lr_schedule(state.step), state.step, eps, kl_scale)
        return BayesTrainState(posterior=new_post, opt_state=opt_state,
                               step=state.step + 1), loss

    return step_fn


def make_consensus_step(cfg, W: torch.Tensor, wire_dtype=None):
    """Standalone eq. (6) over the agent axis, the communication phase of a
    round: ``core.posterior.consensus_all_agents``, which runs the fused
    network-wide kernel for a ``FlatPosterior`` on the card.  ``wire_dtype``
    compresses the exchanged (prec, prec*mu); f32/None is uncompressed."""
    del cfg  # consensus is model-independent

    def step_fn(posterior: FlatPosterior) -> FlatPosterior:
        return consensus_all_agents(posterior, W, wire_dtype=wire_dtype)

    return step_fn


# ---------------------------------------------------------------------------
# the model zoo: train state, serving weights, prefill and decode
# ---------------------------------------------------------------------------


def init_train_state(cfg, n_agents: int, opt: Optimizer, generator: torch.Generator | None = None,
                     init_sigma: float = 0.02, flat: bool = True, device=None) -> BayesTrainState:
    """Every agent starts from the same ``models.init_params`` draw: a
    ``FlatPosterior [A, P]`` (its ``FlatLayout`` the reference's for the
    same config) or, with ``flat=False``, a ``GaussianPosterior`` over the
    agent-stacked parameter dict."""
    from repro_torch.core.flat import flat_posterior_from_pytree
    from repro_torch.core.posterior import init_posterior
    from repro_torch.models import init_params

    params = init_params(cfg, generator, device=device)
    stacked = tree_map(lambda p: p.expand((n_agents,) + tuple(p.shape)), params)
    post = init_posterior(stacked, init_sigma=init_sigma)
    if flat:
        post = flat_posterior_from_pytree(post, leading_axes=1)
    else:
        post = tree_map(lambda x: x.contiguous(), post)
    return BayesTrainState(posterior=post, opt_state=opt.init(post),
                           step=torch.zeros((), dtype=torch.int32,
                                            device=params["embed"]["emb"].device))


def serve_params(posterior, dtype=torch.bfloat16) -> PyTree:
    """Posterior-mean weights cast for serving (the paper's L=1 predictive
    path).  A flat posterior is unflattened here: serving consumes the model
    dict, leaves ``[A, ...]``."""
    mean = posterior.mean
    if isinstance(posterior, FlatPosterior):
        mean = posterior.layout.unflatten(mean)
    return tree_map(lambda m: m.to(dtype), mean)


def make_prefill_step(cfg, window_override: int | None = None):
    """``(params [A, ...], batch {"tokens": [A, B, S][, "frames": [A, B, F,
    D], "patches": [A, B, P, D]]}, cache [A, ...]) -> (next-token logits
    [A, B, 1, V], cache)``; the cache is written in place (a VLM's slots
    hold the patches first)."""
    from repro_torch.models import forward

    def step_fn(params: PyTree, batch: dict, cache: PyTree):
        if spmd.is_placed(params):
            from repro_torch.launch import spmd_steps

            return spmd_steps.prefill(cfg, params, batch, cache, window_override)
        logits, cache, _ = forward(params, cfg, batch["tokens"], cache=cache,
                                   frames=batch.get("frames"), patches=batch.get("patches"),
                                   logits_tail=1, window_override=window_override)
        return logits, cache

    return step_fn


def make_decode_step(cfg, window_override: int | None = None):
    """``(params [A, ...], token [A, B, 1], position, cache, frames=None) ->
    (logits [A, B, 1, V], cache)``; ``position`` is one absolute position for
    every agent (an int or a 0-d tensor), counting a VLM's patches; an
    enc-dec config takes each agent's ``frames [A, B, F, D]`` and re-runs its
    encoder over them."""
    from repro_torch.models import decode_step

    def step_fn(params: PyTree, token: torch.Tensor, position, cache: PyTree, frames=None):
        if spmd.is_placed(params):
            from repro_torch.launch import spmd_steps

            return spmd_steps.decode(cfg, params, token, position, cache, frames, window_override)
        return decode_step(params, cfg, token, position, cache, enc_out_frames=frames,
                           window_override=window_override)

    return step_fn


def make_agent_cache(cfg, n_agents: int, batch_per_agent: int, capacity: int,
                     dtype=torch.bfloat16, device=None) -> PyTree:
    """Agent-stacked decode cache ``[A, ...]``, empty (positions -1)."""
    from repro_torch.models import init_cache

    return init_cache(cfg, batch_per_agent, capacity, dtype, device, n_agents=n_agents)
