"""Engine implementations behind ``api.Session`` (port of
``repro.api.engines``): the synchronous ``SimulatedEngine``, the
production ``LaunchEngine`` (the same round through ``launch.steps``) and
paper Example 1's ``ConjugateLinregEngine``; the event-driven
``gossip.engine.GossipEngine`` implements the same protocol.

An Engine owns the state layout and the per-round transition; the Session
owns the loop, the data and the random generator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol

import torch

from repro_torch.api.data import DataBundle
from repro_torch.api.models import ModelFns
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core.flat import FlatPosterior
from repro_torch.core.posterior import FullCovGaussian, consensus_full_cov, linreg_bayes_update
from repro_torch.core.simulated import init_network, make_round_fn
from repro_torch.launch.steps import BayesTrainState, make_consensus_step, make_local_step
from repro_torch.optim import Optimizer, adam, sgd
from repro_torch.optim.schedules import Schedule, constant_schedule, exponential_decay


class Engine(Protocol):
    """Contract between ``Session`` and a runtime: ``init(generator) ->
    state``; ``run_round(state, batches, W, eps=None, generator=None) ->
    (state, per_agent_losses)``; ``posterior(state)``."""

    name: str

    def init(self, generator: torch.Generator, params=None) -> Any: ...

    def run_round(self, state: Any, batches: Any, W: torch.Tensor,
                  eps: torch.Tensor | None = None,
                  generator: torch.Generator | None = None) -> tuple[Any, torch.Tensor]: ...

    def posterior(self, state: Any) -> Any: ...


def build_optimizer(name: str) -> Optimizer:
    return {"adam": adam, "sgd": sgd}[name]()


def build_schedule(lr: float, decay: float) -> Schedule:
    if decay == 1.0:
        return constant_schedule(lr)
    return exponential_decay(lr, decay)


class SimulatedEngine:
    """``core.simulated`` flat runtime behind the Engine protocol."""

    name = "simulated"

    def __init__(self, spec: ExperimentSpec, model: ModelFns, n_agents: int, device):
        inf = spec.inference
        self.n_agents = n_agents
        self.model = model
        self.device = device
        self.opt = build_optimizer(inf.optimizer)
        self.init_sigma = inf.init_sigma
        self.shared_init = inf.shared_init
        self._round = make_round_fn(
            model.nll_fn,
            self.opt,
            build_schedule(inf.lr, inf.lr_decay),
            n_mc_samples=inf.n_mc_samples,
            kl_scale=inf.kl_scale,
            consensus=inf.consensus,
            wire_dtype=inf.wire_dtype,
        )

    def init(self, generator: torch.Generator, params=None):
        return init_network(
            generator, self.n_agents, self.model.init_fn, self.opt,
            init_sigma=self.init_sigma, shared_init=self.shared_init,
            device=self.device, params=params,
        )

    def run_round(self, state, batches, W, eps=None, generator=None):
        return self._round(state, batches, W, eps=eps, generator=generator)

    def posterior(self, state) -> FlatPosterior:
        return state.posterior


class LaunchEngine:
    """The production ``launch.steps`` path behind the Engine protocol: a
    ``BayesTrainState`` whose posterior is a ``FlatPosterior`` end to end, u
    ``make_local_step`` calls against the round prior, then
    ``make_consensus_step`` (the fused network-wide kernel on the card).

    It consumes the session generator exactly as ``SimulatedEngine`` does
    (the batches, then ``[N, S, P]`` noise per local step), so the two
    engines see the same draws from the same seed and agree to fp32
    rounding; the learning rate decays per round, ``base_sched(step // u)``,
    while the step counter ticks per local step."""

    name = "launch"

    def __init__(self, spec: ExperimentSpec, model: ModelFns, n_agents: int, device):
        inf = spec.inference
        if inf.consensus == "mean_only":
            raise ValueError(
                "the launch engine implements gaussian/none consensus; "
                "mean_only (the FedAvg baseline) runs on the simulated engine"
            )
        self.n_agents = n_agents
        self.model = model
        self.device = device
        self.opt = build_optimizer(inf.optimizer)
        self.init_sigma = inf.init_sigma
        self.shared_init = inf.shared_init
        self.consensus_mode = inf.consensus
        self.wire_dtype = inf.wire_dtype
        u = spec.data.local_updates
        base_sched = build_schedule(inf.lr, inf.lr_decay)
        self._local_step = make_local_step(
            None, self.opt, lambda step: base_sched(step // u), kl_scale=inf.kl_scale,
            nll_fn=model.nll_fn, n_mc_samples=inf.n_mc_samples,
        )

    def init(self, generator: torch.Generator, params=None):
        ns = init_network(
            generator, self.n_agents, self.model.init_fn, self.opt,
            init_sigma=self.init_sigma, shared_init=self.shared_init,
            device=self.device, params=params,
        )
        return BayesTrainState(posterior=ns.posterior, opt_state=ns.opt_state,
                               step=torch.zeros((), dtype=torch.int32, device=self.device))

    def run_round(self, state, batches, W, eps=None, generator=None):
        """u local steps against the round prior, then consensus when the
        mode is gaussian; ``eps [N, u, S, P]`` injects the noise.  Returns
        (state', per-agent mean loss over the u steps [N])."""
        u = next(iter(batches.values())).shape[1]
        prior = state.posterior  # q_i^{(n-1)}: consensus result of last round
        losses = []
        for t in range(u):
            state, loss_t = self._local_step(
                state, prior, {k: v[:, t] for k, v in batches.items()},
                eps=None if eps is None else eps[:, t], generator=generator)
            losses.append(loss_t)
        post = state.posterior
        if self.consensus_mode == "gaussian":
            post = make_consensus_step(None, W, wire_dtype=self.wire_dtype)(post)
        return dataclasses.replace(state, posterior=post), torch.stack(losses).mean(dim=0)

    def posterior(self, state) -> FlatPosterior:
        return state.posterior


class ConjugateLinregEngine:
    """Paper Example 1: exact conjugate Bayesian linear regression (eq. 2)
    with full-covariance consensus (eq. 6), all agents in one batched
    update and one batched solve."""

    name = "conjugate_linreg"

    def __init__(self, spec: ExperimentSpec, data: DataBundle, device):
        self.n_agents = data.n_agents
        self.d = data.dim
        self.device = device
        self.noise_var = float(data.dataset.noise_std) ** 2
        self.prior_var = spec.inference.prior_var
        self.consensus_mode = spec.inference.consensus

    def init(self, generator: torch.Generator, params=None) -> FullCovGaussian:
        del generator, params  # the conjugate prior is deterministic
        n, d = self.n_agents, self.d
        eye = torch.eye(d, dtype=torch.float32, device=self.device) / self.prior_var
        return FullCovGaussian(
            mean=torch.zeros((n, d), dtype=torch.float32, device=self.device),
            prec=eye.expand(n, d, d).clone(),
        )

    def run_round(self, state, batches, W, eps=None, generator=None):
        del eps, generator  # no draws in the conjugate round
        upd = linreg_bayes_update(state, batches["phi"], batches["y"], self.noise_var)
        if self.consensus_mode != "none":
            upd = consensus_full_cov(upd, W)
        err = torch.einsum("nbd,nd->nb", batches["phi"], upd.mean) - batches["y"]
        return upd, torch.mean(torch.square(err), dim=-1)

    def posterior(self, state) -> FullCovGaussian:
        return state
