"""Engine implementations behind ``api.Session`` (port of
``repro.api.engines``; this slice carries the synchronous ``SimulatedEngine``;
the event-driven ``gossip.engine.GossipEngine`` implements the same
protocol).

An Engine owns the state layout and the per-round transition; the Session
owns the loop, the data and the random generator.
"""
from __future__ import annotations

from typing import Any, Protocol

import torch

from repro_torch.api.models import ModelFns
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core.flat import FlatPosterior
from repro_torch.core.simulated import init_network, make_round_fn
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
