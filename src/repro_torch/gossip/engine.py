"""``GossipEngine`` — the event-driven asynchronous runtime behind
``api.Session`` (port of the dense masked execution of
``repro.gossip.engine``).

One ``run_round`` call executes one EVENT WINDOW (``gossip.clocks``):
per-agent local Bayes-by-Backprop steps, then the masked active-edge
consensus (``core.flat.consensus_flat_masked`` — the CUDA kernel
``consensus_fused_masked`` on the card, its plain version on the CPU).  The
Session hands the engine the window's W-tilde exactly as it hands the
synchronous engine a scheduled W, but VERBATIM (``wants_host_w``): the
activity mask is the clock's host-exact ``window.active``, never re-derived
from a float32 W-tilde diagonal, which would drop any fired in-edge below
f32 resolution (``1.0 - w`` rounds back to 1.0 for ``w < 2^-24``) and with
it the agent's merge and, under ``local_policy="active"``, its training.

Equivalence ladder (pinned by the tests, bitwise, inside this package):
with an ``all_edges_trace`` clock every window's W-tilde is the base W and
every agent is active, so the trajectory equals ``SimulatedEngine``'s —
both run ``core.simulated.network_local_steps`` and the masked kernel's
active rows are the network kernel's.  A zero-event window passes the
posterior through, and zero-fault quarantine equals strict.

Local policies (``TopologySpec.clock["local_policy"]``): ``"all"`` (every
agent trains every window; only merges are event-driven) and ``"active"``
(wake-on-event: sleeping agents' posterior, optimizer state and step pass
through bitwise, and their loss is NaN, which ``Session.round`` skips).

Faults: a ``"faults"`` entry in the clock doc attaches ``gossip.faults``
churn (crashed agents freeze; the clock already rewired their W-tilde rows
to e_i) and payload corruption (the corrupted agents' transmitted (mean,
rho) are replaced by NaN/Inf/huge fills at the exchange boundary; resident
state intact).  ``InferenceSpec.fault_policy="strict"`` trusts the wire;
``"quarantine"`` validates every contribution
(``core.flat.consensus_flat_masked_quarantined``) and counts drops per
agent in ``GossipState.n_quarantined``.

Not here yet, and refused at construction: delayed delivery
(``max_delay > 0``), the edge-native ``segments`` execution and
``kind="sparse"`` clocks (ROADMAP queue A, gossip runtime), and the sharded
``ppermute`` execution (ROADMAP queue A, sharded windows).  PyTorch runs
eagerly, so the JAX engine's ``jax.jit`` of the window and its retrace
counter ``n_traces`` have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.flat import (
    FlatLayout,
    FlatPosterior,
    consensus_flat_masked,
    consensus_flat_masked_quarantined,
    make_flat_nll,
)
from repro_torch.core.simulated import init_network, network_local_steps, network_state_from_numpy
from repro_torch.core.tree import tree_map
from repro_torch.gossip.clocks import SparseClock

_LATER_GOSSIP = "arrives with ROADMAP queue A's gossip runtime item"
_LATER_SHARDED = "arrives with ROADMAP queue A's sharded windows item"


@dataclasses.dataclass
class GossipState:
    """Network state + per-agent gossip telemetry (agent-leading tensors).
    ``n_quarantined`` is ``None`` unless ``fault_policy="quarantine"``."""

    posterior: FlatPosterior  # [N, P]
    opt_state: Any
    step: torch.Tensor  # [N] int32 per-agent local step counter
    round: torch.Tensor  # scalar int32 window counter
    last_merge: torch.Tensor  # [N] int32 window index of last merge (-1 = never)
    n_merges: torch.Tensor  # [N] int32 total merges per agent
    n_quarantined: torch.Tensor | None = None  # [N] int32 dropped contributions

    def to(self, device) -> "GossipState":
        """A copy of the whole state on ``device``."""
        return tree_map(lambda x: x.to(device, copy=True), self)


def _agent_select(active: torch.Tensor, new, old):
    """Per-tensor ``where`` over agent-leading tensors (wake-on-event)."""
    def sel(a, b):
        return torch.where(active.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

    return tree_map(sel, new, old)


def gossip_state_from_numpy(mean, rho, *, layout: FlatLayout, mu=None, nu=None, step=None,
                            round=0, last_merge=None, n_merges=None, n_quarantined=None,
                            device=None) -> GossipState:
    """Carry a JAX-side ``GossipState`` across as numpy arrays: the
    ``network_state_from_numpy`` fields plus ``last_merge`` and ``n_merges``
    [N] (defaults -1 and 0) and ``n_quarantined`` [N] (``None`` under the
    strict policy)."""
    ns = network_state_from_numpy(mean, rho, layout=layout, mu=mu, nu=nu, step=step,
                                  round=round, device=device)
    n = ns.posterior.mean.shape[0]

    def ints(a, fill):
        a = np.full(n, fill, np.int32) if a is None else np.asarray(a, np.int32)
        return torch.from_numpy(a.copy()).to(device)

    return GossipState(
        posterior=ns.posterior, opt_state=ns.opt_state, step=ns.step, round=ns.round,
        last_merge=ints(last_merge, -1), n_merges=ints(n_merges, 0),
        n_quarantined=None if n_quarantined is None else ints(n_quarantined, 0),
    )


class GossipEngine:
    """Event-driven gossip runtime behind the Engine protocol: one event
    window per ``run_round``."""

    name = "gossip"
    # wake-on-event windows report NaN losses for sleeping agents;
    # Session.round aggregates NaN-safely for engines that set this
    loss_nan_is_sentinel = True
    # the Session hands run_round the w_schedule value VERBATIM (host
    # float64 w_eff): the exact active-mask lookup compares it in float64
    # with the clock's own window; the engine casts to the device itself
    wants_host_w = True

    def __init__(self, spec, model, n_agents: int, device):
        from repro_torch.api.engines import build_optimizer, build_schedule

        inf = spec.inference
        self.n_agents = n_agents
        self.model = model
        self.device = device
        self.opt = build_optimizer(inf.optimizer)
        self.init_sigma = inf.init_sigma
        self.shared_init = inf.shared_init
        self.consensus_mode = inf.consensus
        clock_doc = spec.topology.clock or {}
        self.local_policy = clock_doc.get("local_policy", "all")
        if self.local_policy not in ("all", "active"):
            raise ValueError(
                f"unknown gossip local_policy {self.local_policy!r}; known: all | active"
            )
        self.clock = spec.topology.gossip_clock()
        if isinstance(self.clock, SparseClock) or inf.consensus_impl == "segments":
            raise NotImplementedError(
                f"edge-native gossip (kind='sparse' clocks, segments) {_LATER_GOSSIP}"
            )
        if inf.consensus_impl == "ppermute":
            raise NotImplementedError(f"the sharded ppermute execution {_LATER_SHARDED}")
        if getattr(self.clock, "max_delay", 0) > 0:
            raise NotImplementedError(f"delayed delivery (max_delay > 0) {_LATER_GOSSIP}")
        if inf.history_dtype is not None:
            raise ValueError(
                "history_dtype sizes the delivery-latency posterior history ring; "
                'this clock has no delay (wrap it in {"kind": "delayed", ...} or '
                "drop history_dtype)"
            )
        # agent-level fault model attached by build_clock from the clock
        # doc's "faults" entry; None = no churn or corruption
        self.faults = getattr(self.clock, "faults", None)
        self.fault_policy = inf.fault_policy
        self.quarantine = inf.fault_policy == "quarantine"
        if (self.faults is not None and self.faults.spec.corrupt_rate > 0.0
                and self.consensus_mode != "gaussian"):
            raise ValueError(
                "payload corruption targets the gaussian (prec, prec*mu) exchange; "
                f"consensus={self.consensus_mode!r} exchanges no such payload (drop "
                "corrupt_rate or use gaussian consensus)"
            )
        self.wire_dtype = inf.wire_dtype
        self.lr_schedule = build_schedule(inf.lr, inf.lr_decay)
        self.n_mc, self.kl_scale = inf.n_mc_samples, inf.kl_scale
        # with no fault model and the strict policy the unguarded window runs
        # (zero-fault quarantine is bitwise the same, by the ladder)
        self._guarded = self.quarantine or self.faults is not None
        self.last_crashed = None

    # -- the window ----------------------------------------------------------

    def local_phase(self, state: GossipState, batches, active, eps, generator, up=None):
        """Per-agent local VI steps + the wake-on-event / fault select: the
        synchronous round's ``network_local_steps``, then selects that are
        identities when every agent trains."""
        nll = make_flat_nll(self.model.nll_fn, state.posterior.layout)
        lr = self.lr_schedule(state.round)
        post, opt_state, losses = network_local_steps(
            state.posterior, state.posterior, self.opt, state.opt_state, nll, batches, lr,
            state.step, n_samples=self.n_mc, kl_scale=self.kl_scale, eps=eps,
            generator=generator,
        )
        u = next(iter(batches.values())).shape[1]
        nan = torch.tensor(float("nan"), device=losses.device)
        if up is not None:
            # crashed agents freeze: no training, no merge, NaN loss
            train = (active & up) if self.local_policy == "active" else up
            post = _agent_select(train, post, state.posterior)
            opt_state = _agent_select(train, opt_state, state.opt_state)
            step = torch.where(train, state.step + u, state.step)
            losses = torch.where(train, losses, nan)
            active = active & up
        elif self.local_policy == "active":
            post = _agent_select(active, post, state.posterior)
            opt_state = _agent_select(active, opt_state, state.opt_state)
            step = torch.where(active, state.step + u, state.step)
            losses = torch.where(active, losses, nan)
        else:
            step = state.step + u
        return post, opt_state, step, active, losses

    def finish(self, state, post, opt_state, step, active, n_quarantined=None) -> GossipState:
        merged = active if self.consensus_mode != "none" else torch.zeros_like(active)
        return GossipState(
            posterior=post, opt_state=opt_state, step=step, round=state.round + 1,
            last_merge=torch.where(merged, state.round, state.last_merge),
            n_merges=state.n_merges + merged.to(torch.int32),
            n_quarantined=n_quarantined,
        )

    def _mean_only(self, post, W, active):
        act = active[:, None]
        return dataclasses.replace(
            post, mean=torch.where(act, W @ post.mean, post.mean),
            rho=torch.where(act, W @ post.rho, post.rho),
        )

    def window_fn(self, state, batches, W, active, eps=None, generator=None):
        post, opt_state, step, active, losses = self.local_phase(
            state, batches, active, eps, generator)
        if self.consensus_mode == "gaussian":
            post = consensus_flat_masked(post, W, active, wire_dtype=self.wire_dtype)
        elif self.consensus_mode == "mean_only":
            post = self._mean_only(post, W, active)
        return self.finish(state, post, opt_state, step, active), losses

    def window_fn_guarded(self, state, batches, W, active, eps=None, generator=None, *,
                          up, corrupt, fill_mean, fill_rho):
        """Fault-aware window: ``up`` gates local training, ``corrupt`` and
        the fills replace the corrupted agents' wire payloads (resident state
        intact), quarantine validates the exchange.  All-up, no-corruption
        inputs make every extra op a value-identity."""
        post, opt_state, step, active, losses = self.local_phase(
            state, batches, active, eps, generator, up)
        n_q = state.n_quarantined
        if self.consensus_mode == "gaussian":
            c = corrupt[:, None]
            mean_src = torch.where(c, fill_mean[:, None], post.mean)
            rho_src = torch.where(c, fill_rho[:, None], post.rho)
            if self.quarantine:
                post, valid_src = consensus_flat_masked_quarantined(
                    post, W, active, mean_src=mean_src, rho_src=rho_src,
                    wire_dtype=self.wire_dtype,
                )
                n_q = n_q + (~valid_src).to(torch.int32)
            else:
                # strict: the wire is trusted verbatim, so the garbage reaches
                # every receiver; non-merging agents keep their resident state
                merged = consensus_flat_masked(
                    dataclasses.replace(post, mean=mean_src, rho=rho_src), W, active,
                    wire_dtype=self.wire_dtype,
                )
                act = active[:, None]
                post = dataclasses.replace(
                    post, mean=torch.where(act, merged.mean, post.mean),
                    rho=torch.where(act, merged.rho, post.rho),
                )
        elif self.consensus_mode == "mean_only":
            post = self._mean_only(post, W, active)
        return self.finish(state, post, opt_state, step, active, n_q), losses

    # -- Engine protocol -----------------------------------------------------

    def init(self, generator: torch.Generator, params=None) -> GossipState:
        ns = init_network(
            generator, self.n_agents, self.model.init_fn, self.opt,
            init_sigma=self.init_sigma, shared_init=self.shared_init,
            device=self.device, params=params,
        )
        n, dev = self.n_agents, ns.step.device
        return GossipState(
            posterior=ns.posterior, opt_state=ns.opt_state, step=ns.step, round=ns.round,
            last_merge=torch.full((n,), -1, dtype=torch.int32, device=dev),
            n_merges=torch.zeros((n,), dtype=torch.int32, device=dev),
            n_quarantined=(torch.zeros((n,), dtype=torch.int32, device=dev)
                           if self.quarantine else None),
        )

    def _fault_arrays(self, r: int):
        """Host-side fault draws of window ``r`` (pure functions of (seed, r))
        as device tensors; records ``last_crashed`` for ``Session.round``."""
        n = self.n_agents
        if self.faults is None:
            up, corrupt = np.ones(n, bool), np.zeros(n, bool)
            fm = fr = np.zeros(n, np.float32)
        else:
            up, corrupt = self.faults.up(r), self.faults.corrupted(r)
            fm, fr = self.faults.fills(r)
        self.last_crashed = ~up
        return {k: torch.as_tensor(np.asarray(a), device=self.device) for k, a in
                (("up", up), ("corrupt", corrupt), ("fill_mean", fm), ("fill_rho", fr))}

    def _host_active(self, r: int, W) -> np.ndarray:
        """The host-exact [N] activity mask of window ``r``: the clock's
        ``window.active`` when ``W`` is the clock's own host float64 w_eff
        (what the Session hands over verbatim); for a foreign W the diagonal
        test, in float64, never on a float32 cast."""
        if isinstance(W, torch.Tensor):  # a device W is foreign by definition
            return np.diagonal(W.cpu().numpy().astype(np.float64)) < 1.0
        w64 = np.asarray(W, np.float64)
        if isinstance(W, np.ndarray) and W.dtype == np.float64:
            win = self.clock.window(r)
            if np.array_equal(w64, np.asarray(win.w_eff, np.float64)):
                return np.asarray(win.active)
        return np.diagonal(w64) < 1.0

    def run_round(self, state, batches, W, eps=None, generator=None):
        r = int(state.round)
        active = torch.as_tensor(self._host_active(r, W), device=self.device)
        W = torch.as_tensor(W, dtype=torch.float32).to(self.device)
        if self._guarded:
            return self.window_fn_guarded(state, batches, W, active, eps, generator,
                                          **self._fault_arrays(r))
        return self.window_fn(state, batches, W, active, eps, generator)

    def posterior(self, state) -> FlatPosterior:
        return state.posterior

    # -- telemetry -----------------------------------------------------------

    def staleness(self, state) -> np.ndarray:
        """[N] windows since each agent's last merge (never merged = the age
        of the whole run)."""
        n = int(state.round)
        last = state.last_merge.cpu().numpy()
        return np.where(last >= 0, (n - 1) - last, n).astype(np.int64)

    def telemetry(self, state) -> dict:
        """Merged into ``Session.evaluate`` under ``"engine"``: staleness
        percentiles, merge counts, and the fault block when guarded."""
        age = self.staleness(state)
        merges = state.n_merges.cpu().numpy()
        out = {
            "staleness": {
                "p50": float(np.percentile(age, 50)),
                "p90": float(np.percentile(age, 90)),
                "max": int(age.max()),
                "mean": float(age.mean()),
            },
            "merges": {
                "per_agent_mean": float(merges.mean()),
                "min": int(merges.min()),
                "total": int(merges.sum()),
            },
            "windows": int(state.round),
        }
        if self.wire_dtype != "f32":
            out["wire_dtype"] = self.wire_dtype
        if self._guarded:
            nw = int(state.round)
            faults: dict = {"policy": self.fault_policy}
            if self.faults is not None:
                uptime = self.faults.uptime(nw)
                faults["uptime"] = {
                    "per_agent": [int(v) for v in uptime],
                    "frac_mean": (float(uptime.mean()) / nw if nw else 1.0),
                    "min": int(uptime.min()) if nw else 0,
                }
                faults["currently_down"] = (
                    int(self.faults.crashed(nw - 1).sum()) if nw else 0
                )
            if state.n_quarantined is not None:
                nq = state.n_quarantined.cpu().numpy()
                faults["quarantined"] = {
                    "per_agent": [int(v) for v in nq],
                    "total": int(nq.sum()),
                }
            out["faults"] = faults
        return out
