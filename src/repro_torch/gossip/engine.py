"""``GossipEngine`` — the event-driven asynchronous runtime behind
``api.Session`` (port of ``repro.gossip.engine``).

One ``run_round`` call executes one EVENT WINDOW (``gossip.clocks``):
per-agent local Bayes-by-Backprop steps, then the window's consensus, in
one of four executions (the same eq. (6)):

* dense masked (``InferenceSpec.consensus_impl="auto"|"masked"``):
  ``core.flat.consensus_flat_masked``, the CUDA kernel
  ``consensus_fused_masked`` on the card, its plain version on the CPU;
* sharded (``consensus_impl="ppermute"``): the agent axis is block-sharded
  over an ``("agents",)`` mesh (``launch.mesh.AgentMesh``: the session's
  ``devices``, every card of its type by default, where an entry may
  repeat: a virtual shard) and the consensus runs as
  ``launch.consensus_opt.consensus_ppermute_window``: one rotation of the
  shards' wire-dtype statistics per fired cross-shard offset of the window,
  then each shard's rows reduced by ``consensus_fused_shard``.  The local
  phase runs first on the session's device, as its own step; the state
  stays resident there, and each window moves the shards' blocks out and
  back;
* delayed delivery (a ``{"kind": "delayed", ...}`` clock, ``max_delay >
  0``): the window's post-local, pre-merge posterior is written into slot
  ``round mod K`` of a ``[K, N, P]`` history ring (``K = max_delay + 1``,
  resident at ``history_dtype``), then each event merges its source's row
  as of its fire window (``core.flat.consensus_flat_delayed``);
* edge-native segments (``consensus_impl="segments"``, the ``"auto"``
  choice for ``kind="sparse"`` topologies with a clock): the window is the
  ``SparseWindow``'s fired edge list plus N self terms, and nothing
  ``[N, N]`` exists on the host or the card
  (``core.flat.consensus_flat_segments``).

The delayed and segment windows run ``consensus_fused_segments``
(``csrc/consensus_segments.cu``): the reference's XLA scatter-add becomes
one ragged, destination-sorted sum in a fixed order, so a window gives the
same bits every run on the card.  The
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

Retrace telemetry: the JAX engine jits its window and counts the traces
of the shared local phase (``n_traces``; one for a whole run, since every
window of a run has the same static shapes).  The port runs eagerly, and
its ``n_traces`` keeps that meaning: the number of distinct signatures (the
shapes and dtypes of the state, the batches and the activity mask, and
whether the fault gate is in) that the shared local phase has run.  Where
the JAX engine pins one trace, the port counts one.

Observability (``engine.obs``, attached by ``build_session`` when
``spec.obs.enabled``): each window runs in a ``gossip.window_build`` span
(the window lookup, the host's fault draws and the host-to-card copies)
and a ``gossip.window`` span whose
``impl`` is ``masked``, ``delayed`` or ``segments``, split into a
``gossip.local_phase`` span (the local steps and the fault select) and a
``gossip.consensus`` span (the merge with its fills, quarantine and
count); a sharded window runs in a ``gossip.local_phase`` and a
``gossip.consensus`` span, both with ``impl="ppermute"``.  After it the
``gossip.windows`` counter and the ``gossip.jit_traces`` gauge
(``n_traces``) are updated.  No span synchronises the card (each records
its device time with timing events, ``obs.trace``); nothing of it touches
the window's tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.flat import (
    FlatLayout,
    FlatPosterior,
    consensus_flat_delayed,
    consensus_flat_delayed_corrupted,
    consensus_flat_delayed_quarantined,
    consensus_flat_masked,
    consensus_flat_masked_quarantined,
    consensus_flat_segments,
    consensus_flat_segments_corrupted,
    consensus_flat_segments_quarantined,
    make_flat_nll,
)
from repro_torch.core.numerics import canonical_wire_dtype, wire_dtype_name
from repro_torch.core.simulated import init_network, network_local_steps, network_state_from_numpy
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.gossip.clocks import SparseClock, SparseWindow
from repro_torch.launch.mesh import agent_mesh, local_devices
from repro_torch.obs.trace import maybe_span


@dataclasses.dataclass
class GossipState:
    """Network state + per-agent gossip telemetry (agent-leading tensors),
    in the JAX package's field order.  ``hist_mean``/``hist_rho`` are the
    delivery-latency history ring ([K, N, P]; slot ``r mod K`` holds window
    r's post-local, pre-merge posterior), ``None`` when delivery is
    instant, so instant states keep their leaf list and checkpoints.
    ``n_quarantined`` is ``None`` unless ``fault_policy="quarantine"``."""

    posterior: FlatPosterior  # [N, P]
    opt_state: Any
    step: torch.Tensor  # [N] int32 per-agent local step counter
    round: torch.Tensor  # scalar int32 window counter
    last_merge: torch.Tensor  # [N] int32 window index of last merge (-1 = never)
    n_merges: torch.Tensor  # [N] int32 total merges per agent
    hist_mean: torch.Tensor | None = None  # [K, N, P] stale-posterior ring
    hist_rho: torch.Tensor | None = None  # [K, N, P]
    n_quarantined: torch.Tensor | None = None  # [N] int32 dropped contributions

    def to(self, device) -> "GossipState":
        """A copy of the whole state on ``device``."""
        return tree_map(lambda x: x.to(device, copy=True), self)


def _agent_select(active: torch.Tensor, new, old):
    """Per-tensor ``where`` over agent-leading tensors (wake-on-event),
    written into ``new`` (the local phase's own fresh outputs): at N = 4,200
    and full width a copy of the posterior and the Adam moments would hold
    20 GB more at the window's peak."""
    def sel(a, b):
        return torch.where(active.reshape((-1,) + (1,) * (a.ndim - 1)), a, b, out=a)

    return tree_map(sel, new, old)


def _largest_divisor_leq(n: int, cap: int) -> int:
    for s in range(min(n, cap), 0, -1):
        if n % s == 0:
            return s
    return 1


def _signature(tree) -> tuple:
    """Shapes and dtypes of a tree's tensor leaves, in leaf order."""
    return tuple((tuple(x.shape), x.dtype) for x in tree_leaves(tree))


def _ring_tensor(a, device) -> torch.Tensor | None:
    """A history ring from numpy (a bfloat16 array, as JAX hands one over,
    by its int16 bits) or a tensor, on ``device``."""
    if a is None or isinstance(a, torch.Tensor):
        return None if a is None else a.to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def gossip_state_from_numpy(mean, rho, *, layout: FlatLayout, mu=None, nu=None, step=None,
                            round=0, last_merge=None, n_merges=None, hist_mean=None,
                            hist_rho=None, n_quarantined=None, device=None) -> GossipState:
    """Carry a JAX-side ``GossipState`` across as numpy arrays: the
    ``network_state_from_numpy`` fields plus ``last_merge`` and ``n_merges``
    [N] (defaults -1 and 0), the history ring ``hist_mean``/``hist_rho``
    [K, N, P] (``None`` when delivery is instant; bf16 arrays keep their
    dtype) and ``n_quarantined`` [N] (``None`` under the strict policy)."""
    ns = network_state_from_numpy(mean, rho, layout=layout, mu=mu, nu=nu, step=step,
                                  round=round, device=device)
    n = ns.posterior.mean.shape[0]

    def ints(a, fill):
        a = np.full(n, fill, np.int32) if a is None else np.asarray(a, np.int32)
        return torch.from_numpy(a.copy()).to(device)

    return GossipState(
        posterior=ns.posterior, opt_state=ns.opt_state, step=ns.step, round=ns.round,
        last_merge=ints(last_merge, -1), n_merges=ints(n_merges, 0),
        hist_mean=_ring_tensor(hist_mean, device), hist_rho=_ring_tensor(hist_rho, device),
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

    def __init__(self, spec, model, n_agents: int, device, devices=None):
        """``devices``: the sharded execution's devices (default: every card
        of ``device``'s type, ``launch.mesh.local_devices``); entries may
        repeat."""
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
        self.max_delay = int(getattr(self.clock, "max_delay", 0))
        self.hist_slots = self.max_delay + 1 if self.max_delay > 0 else 0
        if self.max_delay > 0 and self.consensus_mode == "mean_only":
            raise ValueError(
                "delivery-latency gossip implements gaussian/none consensus; mean_only "
                "(the FedAvg baseline) runs on instant delivery"
            )
        if inf.history_dtype is not None and not self.hist_slots:
            raise ValueError(
                "history_dtype sizes the delivery-latency posterior history ring; "
                'this clock has no delay (wrap it in {"kind": "delayed", ...} or '
                "drop history_dtype)"
            )
        # resident dtype of the [K, N, P] ring (bf16 halves it; rows decode to fp32)
        self.hist_dtype = canonical_wire_dtype(inf.history_dtype)
        self._init_impl(inf, n_agents, local_devices(device) if devices is None else devices)
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
        # distinct local-phase signatures run (see the module docstring)
        self._signatures: set = set()
        # host-side observability hook (repro_torch.obs.Observability),
        # attached by build_session when ObsSpec is enabled
        self.obs = None

    @property
    def n_traces(self) -> int:
        """The distinct signatures the shared local phase has run: the JAX
        engine's retrace count."""
        return len(self._signatures)

    def _init_impl(self, inf, n_agents: int, devices) -> None:
        """Pick the window execution, build the sharded execution's mesh, and
        refuse what it cannot run."""
        from repro_torch.api.spec import SPARSE_DENSE_GUARD

        impl = inf.consensus_impl
        sparse_clock = isinstance(self.clock, SparseClock)
        if impl == "auto":
            impl = "segments" if sparse_clock else "masked"
        self.consensus_impl = impl
        if impl == "segments":
            if not sparse_clock:
                raise ValueError(
                    "consensus_impl='segments' executes edge-native SparseWindows; this "
                    "topology's clock emits dense EventWindows (use TopologySpec "
                    "kind='sparse' with a clock doc, or consensus_impl='masked')"
                )
            if self.consensus_mode == "mean_only":
                raise ValueError(
                    "consensus_impl='segments' implements gaussian/none consensus; "
                    "mean_only (the FedAvg baseline) runs on the dense masked path"
                )
        elif sparse_clock:
            # the dense view of a sparse clock: legal below the guard (the
            # segments-vs-masked ladder runs on it), refused above it
            if impl == "ppermute":
                raise ValueError(
                    "consensus_impl='ppermute' shards dense EventWindows by their static "
                    "edge schedule; a sparse clock emits edge-native SparseWindows (use "
                    "'segments', or 'masked' below the dense guard)"
                )
            if n_agents > SPARSE_DENSE_GUARD:
                raise ValueError(
                    "consensus_impl='masked' materializes the dense [N, N] window view; "
                    f"N={n_agents} is above SPARSE_DENSE_GUARD={SPARSE_DENSE_GUARD} "
                    "(use consensus_impl='segments')"
                )
        self.mesh = None
        if impl == "ppermute":
            if self.max_delay > 0:
                raise ValueError(
                    "consensus_impl='ppermute' implements instant delivery; a delayed clock "
                    "runs the history path (drop the latency wrapper or use "
                    "consensus_impl='masked')"
                )
            devices = list(devices)
            shards = inf.consensus_shards
            if shards is None:
                shards = _largest_divisor_leq(n_agents, len(devices))
            if shards > len(devices):
                raise ValueError(
                    f"consensus_shards={shards} exceeds the {len(devices)} local devices"
                )
            if n_agents % shards:
                raise ValueError(f"consensus_shards={shards} must divide n_agents={n_agents}")
            self.n_shards = shards
            self.mesh = agent_mesh(devices, shards)

    # -- the window ----------------------------------------------------------

    def local_phase(self, state: GossipState, batches, active, eps, generator, up=None):
        """Per-agent local VI steps + the wake-on-event / fault select: the
        synchronous round's ``network_local_steps``, then selects that are
        identities when every agent trains."""
        self._signatures.add((_signature(state), _signature(batches), tuple(active.shape),
                              active.dtype, up is None))
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

    def _phase(self, name: str):
        """A ``gossip.local_phase`` or ``gossip.consensus`` span inside the
        window's ``gossip.window``; the sharded execution opens its own two
        around its two steps (``run_round``)."""
        sharded = self.mesh is not None and self.consensus_mode == "gaussian"
        return maybe_span(None if sharded else self.obs, name)

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
        """The local phase, then the masked consensus (the sharded execution
        runs its consensus as a step of its own: ``_ppermute_consensus``)."""
        with self._phase("gossip.local_phase"):
            post, opt_state, step, active, losses = self.local_phase(
                state, batches, active, eps, generator)
        with self._phase("gossip.consensus"):
            if self.consensus_mode == "gaussian" and self.mesh is None:
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
        with self._phase("gossip.local_phase"):
            post, opt_state, step, active, losses = self.local_phase(
                state, batches, active, eps, generator, up)
        n_q = state.n_quarantined
        with self._phase("gossip.consensus"):
            if self.consensus_mode == "gaussian" and self.mesh is None:
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

    def _write_slot(self, state, post):
        """The ring with this window's post-local, pre-merge posterior in slot
        ``round mod K``, written before the merge so that a lag-0 event reads
        the current posterior (what instant delivery merges).  A new ring:
        the state passed in is not changed."""
        slot = int(state.round) % self.hist_slots
        hist_mean, hist_rho = state.hist_mean.clone(), state.hist_rho.clone()
        hist_mean[slot] = post.mean.to(self.hist_dtype)
        hist_rho[slot] = post.rho.to(self.hist_dtype)
        return hist_mean, hist_rho

    def _n_q(self, n_q, dst, weights, valid_e):
        """``n_q`` plus, per destination, its real dropped contributions
        (pad slots carry weight 0 and are not counted), counted on the host."""
        bad = ~valid_e.cpu().numpy() & (np.asarray(weights) > 0.0)
        add = np.bincount(np.asarray(dst)[bad], minlength=self.n_agents).astype(np.int32)
        return n_q + torch.from_numpy(add).to(n_q.device)

    def window_fn_delayed(self, state, batches, W, active, win, eps=None, generator=None):
        """Delayed-delivery window: write the slot, then merge each event's
        source as of its fire window."""
        with self._phase("gossip.local_phase"):
            post, opt_state, step, active, losses = self.local_phase(
                state, batches, active, eps, generator)
        with self._phase("gossip.consensus"):
            hist_mean, hist_rho = self._write_slot(state, post)
            if self.consensus_mode == "gaussian":
                post = consensus_flat_delayed(post, W, active, win.edges, win.weights,
                                              win.delays, hist_mean, hist_rho, state.round,
                                              wire_dtype=self.wire_dtype)
        new = self.finish(state, post, opt_state, step, active)
        return dataclasses.replace(new, hist_mean=hist_mean, hist_rho=hist_rho), losses

    def window_fn_delayed_guarded(self, state, batches, W, active, win, eps=None,
                                  generator=None, *, up, faults):
        """Fault-aware delayed window: corruption applies at delivery time by
        source id (every event from a corrupted agent reads garbage, whatever
        its fire time); the ring always records the true resident
        posterior."""
        with self._phase("gossip.local_phase"):
            post, opt_state, step, active, losses = self.local_phase(
                state, batches, active, eps, generator, up)
        n_q = state.n_quarantined
        with self._phase("gossip.consensus"):
            hist_mean, hist_rho = self._write_slot(state, post)
            if self.consensus_mode == "gaussian":
                args = (post, W, active, win.edges, win.weights, win.delays, hist_mean,
                        hist_rho, state.round)
                kw = dict(corrupt=faults["corrupt"], fill_mean=faults["fill_mean"],
                          fill_rho=faults["fill_rho"], wire_dtype=self.wire_dtype)
                if self.quarantine:
                    post, valid_e = consensus_flat_delayed_quarantined(*args, **kw)
                    n_q = self._n_q(n_q, win.edges[:, 0], win.weights, valid_e)
                else:
                    post = consensus_flat_delayed_corrupted(*args, **kw)
        new = self.finish(state, post, opt_state, step, active, n_q)
        return dataclasses.replace(new, hist_mean=hist_mean, hist_rho=hist_rho), losses

    @staticmethod
    def _self_loops(win):
        """The window's fired edges then N self loops at the conserve-rule
        self-weights: ``consensus_flat_segments`` takes self loops in the
        edge arrays."""
        ar = np.arange(win.n_agents, dtype=win.dst.dtype)
        return (np.concatenate([win.dst, ar]), np.concatenate([win.src, ar]),
                np.concatenate([win.weights, win.self_weight.astype(np.float32)]))

    def window_fn_segments(self, state, batches, win, active, eps=None, generator=None):
        """Edge-native window: the [E_max] fired arrays, [N] self-weights and
        the host-exact active mask are the whole exchange structure."""
        with self._phase("gossip.local_phase"):
            post, opt_state, step, active, losses = self.local_phase(
                state, batches, active, eps, generator)
        with self._phase("gossip.consensus"):
            if self.consensus_mode == "gaussian":
                post = consensus_flat_segments(post, *self._self_loops(win), active=active,
                                               wire_dtype=self.wire_dtype)
        return self.finish(state, post, opt_state, step, active), losses

    def window_fn_segments_guarded(self, state, batches, win, active, eps=None,
                                   generator=None, *, up, faults):
        """Fault-aware edge-native window.  The clock already filtered crashed
        agents' fired edges, so ``up`` only gates local training; quarantine
        validates every fired edge's payload and moves dropped mass to the
        destination's self term."""
        with self._phase("gossip.local_phase"):
            post, opt_state, step, active, losses = self.local_phase(
                state, batches, active, eps, generator, up)
        n_q = state.n_quarantined
        with self._phase("gossip.consensus"):
            if self.consensus_mode == "gaussian":
                kw = dict(active=active, corrupt=faults["corrupt"],
                          fill_mean=faults["fill_mean"], fill_rho=faults["fill_rho"],
                          wire_dtype=self.wire_dtype)
                if self.quarantine:
                    post, valid_e = consensus_flat_segments_quarantined(
                        post, win.dst, win.src, win.weights,
                        win.self_weight.astype(np.float32), **kw)
                    n_q = self._n_q(n_q, win.dst, win.weights, valid_e)
                else:
                    # strict: the wire is trusted verbatim, so the garbage reaches
                    # every receiver; non-merging agents keep their resident state
                    post = consensus_flat_segments_corrupted(post, *self._self_loops(win),
                                                             **kw)
        return self.finish(state, post, opt_state, step, active, n_q), losses

    # -- Engine protocol -----------------------------------------------------

    def init(self, generator: torch.Generator, params=None) -> GossipState:
        ns = init_network(
            generator, self.n_agents, self.model.init_fn, self.opt,
            init_sigma=self.init_sigma, shared_init=self.shared_init,
            device=self.device, params=params,
        )
        n, dev = self.n_agents, ns.step.device
        # zero-filled: window r reads only slots of windows >= max(0, r - max_delay),
        # each written before it is read
        ring = ((self.hist_slots,) + tuple(ns.posterior.mean.shape), self.hist_dtype)
        return GossipState(
            posterior=ns.posterior, opt_state=ns.opt_state, step=ns.step, round=ns.round,
            last_merge=torch.full((n,), -1, dtype=torch.int32, device=dev),
            n_merges=torch.zeros((n,), dtype=torch.int32, device=dev),
            hist_mean=(torch.zeros(ring[0], dtype=ring[1], device=dev)
                       if self.hist_slots else None),
            hist_rho=(torch.zeros(ring[0], dtype=ring[1], device=dev)
                      if self.hist_slots else None),
            n_quarantined=(torch.zeros((n,), dtype=torch.int32, device=dev)
                           if self.quarantine else None),
        )

    def _fault_draws(self, r: int) -> dict:
        """Host-side fault draws of window ``r`` (pure functions of (seed, r)),
        numpy [N] arrays; records ``last_crashed`` for ``Session.round``."""
        n = self.n_agents
        if self.faults is None:
            up, corrupt = np.ones(n, bool), np.zeros(n, bool)
            fm = fr = np.zeros(n, np.float32)
        else:
            up, corrupt = self.faults.up(r), self.faults.corrupted(r)
            fm, fr = self.faults.fills(r)
        self.last_crashed = ~up
        return {"up": np.asarray(up), "corrupt": np.asarray(corrupt),
                "fill_mean": np.asarray(fm), "fill_rho": np.asarray(fr)}

    def _window_for(self, r: int, W):
        """The clock's own window ``r``: the delayed and sharded paths need
        its event list, which the Session's W-tilde alone does not carry.
        Windows are pure functions of (seed, round), so this is the
        Session's stream; ``W`` must be that window's w_eff in float64, so
        per-round W overrides cannot run on these paths."""
        win = self.clock.window(r)
        if not np.array_equal(np.asarray(W, np.float64), np.asarray(win.w_eff, np.float64)):
            raise ValueError(
                "delayed and sharded gossip windows come from the spec clock; the W "
                f"passed for window {r} does not match its stream (per-round w_schedule "
                "overrides are unsupported on these paths)"
            )
        return win

    def _host_active(self, r: int, W, win=None) -> np.ndarray:
        """The host-exact [N] activity mask of window ``r``: the clock's
        ``window.active`` when ``W`` is the clock's own host float64 w_eff
        (what the Session hands over verbatim); for a foreign W the diagonal
        test, in float64, never on a float32 cast."""
        if isinstance(W, torch.Tensor):  # a device W is foreign by definition
            return np.diagonal(W.cpu().numpy().astype(np.float64)) < 1.0
        w64 = np.asarray(W, np.float64)
        if win is None and isinstance(W, np.ndarray) and W.dtype == np.float64:
            win = self.clock.window(r)
        if (win is not None and not isinstance(win, SparseWindow)
                and np.array_equal(w64, np.asarray(win.w_eff, np.float64))):
            return np.asarray(win.active)
        return np.diagonal(w64) < 1.0

    def _segments_round(self, state, batches, W, eps, generator, r: int, obs):
        """Edge-native window: no [N, N] on the host or the card."""
        if not isinstance(W, SparseWindow):
            raise ValueError(
                "consensus_impl='segments' executes the spec clock's SparseWindow stream; "
                "run_round received an array-like W (per-round dense w_schedule overrides "
                "are unsupported: the Session's w_schedule yields the windows verbatim)"
            )
        if int(W.index) != r:
            raise ValueError(
                f"SparseWindow index {int(W.index)} does not match the engine round {r} "
                "(windows are pure functions of (seed, round); the stream must be "
                "consumed in order)"
            )
        with maybe_span(obs, "gossip.window_build", round=r):
            active = torch.as_tensor(np.asarray(W.active), device=self.device)
            faults = self._fault_draws(r) if self._guarded else None
        with maybe_span(obs, "gossip.window", impl="segments", round=r):
            if faults is None:
                out = self.window_fn_segments(state, batches, W, active, eps, generator)
            else:
                up = torch.as_tensor(faults["up"], device=self.device)
                out = self.window_fn_segments_guarded(state, batches, W, active, eps,
                                                      generator, up=up, faults=faults)
        self._obs_after_window(obs)
        return out

    def run_round(self, state, batches, W, eps=None, generator=None):
        obs = self.obs
        r = int(state.round)
        if self.consensus_impl == "segments":
            return self._segments_round(state, batches, W, eps, generator, r, obs)
        spec_win = None
        if isinstance(W, SparseWindow):
            # the dense view of an edge-native window (below the guard only):
            # the segments-vs-masked ladder runs on it
            spec_win, W = W, W.w_eff
        sharded = self.mesh is not None and self.consensus_mode == "gaussian"
        with maybe_span(obs, "gossip.window_build", round=r):
            win = self._window_for(r, W) if (self.hist_slots or sharded) else None
            active = torch.as_tensor(
                np.asarray(spec_win.active) if spec_win is not None
                else self._host_active(r, W, win), device=self.device)
            faults = self._fault_draws(r) if self._guarded else None
        if self.hist_slots:
            with maybe_span(obs, "gossip.window", impl="delayed", round=r):
                if faults is None:
                    out = self.window_fn_delayed(state, batches, W, active, win, eps, generator)
                else:
                    up = torch.as_tensor(faults["up"], device=self.device)
                    out = self.window_fn_delayed_guarded(state, batches, W, active, win, eps,
                                                         generator, up=up, faults=faults)
            self._obs_after_window(obs)
            return out
        W = torch.as_tensor(W, dtype=torch.float32).to(self.device)
        if faults is not None:
            faults = {k: torch.as_tensor(a, device=self.device) for k, a in faults.items()}
        if sharded:
            # the local phase, then the sharded consensus: two steps, two spans
            with maybe_span(obs, "gossip.local_phase", impl="ppermute", round=r):
                if faults is None:
                    state, losses = self.window_fn(state, batches, W, active, eps, generator)
                else:
                    state, losses = self.window_fn_guarded(state, batches, W, active, eps,
                                                           generator, **faults)
            with maybe_span(obs, "gossip.consensus", impl="ppermute", round=r):
                state = self._ppermute_consensus(state, W, win, faults)
            self._obs_after_window(obs)
            return state, losses
        with maybe_span(obs, "gossip.window", impl="masked", round=r):
            if faults is None:
                out = self.window_fn(state, batches, W, active, eps, generator)
            else:
                out = self.window_fn_guarded(state, batches, W, active, eps, generator,
                                             **faults)
        self._obs_after_window(obs)
        return out

    def _ppermute_consensus(self, state, W, win, faults) -> GossipState:
        """The sharded consensus of a window whose local phase has run: the
        strict window, the strict window with corrupted payloads on the wire,
        or the quarantined one.  The activity is the clock's host-exact
        ``win.active``."""
        post = state.posterior
        active = torch.as_tensor(np.asarray(win.active), device=self.device)
        kw = dict(mode="ppermute", mesh=self.mesh, window=win, wire_dtype=self.wire_dtype)
        if faults is None:
            return dataclasses.replace(state,
                                       posterior=consensus_flat_masked(post, W, active, **kw))
        c = faults["corrupt"][:, None]
        mean_src = torch.where(c, faults["fill_mean"][:, None], post.mean)
        rho_src = torch.where(c, faults["fill_rho"][:, None], post.rho)
        if self.quarantine:
            post, valid_src = consensus_flat_masked_quarantined(
                post, W, active, mean_src=mean_src, rho_src=rho_src, **kw)
            return dataclasses.replace(
                state, posterior=post,
                n_quarantined=state.n_quarantined + (~valid_src).to(torch.int32))
        # strict: the wire is trusted verbatim; non-merging agents keep their state
        merged = consensus_flat_masked(dataclasses.replace(post, mean=mean_src, rho=rho_src),
                                       W, active, **kw)
        act = active[:, None]
        return dataclasses.replace(state, posterior=dataclasses.replace(
            post, mean=torch.where(act, merged.mean, post.mean),
            rho=torch.where(act, merged.rho, post.rho)))

    def _obs_after_window(self, obs) -> None:
        """Registry bookkeeping after one window (host-side, pure observer)."""
        if obs is None:
            return
        obs.registry.counter("gossip.windows", "event windows executed").inc()
        obs.registry.gauge(
            "gossip.jit_traces", "distinct window traces (retrace telemetry)"
        ).set(self.n_traces)

    def posterior(self, state) -> FlatPosterior:
        return state.posterior

    # -- telemetry -----------------------------------------------------------

    def staleness(self, state) -> np.ndarray:
        """[N] windows since each agent's last merge (never merged = the age
        of the whole run)."""
        n = int(state.round)
        last = state.last_merge.cpu().numpy()
        return np.where(last >= 0, (n - 1) - last, n).astype(np.int64)

    def snapshot_meta(self, state) -> dict:
        """The gossip provenance a serving snapshot carries: the window
        index, staleness percentiles, merge counts and quarantine totals at
        publish time, the raw material of the serving tier's staleness SLO.
        Plain data, embeddable in the snapshot's checkpoint."""
        age = self.staleness(state)
        meta = {
            "window": int(state.round),
            "staleness": {
                "p50": float(np.percentile(age, 50)),
                "p90": float(np.percentile(age, 90)),
                "max": int(age.max()),
            },
            "merges_total": int(state.n_merges.sum()),
        }
        if state.n_quarantined is not None:
            meta["quarantined_total"] = int(state.n_quarantined.sum())
        return meta

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
        if self.max_delay:
            out["max_delay"] = self.max_delay
        if self.mesh is not None:
            out["consensus_shards"] = self.n_shards
        if self.wire_dtype != "f32":
            out["wire_dtype"] = self.wire_dtype
        if self.hist_slots and wire_dtype_name(self.hist_dtype) != "f32":
            out["history_dtype"] = wire_dtype_name(self.hist_dtype)
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
