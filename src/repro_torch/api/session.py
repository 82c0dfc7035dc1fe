"""``build_session(spec)`` — the supported front door (port of
``repro.api.session`` for the synchronous BbB round, the gossip runtime and
the conjugate linear regression of paper Example 1).

    spec = ExperimentSpec(
        topology=TopologySpec.grid(3, 3),
        data=DataSpec(dataset="mnist_like", ...),
        inference=InferenceSpec(hidden=200, depth=2),
        run=RunSpec(n_rounds=20, seed=0),
    )
    session = build_session(spec)          # on the card; device="cpu" to opt out
    session.run()                          # or session.round(), one at a time
    session.evaluate()                     # per-agent MC-predictive accuracy
    session.health()                       # exchange-payload validity probe
    session.snapshot(dtype="bf16")         # publish the serving copy
    server = session.attach_server()       # batched MC-predictive serving
    print(session.dashboard())             # with ExperimentSpec(obs=ObsSpec(enabled=True))
    session.save("exp.ckpt")               # self-describing: spec embedded
    session = Session.load("exp.ckpt")     # rebuild + resume, on the card

A gossip topology (``TopologySpec.gossip(base, params, clock=...)``) runs on
the ``GossipEngine``: one event window per round, its telemetry under
``evaluate()["engine"]``.  ``InferenceSpec(method="conjugate_linreg")`` with
``DataSpec(dataset="linreg")`` runs the ``ConjugateLinregEngine``;
``evaluate()`` then returns the global-test MSE.  ``RunSpec(engine=
"launch")`` runs the same round on the production ``LaunchEngine``
(``launch.steps``).  ``ExperimentSpec(obs=ObsSpec(enabled=True))`` attaches
the observability bundle (``Session.obs``: metrics registry, spans that
synchronise the card before they read the clock, the Theorem-1 convergence
tracker) and ``Session.dashboard()`` prints it; a pure observer, so the run
is bitwise the run without it.

Randomness: the session owns one ``torch.Generator`` on its device, seeded
from ``spec.run.seed``, and every draw consumes it in a fixed order.  Each
draw can instead be injected (``round(batch_idx=, eps=, batch_seed=)``,
``evaluate(eps=)``, ``predictive(eps=)``, ``build_session(init_params=)``):
the port cannot replay JAX's threefry streams, so the parity tests feed the
JAX package's own draws through these seams.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api.data import DataBundle, build_data
from repro_torch.api.engines import ConjugateLinregEngine, Engine, LaunchEngine, SimulatedEngine
from repro_torch.api.models import ModelFns, build_model
from repro_torch.api.spec import ExperimentSpec
from repro_torch.checkpoint.io import restore_leaf, restore_session, save_session, seed_key_data
from repro_torch.core.flat import FlatPosterior, payload_validity
from repro_torch.core.posterior import FullCovGaussian
from repro_torch.core.simulated import as_w_schedule
from repro_torch.core.tree import tree_leaves, tree_replace_leaves
from repro_torch.gossip.engine import GossipEngine
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.obs.trace import made_current, maybe_span
from repro_torch.vi.bayes_by_backprop import mc_predict

EVAL_SEED = 99  # evaluate()'s default MC noise, the same on every call
PREDICT_SEED = 97  # predictive()'s default MC noise


def build_session(spec: ExperimentSpec, device=None, init_params=None,
                  devices=None) -> "Session":
    """Validate ``spec`` eagerly and return a ready-to-run ``Session`` on
    ``device`` (default: the CUDA card; raises if there is none).
    ``init_params`` injects the initial parameter draw (see
    ``core.simulated.init_network``).  ``devices`` are the devices the
    sharded gossip execution (``consensus_impl="ppermute"``) may shard the
    agent axis over, one shard an entry (default: every card of the
    session's device type, ``launch.mesh.local_devices``); a device may
    repeat, as a virtual shard."""
    spec.validate()
    device = resolve_device(device)
    gossiping = spec.topology.kind == "gossip" or (
        spec.topology.kind == "sparse" and spec.topology.clock is not None
    )
    n_agents = spec.topology.n_agents()
    data = build_data(spec.data, n_agents, device=device)
    model: ModelFns | None = None
    if spec.inference.method == "conjugate_linreg":
        engine: Engine = ConjugateLinregEngine(spec, data, device)
    else:
        model = build_model(
            spec.inference.model, data.dim, data.n_classes,
            hidden=spec.inference.hidden, depth=spec.inference.depth,
        )
        if gossiping:
            # a gossip topology IS an execution model: one event window per
            # round on the GossipEngine
            engine = GossipEngine(spec, model, n_agents, device, devices=devices)
        elif spec.run.engine == "launch":
            engine = LaunchEngine(spec, model, n_agents, device)
        else:
            engine = SimulatedEngine(spec, model, n_agents, device)
    generator = torch.Generator(device=device).manual_seed(spec.run.seed)
    state = engine.init(generator, params=init_params)
    obs = None
    if spec.obs.enabled:
        from repro_torch.obs import Observability

        obs = Observability.from_spec(spec, device=device)
        # engines read this host-side hook at their dispatch boundaries only
        engine.obs = obs
    return Session(spec=spec, engine=engine, model=model, data=data, state=state,
                   generator=generator, device=device, _obs=obs)


@dataclasses.dataclass
class Session:
    """A running experiment: engine-backed state + the round loop."""

    spec: ExperimentSpec
    engine: Engine
    model: ModelFns | None
    data: DataBundle
    state: Any
    generator: torch.Generator
    device: torch.device
    round_idx: int = 0
    history: list = dataclasses.field(default_factory=list)
    _w_schedule: Any = dataclasses.field(default=None, repr=False)
    _serve_store: Any = dataclasses.field(default=None, repr=False)
    _server: Any = dataclasses.field(default=None, repr=False)
    _obs: Any = dataclasses.field(default=None, repr=False)

    @property
    def obs(self):
        """The session's ``repro_torch.obs.Observability`` bundle (registry,
        tracer, convergence tracker), or ``None`` when ``spec.obs`` is
        disabled, the default: nothing is recorded and the run is the
        uninstrumented run."""
        return self._obs

    def _spec_w_schedule(self):
        if self._w_schedule is None:
            self._w_schedule = self.spec.topology.w_schedule()
        return self._w_schedule

    # -- the loop ------------------------------------------------------------

    def round(self, W=None, *, batch_idx=None, eps=None, batch_seed=None) -> dict:
        """One communication round (u local steps + consensus).  Returns
        ``{"round", "loss", "n_trained", "losses"}``, plus ``n_crashed``
        (agents down this window) on a gossip run with faults.  ``W``
        overrides the spec topology for this round; ``batch_idx`` ([N, u*B])
        and ``eps`` ([N, u, S, P]) inject the round's draws, and
        ``batch_seed`` the linreg sampler's per-round numpy seed.

        An engine that declares ``wants_host_w`` (the gossip engine) gets the
        schedule value verbatim: the host float64 w_eff, whose exact activity
        mask a float32 cast would lose.  NaN-sentinel losses (agents that did
        not train) are skipped; ``loss`` is ``None`` when none trained.

        With observability on (``spec.obs``) the round runs in a
        ``session.round`` span, marked ``compile`` when the engine's
        ``n_traces`` grew in it or, for an engine without one, on the first
        observed round (which pays the kernel library's load, cuBLAS
        handles and the allocator's first growth), with the bundle current
        (``obs.trace.made_current``) so that the engine's shared numeric
        code opens its spans in it, and the loop's counters and gauges land
        in the registry.  They observe values this method
        computes anyway: the training math is the same either way."""
        obs = self._obs
        if obs is None:
            return self._round_impl(W, batch_idx, eps, batch_seed)
        tr = obs.tracer
        n_traces0 = getattr(self.engine, "n_traces", None)
        first = obs.registry.counter("session.rounds").value() == 0
        with made_current(obs), tr.span("session.round", round=self.round_idx):
            rec = self._round_impl(W, batch_idx, eps, batch_seed)
        if tr.enabled and tr.spans:
            retraced = (n_traces0 is not None
                        and getattr(self.engine, "n_traces") > n_traces0)
            if retraced or (n_traces0 is None and first):
                tr.spans[-1].attrs["compile"] = True
        self._obs_after_round(rec)
        return rec

    def _round_impl(self, W, batch_idx, eps, batch_seed) -> dict:
        r = self.round_idx
        if W is None:
            with maybe_span(self._obs, "session.w_build", round=r):
                W = self._spec_w_schedule()(r)
        if not getattr(self.engine, "wants_host_w", False):
            W = torch.as_tensor(np.asarray(W), dtype=torch.float32, device=self.device)
        with maybe_span(self._obs, "session.batches", round=r):
            if self.data.kind == "linreg":
                batches = self.data.sampler(self.generator, r, seed=batch_seed)
            else:
                batches = self.data.sampler(self.generator, r, idx=batch_idx)
        if eps is not None:
            eps = torch.as_tensor(eps, dtype=torch.float32, device=self.device)
        self.state, losses = self.engine.run_round(
            self.state, batches, W, eps=eps, generator=self.generator
        )
        self.round_idx = r + 1
        losses = losses.cpu().numpy()
        n_trained = int(np.isfinite(losses).sum())
        if getattr(self.engine, "loss_nan_is_sentinel", False):
            loss = float(np.nanmean(losses)) if n_trained else None
        else:
            loss = float(losses.mean())
        rec = {"round": self.round_idx, "loss": loss, "n_trained": n_trained,
               "losses": losses}
        crashed = getattr(self.engine, "last_crashed", None)
        if crashed is not None:
            rec["n_crashed"] = int(np.asarray(crashed).sum())
        return rec

    def _obs_after_round(self, rec: dict) -> None:
        """Post-round registry and convergence bookkeeping (observability on
        only).  Reads ``rec`` and, on the convergence-sample rounds (every
        ``convergence_every``), the posterior buffers.  The round's spans
        are resolved here: the round ended on its losses' read from the
        card, so nothing is left to wait for, and no round's span events
        outlive it."""
        obs = self._obs
        obs.tracer.resolve()
        reg = obs.registry
        reg.counter("session.rounds", "communication rounds run").inc()
        reg.gauge("session.n_trained", "agents trained last round").set(rec["n_trained"])
        if rec["loss"] is not None:
            reg.gauge("session.loss", "mean trained-agent loss").set(rec["loss"])
            reg.histogram("session.loss_dist", "per-round loss").observe(rec["loss"])
        if "n_crashed" in rec:
            reg.counter("session.crashed_agent_windows", "agent-windows down").inc(
                rec["n_crashed"])
        conv = obs.convergence
        if conv is not None and (rec["round"] - 1) % obs.spec.convergence_every == 0:
            with obs.tracer.span("obs.convergence", round=rec["round"]):
                stats = conv.update(self.posterior(), rec["round"])
            reg.ingest("convergence", stats)

    def run(self, n_rounds: int | None = None, w_schedule=None,
            eval_fn: Callable[["Session"], dict] | None = None,
            eval_every: int | None = None) -> list[dict]:
        """Run ``n_rounds`` rounds (default ``spec.run.n_rounds``).
        ``w_schedule`` overrides the spec topology (a static W, a list cycled
        over rounds, or a round-indexed callable); ``eval_fn(session)`` is
        merged into the history every ``eval_every`` rounds."""
        n = self.spec.run.n_rounds if n_rounds is None else n_rounds
        w_for_round = (as_w_schedule(w_schedule) if w_schedule is not None
                       else self._spec_w_schedule())
        eval_every = self.spec.run.eval_every if eval_every is None else eval_every
        history: list[dict] = []
        with maybe_span(self._obs, "session.run", n_rounds=n):
            for i in range(n):
                rec = self.round(W=w_for_round(self.round_idx))
                if eval_every and ((i + 1) % eval_every == 0 or i == n - 1):
                    if eval_fn is not None:
                        rec.update(eval_fn(self))
                    history.append(rec)
        self.history.extend(history)
        return history

    # -- results -------------------------------------------------------------

    def posterior(self) -> FlatPosterior | FullCovGaussian:
        """The network posterior: a ``FlatPosterior`` over [N, P] for the BbB
        engines, a stacked ``FullCovGaussian`` for the conjugate linreg
        engine."""
        return self.engine.posterior(self.state)

    def agent_posterior(self, agent: int) -> FlatPosterior | FullCovGaussian:
        """One agent's posterior: a one-agent ``FlatPosterior`` [1, P], or
        the agent's ``FullCovGaussian`` ([d], [d, d])."""
        post = self.posterior()
        if isinstance(post, FullCovGaussian):
            return FullCovGaussian(post.mean[agent], post.prec[agent])
        return FlatPosterior(post.mean[agent:agent + 1], post.rho[agent:agent + 1],
                             post.layout)

    def predictive(self, agent: int, x, n_mc: int = 8, eps=None) -> torch.Tensor:
        """MC predictive class probabilities [T, n_classes] for one agent
        (paper Sec 4.2).  ``n_mc=0`` is the deterministic point estimate at
        the posterior mean; ``eps`` ([n_mc, P]) injects the MC noise."""
        if self.model is None:
            raise ValueError("predictive() requires a classification model; the "
                             "conjugate linreg engine has none")
        post = self.agent_posterior(agent)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if n_mc == 0:
            with torch.no_grad():
                theta = post.layout.unflatten(post.mean)
                return torch.softmax(self.model.logits_fn(theta, x.unsqueeze(0)), -1)[0]
        if eps is None:
            eps = self._default_noise(PREDICT_SEED, n_mc)
        eps = torch.as_tensor(eps, dtype=torch.float32, device=self.device)
        return mc_predict(post, self.model.logits_fn, x, eps=eps)[0]

    def _default_noise(self, seed: int, n_mc: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((n_mc, self.posterior().n_params()), generator=g,
                           device=self.device)

    # -- serving (repro_torch.serve) ----------------------------------------

    @property
    def serve_store(self):
        """The session's ``serve.SnapshotStore`` (made on first use; its
        clock is the round counter, so a snapshot's age is in windows)."""
        if self._serve_store is None:
            from repro_torch.serve import SnapshotStore

            self._serve_store = SnapshotStore(clock=lambda: self.round_idx)
        return self._serve_store

    def snapshot(self, dtype=None):
        """Publish the consensus posterior into the serving double buffer: an
        immutable copy resident in ``dtype`` (default
        ``spec.serve.snapshot_dtype``; ``"bf16"`` halves the bytes), stamped
        with the current window and the engine's ``snapshot_meta`` (gossip
        staleness, quarantine totals), swapped in as the served front
        buffer.  Only reads training state: a run with serving readers is
        bitwise the run without."""
        post = self.posterior()
        if not isinstance(post, FlatPosterior):
            raise ValueError(
                "Session.snapshot() serves flat BbB posteriors; the "
                f"{type(self.engine).__name__} posterior is not a FlatPosterior"
            )
        if dtype is None:
            dtype = self.spec.serve.snapshot_dtype
        meta_fn = getattr(self.engine, "snapshot_meta", None)
        telemetry = meta_fn(self.state) if meta_fn is not None else {}
        obs = self._obs
        with maybe_span(obs, "serve.publish", window=self.round_idx, dtype=dtype):
            snap = self.serve_store.publish(post, window=self.round_idx, dtype=dtype,
                                            telemetry=telemetry)
        if obs is not None:
            obs.registry.counter("serve.published", "snapshots published").inc()
            obs.registry.gauge("serve.snapshot_bytes", "front-buffer residency").set(
                snap.nbytes())
        return snap

    def attach_server(self, **overrides):
        """A ``serve.PredictiveServer`` on this session's snapshot store and
        model apply.  Defaults come from ``spec.serve`` (``mc_samples``,
        ``bucket_sizes``, ``max_staleness``, ``staleness_policy``); keyword
        ``overrides`` win (``seed``, ``noise_fn`` too).  It serves published
        snapshots only: call ``snapshot()`` first, and again to roll the
        served posterior forward.  Its telemetry shows in ``evaluate()``."""
        if self.model is None:
            raise ValueError("attach_server() requires a classification model (the "
                             "conjugate linreg engine has no serving path)")
        from repro_torch.serve import PredictiveServer

        s = self.spec.serve
        kwargs = dict(mc_samples=s.mc_samples, bucket_sizes=s.bucket_sizes,
                      max_staleness=s.max_staleness, staleness_policy=s.staleness_policy)
        kwargs.update(overrides)
        self._server = PredictiveServer(self.serve_store, self.model.logits_fn, **kwargs)
        # host-side observer hook: request spans and counters in the registry
        self._server.obs = self._obs
        return self._server

    def health(self) -> dict:
        """Per-agent posterior health probe.  Flat posteriors run the
        exchange-payload validity check (``core.flat.payload_validity``, the
        CUDA kernel on the card), so ``ok[i]`` is exactly "agent i's
        posterior would be accepted by a quarantined peer"; the conjugate
        engine's falls back to an all-leaves-finite probe.  Pure read."""
        post = self.posterior()
        if isinstance(post, FlatPosterior):
            ok = payload_validity(post.mean, post.rho).cpu().numpy()
        else:
            ok = np.logical_and.reduce([
                torch.isfinite(leaf.reshape(leaf.shape[0], -1)).all(dim=1).cpu().numpy()
                for leaf in tree_leaves(post)
            ])
        return {
            "ok": [bool(v) for v in ok],
            "n_healthy": int(ok.sum()),
            "all_ok": bool(ok.all()),
        }

    def evaluate(self, n_mc: int = 4, eps=None) -> dict:
        """Held-out metrics per agent: MC-predictive accuracy for
        classification, global-test MSE (``{"mse", "avg_mse"}``) for linreg.
        Every agent sees the same MC noise ``eps`` ([n_mc, P]; default: a
        fixed draw, so repeated calls agree), as in the JAX package.  An
        engine with a ``telemetry(state)`` hook (the gossip runtime:
        staleness, merges, faults and quarantine) adds it under
        ``"engine"``, and a serving tier (a published snapshot or an
        attached server) its block under ``"serving"``.  Each producer owns
        its namespace, so no telemetry key can clobber a metric key.  With
        observability on, both blocks are also ingested into the registry
        under the same namespaces, with ``eval.avg_acc``/``eval.avg_mse``."""
        obs = self._obs
        with maybe_span(obs, "session.evaluate", n_mc=n_mc):
            out = self._evaluate_metrics(n_mc, eps)
            telemetry = getattr(self.engine, "telemetry", None)
            if telemetry is not None:
                out["engine"] = telemetry(self.state)
            if self._server is not None:
                out["serving"] = self._server.telemetry()
            elif self._serve_store is not None:
                out["serving"] = self._serve_store.telemetry()
        if obs is not None:
            for ns in ("engine", "serving"):
                if ns in out:
                    obs.registry.ingest(ns, out[ns])
            for k in ("avg_acc", "avg_mse"):
                if k in out:
                    obs.registry.gauge(f"eval.{k}").set(out[k])
        return out

    def _evaluate_metrics(self, n_mc: int, eps) -> dict:
        if self.data.kind == "linreg":
            phi_t, y_t = self.data.test_phi, self.data.test_y
            mean = self.posterior().mean.cpu().numpy()
            mses = [float(np.mean((phi_t @ mean[i] - y_t) ** 2))
                    for i in range(self.data.n_agents)]
            return {"mse": mses, "avg_mse": float(np.mean(mses))}
        if eps is None:
            eps = self._default_noise(EVAL_SEED, n_mc)
        eps = torch.as_tensor(eps, dtype=torch.float32, device=self.device)
        probs = mc_predict(self.posterior(), self.model.logits_fn, self.data.x_test, eps=eps)
        pred = torch.argmax(probs, dim=-1).cpu().numpy()
        accs = [float(v) for v in (pred == np.asarray(self.data.y_test)[None]).mean(axis=1)]
        return {"acc": accs, "avg_acc": float(np.mean(accs))}

    def dashboard(self) -> str:
        """Compact terminal summary of the run so far: loop counters, the
        engine's staleness/merge registry reads, serving state, the
        convergence verdict (measured decay rate vs the graph's theoretical
        rate), and the warm/compile span table.  Returns a printable string;
        works with observability off (a one-line pointer at ``ObsSpec``) so
        examples can call it unconditionally."""
        lines = [
            f"=== session dashboard · engine={self.engine.name} "
            f"round={self.round_idx} ==="
        ]
        obs = self._obs
        if obs is None:
            lines.append(
                "observability disabled — enable with "
                "ExperimentSpec(obs=ObsSpec(enabled=True))"
            )
            return "\n".join(lines)
        reg = obs.registry
        loss = reg.gauge("session.loss").value()
        n_tr = reg.gauge("session.n_trained").value()
        lines.append(
            f"rounds {int(reg.counter('session.rounds').value())}"
            f"  loss {loss:.4f}  n_trained {int(n_tr)}"
        )
        g_windows = reg.counter("gossip.windows").value()
        if g_windows:
            lines.append(
                f"gossip: windows {int(g_windows)}"
                f"  jit_traces {int(reg.gauge('gossip.jit_traces').value())}"
                f"  staleness p50/p90/max "
                f"{reg.gauge('engine.staleness.p50').value():.0f}/"
                f"{reg.gauge('engine.staleness.p90').value():.0f}/"
                f"{reg.gauge('engine.staleness.max').value():.0f}"
                f"  merges {int(reg.gauge('engine.merges.total').value())}"
            )
        published = reg.counter("serve.published").value()
        if published:
            lines.append(
                f"serving: published {int(published)}"
                f"  snapshot_bytes "
                f"{int(reg.gauge('serve.snapshot_bytes').value())}"
                f"  requests {int(reg.counter('serve.requests').value())}"
                f"  slo_breaches "
                f"{int(reg.gauge('serving.slo.breaches').value())}"
            )
        if obs.convergence is not None and obs.convergence.stats:
            rep = obs.convergence.report()
            latest = rep["latest"]
            line = f"convergence: disagreement {latest['disagreement']:.3e}"
            if "kl_to_mean" in latest:
                line += f"  KL(q_i||q_bar) {latest['kl_to_mean']:.3e}"
            if rep["measured_rate"] is not None:
                line += f"  measured_rate {rep['measured_rate']:.4f}"
            if rep["theory_rate"] is not None:
                line += f"  theory_rate {rep['theory_rate']:.4f}"
            if rep["rate_attainment"] is not None:
                line += f"  rate_attainment {rep['rate_attainment']:.2f}"
            lines.append(line)
        summ = obs.tracer.summary()
        for name in sorted(summ):
            for mode in ("warm", "compile"):
                if mode in summ[name]:
                    s = summ[name][mode]
                    lines.append(
                        f"span {name:<22s} {mode:<7s} n {s['n']:>4d}"
                        f"  p50 {s['p50_us']:>10.1f}us"
                        f"  max {s['max_us']:>10.1f}us"
                    )
        obs.flush()
        return "\n".join(lines)

    # -- checkpointing -------------------------------------------------------

    def save(self, path: str) -> None:
        """Self-describing checkpoint in the JAX package's format: the spec
        doc, the engine-state leaves and the loop counters, plus the
        generator's state.  ``key_data`` is the JAX key of
        ``spec.run.seed`` (the port has no threefry key), so the JAX package
        loading this file resumes from that key.  Pure read: neither the
        state nor the generator changes."""
        save_session(
            path, self.spec.to_doc(), self.state, round_idx=self.round_idx,
            key_data=seed_key_data(self.spec.run.seed), generator=self.generator,
        )

    @classmethod
    def load(cls, path: str, device=None) -> "Session":
        """Rebuild the session from the embedded spec on ``device`` (default:
        the card; raises without one) and resume: the saved leaves are
        restored into the rebuilt state in leaf order.

        A spec with observability on gets a fresh ``Observability`` bundle
        (``build_session``); the bundle holds no state leaves.

        The generator continues where it stopped when the checkpoint holds a
        generator state of the same device type.  Otherwise (a checkpoint the
        JAX package wrote, or one from the card loaded on the CPU) it is a
        freshly built session's for the spec: the random stream does not
        continue across packages or device types, so inject the draws
        (``round(batch_idx=, eps=, batch_seed=)``) to follow another run."""
        spec_doc, leaves, round_idx, _, gen = restore_session(path)
        session = build_session(ExperimentSpec.from_doc(spec_doc), device=device)
        ref = tree_leaves(session.state)
        if len(leaves) != len(ref):
            raise ValueError(
                f"checkpoint has {len(leaves)} state leaves, the rebuilt engine "
                f"expects {len(ref)}"
            )
        session.state = tree_replace_leaves(
            session.state, [restore_leaf(s, r) for s, r in zip(leaves, ref)])
        session.round_idx = int(round_idx)
        if gen is not None and gen["device"] == session.device.type:
            session.generator.set_state(
                torch.frombuffer(bytearray(gen["state"]), dtype=torch.uint8))
        return session
