"""Declarative experiment specification — the paper's whole pipeline as data.

A copy of the JAX package's ``api/spec.py`` (numpy only), so that a spec doc
built by either package builds in both.  Gossip topologies build their
activation clocks from this package's own copy of ``gossip.clocks``.

An ``ExperimentSpec`` is a pure-data description of one decentralized-
Bayesian-learning experiment (Sec 2.1): WHO talks to whom (``TopologySpec``,
the row-stochastic W of eq. 6 — static, scheduled, or round-indexed), WHAT
each agent observes (``DataSpec``, dataset + non-IID partition strategy),
HOW each agent updates its posterior (``InferenceSpec``, Bayes-by-Backprop
hyperparameters or the conjugate linear-regression family of Example 1),
and the run envelope (``RunSpec``, rounds / seed / engine).

``build_session`` (see ``api.session``) validates the whole spec EAGERLY —
connectivity (Assumption 1), row-stochasticity, agent-count and shape
agreement — before any compute, and returns a ``Session`` backed by an
engine.  Specs round-trip through ``to_doc``/``from_doc`` so checkpoints are
self-describing (``Session.save`` embeds the doc; ``Session.load`` rebuilds
the session from it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.core import graphs

PyTree = Any

_NAMED_TOPOLOGIES = {
    "star": graphs.star_w,
    "grid": graphs.grid_w,
    "ring": graphs.ring_w,
    "bidirectional_ring": graphs.bidirectional_ring_w,
    "torus": graphs.torus_w,
    "complete": graphs.complete_w,
    "erdos": graphs.erdos_w,
    # dense bridges of the sparse small-world generators, so they work as
    # named kinds and gossip bases at moderate N; use kind="sparse" at scale
    "watts_strogatz": graphs.watts_strogatz_w,
    "barabasi_albert": graphs.barabasi_albert_w,
}

#: Above this agent count a ``kind="sparse"`` topology refuses to derive a
#: dense W: a [4096, 4096] f64 matrix is 128 MiB and anything past it is the
#: O(N^2) regime the edge-native runtime exists to avoid.
SPARSE_DENSE_GUARD = 4096


def _freeze(d: dict | None) -> dict:
    return dict(d) if d else {}


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """The communication graph: a named builder, an explicit W, or a
    round-indexed schedule (subsumes ``time_varying_star_schedule``).

    kind:
      one of ``star | grid | ring | bidirectional_ring | torus | complete |
      erdos`` (named static builders, parameterized by ``params``),
      ``explicit`` (``w`` holds the [N, N] matrix), ``schedule`` (``schedule``
      holds a list of W's cycled over rounds), ``time_varying_star`` (paper
      Sec 1.4.3, ``params`` = n_agents/n_active/a), ``callable``
      (``schedule`` holds a ``Callable[[int], W]``; requires ``agents`` and
      is not checkpoint-embeddable), or ``gossip`` (event-driven
      asynchronous runtime: ``params`` names the base graph —
      ``{"base": <named kind>, "base_params": {...}}`` or
      ``{"base": "explicit", "w": [[...]]}`` — and ``clock`` is the plain-
      dict activation-clock description of ``repro.gossip.clocks
      .build_clock``; selects the ``GossipEngine``, one event window per
      round), or ``sparse`` (edge-native CSR topology: ``params`` carries a
      generator name + its kwargs, e.g. ``{"generator": "watts_strogatz",
      "n": 10_000, "k": 6, "beta": 0.1}``; see below).

    kind="sparse" (population scale, N = 10^4+):
      ``params["generator"]`` names a ``repro.core.graphs.SPARSE_GENERATORS``
      builder — ``ring | bidirectional_ring | grid | torus | star`` (the
      named topologies without the [N, N] allocation) or the small-world
      generators ``watts_strogatz`` (n, k, beta, seed) and
      ``barabasi_albert`` (n, m, seed); the remaining params are the
      builder's kwargs.  The doc is plain data (checkpoint-embeddable) and
      ``validate()`` runs entirely on the CSR arrays — row-stochasticity and
      the iterative strong-connectivity check — without materializing W.
      ``sparse_graph()`` returns the memoized ``SparseGraph``; a dense W is
      derived lazily (``w_schedule()``/``_static_list()``) and ONLY below
      ``SPARSE_DENSE_GUARD`` agents — above it, drive the edge-native
      runtime directly (``SparseGraph.edge_arrays()`` +
      ``core.flat.consensus_flat_segments``).

      An optional ``clock`` dict (``repro.gossip.clocks.build_sparse_clock``
      kinds: ``poisson | all_edges | failure_injected``, plus a top-level
      ``"faults"`` entry) turns the sparse topology into the EDGE-NATIVE
      gossip runtime: ``w_schedule()`` yields the clock's ``SparseWindow``
      stream (fired [E_w] edge arrays + self-weights + the exact active
      mask — never a dense W) and the ``GossipEngine`` executes each window
      through ``core.flat.consensus_flat_segments``
      (``InferenceSpec.consensus_impl="segments"``, the ``"auto"`` choice
      for this shape) — the only gossip path that runs above the guard.
    """

    kind: str = "complete"
    params: dict = dataclasses.field(default_factory=dict)
    w: Any = None
    schedule: Any = None
    agents: int | None = None  # only needed for kind="callable"
    clock: dict | None = None  # kind="gossip" | kind="sparse" (edge-native)

    # -- conveniences --------------------------------------------------------

    @classmethod
    def star(cls, n_edge: int, a: float) -> "TopologySpec":
        return cls(kind="star", params={"n_edge": n_edge, "a": a})

    @classmethod
    def grid(cls, rows: int, cols: int) -> "TopologySpec":
        return cls(kind="grid", params={"rows": rows, "cols": cols})

    @classmethod
    def complete(cls, n: int) -> "TopologySpec":
        return cls(kind="complete", params={"n": n})

    @classmethod
    def explicit(cls, w) -> "TopologySpec":
        return cls(kind="explicit", w=np.asarray(w, np.float64))

    @classmethod
    def from_schedule(cls, mats: Sequence) -> "TopologySpec":
        return cls(kind="schedule", schedule=[np.asarray(m, np.float64) for m in mats])

    @classmethod
    def time_varying_star(cls, n_agents: int, n_active: int, a: float = 0.5) -> "TopologySpec":
        return cls(
            kind="time_varying_star",
            params={"n_agents": n_agents, "n_active": n_active, "a": a},
        )

    @classmethod
    def from_callable(cls, fn: Callable[[int], Any], n_agents: int) -> "TopologySpec":
        return cls(kind="callable", schedule=fn, agents=n_agents)

    @classmethod
    def sparse(
        cls, generator: str, clock: dict | None = None, **params
    ) -> "TopologySpec":
        """Edge-native CSR topology (``kind="sparse"``): ``generator`` names
        a ``graphs.SPARSE_GENERATORS`` builder, ``params`` are its kwargs —
        e.g. ``TopologySpec.sparse("watts_strogatz", n=10_000, k=6,
        beta=0.1, seed=0)``.  Pass ``clock`` (a ``build_sparse_clock`` doc,
        e.g. ``{"kind": "poisson", "rate": 1.0}``) to gossip on the graph
        with edge-native event windows."""
        return cls(
            kind="sparse",
            params={"generator": generator, **params},
            clock=dict(clock) if clock else None,
        )

    @classmethod
    def gossip(
        cls,
        base: str,
        base_params: dict | None = None,
        clock: dict | None = None,
        w=None,
    ) -> "TopologySpec":
        """Event-driven gossip on a base graph: ``base`` names a builder
        (``ring | grid | ...``) parameterized by ``base_params``, or
        ``base="explicit"`` with ``w``; ``clock`` is the activation-clock
        dict (default: unit-rate Poisson).  Fully checkpoint-embeddable."""
        if w is not None and base != "explicit":
            raise ValueError(
                f"gossip(w=...) requires base='explicit'; base={base!r} "
                "would silently ignore the provided matrix"
            )
        params: dict = {"base": base, "base_params": dict(base_params or {})}
        if w is not None:
            params["w"] = np.asarray(w, np.float64).tolist()
        return cls(
            kind="gossip",
            params=params,
            clock=dict(clock) if clock else {"kind": "poisson", "rate": 1.0},
        )

    @classmethod
    def gossip_from_schedule(
        cls, mats: Sequence, clock_extra: dict | None = None
    ) -> "TopologySpec":
        """Re-express a W schedule (e.g. ``time_varying_star_schedule``) as a
        gossip trace: the schedule's per-slot active edges become per-window
        activation events over the shared weight table.  The resulting spec
        runs on the ``GossipEngine`` and reproduces the scheduled runs."""
        from repro_torch.gossip.clocks import trace_from_schedule

        table, trace = trace_from_schedule([np.asarray(m) for m in mats])
        clock = {
            "kind": "trace",
            "trace": [[[int(i), int(j)] for i, j in slot] for slot in trace],
            "rule": "table",
        }
        clock.update(clock_extra or {})
        return cls(
            kind="gossip",
            params={"base": "explicit", "w": table.tolist()},
            clock=clock,
        )

    # -- materialization -----------------------------------------------------

    def base_w(self) -> np.ndarray:
        """kind="gossip": the base graph / weight table the clock fires on."""
        if self.kind != "gossip":
            raise ValueError("base_w() is only defined for kind='gossip'")
        base = self.params.get("base")
        if base is None:
            raise ValueError(
                "TopologySpec(kind='gossip') requires params={'base': ...}"
            )
        if base == "explicit":
            if self.params.get("w") is None:
                raise ValueError("gossip base='explicit' requires params['w']")
            return np.asarray(self.params["w"], np.float64)
        if base not in _NAMED_TOPOLOGIES:
            raise ValueError(
                f"unknown gossip base {base!r}; known: "
                f"{sorted(_NAMED_TOPOLOGIES) + ['explicit']}"
            )
        try:
            return _NAMED_TOPOLOGIES[base](**_freeze(self.params.get("base_params")))
        except TypeError as e:
            raise ValueError(f"gossip base={base!r} params mismatch: {e}") from e

    def gossip_clock(self):
        """kind="gossip" | kind="sparse"+clock: build the activation clock.

        kind="gossip" builds a dense EventWindow clock over ``base_w()``
        (``build_clock``); kind="sparse" with a ``clock`` dict builds an
        edge-native ``SparseClock`` over the CSR graph
        (``build_sparse_clock`` — windows are ``SparseWindow`` objects).

        Memoized on the (frozen) spec: construction eagerly validates every
        distinct trace window, so ``validate()`` and ``w_schedule()`` must
        not each pay it again."""
        cached = getattr(self, "_clock_cache", None)
        if cached is not None:
            return cached
        if self.kind == "sparse":
            if self.clock is None:
                raise ValueError(
                    "this sparse topology has no clock dict; gossip_clock() "
                    "needs one (e.g. {'kind': 'poisson', 'rate': 1.0})"
                )
            from repro_torch.gossip.clocks import build_sparse_clock

            clock = build_sparse_clock(self.clock, self.sparse_graph())
            object.__setattr__(self, "_clock_cache", clock)
            return clock
        from repro_torch.gossip.clocks import build_clock

        if self.clock is None:
            raise ValueError("TopologySpec(kind='gossip') requires a clock dict")
        clock = build_clock(self.clock, self.base_w())
        object.__setattr__(self, "_clock_cache", clock)
        return clock

    def sparse_graph(self):
        """kind="sparse": the memoized, eagerly validated ``SparseGraph``.

        Construction runs the generator AND its Assumption-1 validation on
        the CSR arrays (O(E) memory, iterative connectivity check) — the
        sparse analogue of ``check_w`` on the named dense builders."""
        if self.kind != "sparse":
            raise ValueError("sparse_graph() is only defined for kind='sparse'")
        cached = getattr(self, "_sparse_cache", None)
        if cached is not None:
            return cached
        params = _freeze(self.params)
        generator = params.pop("generator", None)
        if generator is None:
            raise ValueError(
                "TopologySpec(kind='sparse') requires params={'generator': "
                f"...}}; known generators: {sorted(graphs.SPARSE_GENERATORS)}"
            )
        try:
            graph = graphs.build_sparse(generator, **params)
        except TypeError as e:
            raise ValueError(
                f"sparse generator {generator!r} params mismatch: {e}"
            ) from e
        object.__setattr__(self, "_sparse_cache", graph)
        return graph

    def _static_list(self) -> list | None:
        """The full W list for non-callable kinds (None for ``callable``).

        kind="sparse" derives its dense W HERE — lazily, and only below
        ``SPARSE_DENSE_GUARD`` agents."""
        if self.kind == "sparse":
            graph = self.sparse_graph()
            if graph.n_agents > SPARSE_DENSE_GUARD:
                raise ValueError(
                    f"sparse topology has N={graph.n_agents} agents, above "
                    f"the dense-materialization guard ({SPARSE_DENSE_GUARD}): "
                    "refusing to allocate [N, N]; drive the edge-native "
                    "runtime instead (sparse_graph().edge_arrays() + "
                    "core.flat.consensus_flat_segments)"
                )
            return [graph.to_dense()]
        if self.kind in _NAMED_TOPOLOGIES:
            try:
                return [_NAMED_TOPOLOGIES[self.kind](**_freeze(self.params))]
            except TypeError as e:
                raise ValueError(
                    f"TopologySpec(kind={self.kind!r}) params mismatch: {e}"
                ) from e
        if self.kind == "explicit":
            if self.w is None:
                raise ValueError("TopologySpec(kind='explicit') requires w")
            return [np.asarray(self.w, np.float64)]
        if self.kind == "schedule":
            if not self.schedule:
                raise ValueError("TopologySpec(kind='schedule') requires a non-empty schedule")
            return [np.asarray(m, np.float64) for m in self.schedule]
        if self.kind == "time_varying_star":
            return graphs.time_varying_star_schedule(**_freeze(self.params))
        if self.kind in ("callable", "gossip"):
            return None
        raise ValueError(
            f"unknown topology kind {self.kind!r}; known: "
            f"{sorted(_NAMED_TOPOLOGIES) + ['explicit', 'schedule', 'time_varying_star', 'callable', 'gossip', 'sparse']}"
        )

    def w_schedule(self) -> Callable[[int], np.ndarray]:
        """Round-indexed ``Callable[[int], W]`` (the canonical form).  For
        kind="gossip" this is the clock's window stream: round r's matrix is
        window r's effective W-tilde (a pure function of the clock seed and
        r, so resumed sessions regenerate the identical event stream)."""
        if self.kind == "callable":
            return self.schedule
        if self.kind == "gossip":
            clock = self.gossip_clock()
            return lambda r: clock.window(r).w_eff
        if self.kind == "sparse" and self.clock is not None:
            # edge-native stream: the schedule yields the SparseWindow
            # OBJECTS themselves (the GossipEngine consumes them verbatim —
            # ``wants_host_w``); no dense W exists on this path
            clock = self.gossip_clock()
            return lambda r: clock.window(r)
        mats = self._static_list()
        return lambda r: mats[r % len(mats)]

    def n_agents(self) -> int:
        if self.kind == "callable":
            if self.agents is None:
                raise ValueError(
                    "TopologySpec(kind='callable') requires the explicit "
                    "``agents`` count (the schedule length is unknowable)"
                )
            return self.agents
        if self.kind == "gossip":
            return int(self.base_w().shape[0])
        if self.kind == "sparse":
            return self.sparse_graph().n_agents
        return int(np.asarray(self._static_list()[0]).shape[0])

    def validate(self) -> None:
        """Paper Assumption 1 prerequisites, eagerly.

        Static kinds: W square, nonnegative, row-stochastic, self-loops,
        strongly connected.  Schedules: every slot row-stochastic; the UNION
        over the schedule strongly connected (the time-varying relaxation).
        Callable: round-0 W checked without the connectivity requirement
        (the union over an unbounded schedule cannot be enumerated).
        Gossip: the clock is built eagerly (per-kind parameter/feasibility
        checks) and the expected activation-graph UNION must be strongly
        connected (the time-varying relaxation of Assumption 1).
        """
        if self.kind == "gossip":
            self.gossip_clock().validate()
            return
        if self.kind == "sparse":
            # O(E) throughout: generator + CSR validation, never a dense W
            self.sparse_graph().validate(require_connected=True)
            if self.clock is not None:
                self.gossip_clock().validate()
            return
        if self.kind == "callable":
            W0 = np.asarray(self.schedule(0), np.float64)
            graphs.check_w(W0, require_connected=False)
            if self.agents is not None and W0.shape[0] != self.agents:
                raise ValueError(
                    f"callable topology produced a {W0.shape[0]}-agent W but "
                    f"the spec declares agents={self.agents}"
                )
            return
        mats = self._static_list()
        if len(mats) == 1:
            graphs.check_w(mats[0], require_connected=True)
            return
        for m in mats:
            graphs.check_w(m, require_connected=False)
        graphs.check_schedule_union(mats)


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """What each agent observes: dataset family + non-IID partition strategy
    + the per-round batching contract (u local minibatches of size B).

    dataset: ``synthetic_classification | mnist_like | fmnist_like``
    (classification stand-ins, ``dataset_params`` forwarded to
    ``data.synthetic``) or ``linreg`` (paper Example 1,
    ``dataset_params`` forwarded to ``data.linreg.make_linreg_task``).

    partition (classification only): ``iid | by_label | star | grid``
    (``partition_params`` forwarded to ``data.partition``).
    """

    dataset: str = "synthetic_classification"
    dataset_params: dict = dataclasses.field(default_factory=dict)
    partition: str = "iid"
    partition_params: dict = dataclasses.field(default_factory=dict)
    batch_size: int = 16
    local_updates: int = 4

    def validate(self) -> None:
        if self.dataset not in (
            "synthetic_classification", "mnist_like", "fmnist_like", "linreg",
        ):
            raise ValueError(f"unknown dataset {self.dataset!r}")
        if self.dataset != "linreg" and self.partition not in (
            "iid", "by_label", "star", "grid",
        ):
            raise ValueError(f"unknown partition {self.partition!r}")
        if self.batch_size <= 0 or self.local_updates <= 0:
            raise ValueError("batch_size and local_updates must be positive")


@dataclasses.dataclass(frozen=True)
class InferenceSpec:
    """How each agent updates its posterior between consensus steps.

    method="bbb": Bayes-by-Backprop (paper Remark 1 / eq. 5) on the model
    from the registry (``api.models``) — the NN experiments.
    method="conjugate_linreg": the exact conjugate full-covariance update of
    Example 1 (eq. 2); model/optimizer fields are ignored.

    ``consensus_impl`` picks the EXECUTION of the (gossip) consensus, not
    its math — every impl is bit-identical by test:
      ``auto``      the dense masked window kernel (default);
      ``masked``    force the dense masked kernel;
      ``ppermute``  shard the agent axis over the local devices and execute
                    each event window as one ``shard_map`` that ppermutes
                    only the window's fired shard offsets
                    (``launch.consensus_opt.consensus_ppermute_window``);
                    ``consensus_shards`` caps/pins the shard count (None =
                    the largest divisor of n_agents <= local device count).

    ``wire_dtype`` (``"f32" | "bf16" | "f16"``) picks the PRECISION of the
    consensus exchange, orthogonal to ``consensus_impl``: the (prec,
    prec*mu) sufficient statistics are cast to the wire dtype at the
    exchange boundary and accumulated fp32 (ROADMAP "Wire precision") —
    at bf16 the collective/ICI bytes halve.  ``"f32"`` (default) is
    bitwise the uncompressed path on every impl; narrower dtypes agree
    with it within the derived bound (``core.numerics.wire_error_bound``,
    tests/test_wire_dtype.py).  ``history_dtype`` (None = fp32) optionally
    stores the delivery-latency [K, N, P] posterior history ring in a
    narrower resident dtype (halving its HBM footprint at bf16); only
    meaningful with a delayed gossip clock.

    ``fault_policy`` picks the consensus defense against corrupted
    exchange payloads (ROADMAP "Robustness"):
      ``strict``      trust every incoming contribution verbatim (default;
                      an injected NaN/Inf poisons every reachable agent —
                      the undefended failure mode);
      ``quarantine``  validate every incoming (prec, prec*mu) contribution
                      at the exchange boundary (finite, prec > 0, magnitude
                      bound — ``core.flat.payload_validity``), drop invalid
                      ones and reassign their W-tilde row mass to self.
                      With zero faults the quarantined path is BITWISE
                      identical to strict on every consensus impl.
    """

    method: str = "bbb"
    model: str = "mlp"
    hidden: int = 48
    depth: int = 2
    init_sigma: float = 0.05
    shared_init: bool = True
    optimizer: str = "adam"
    lr: float = 5e-3
    lr_decay: float = 0.99  # multiplicative, per communication round (paper)
    kl_scale: float = 1e-3
    n_mc_samples: int = 1
    consensus: str = "gaussian"  # gaussian | mean_only | none
    consensus_impl: str = "auto"  # auto | masked | ppermute | segments (gossip)
    consensus_shards: int | None = None  # ppermute only; None = auto
    wire_dtype: str = "f32"  # f32 | bf16 | f16: consensus exchange precision
    history_dtype: str | None = None  # delayed gossip ring residency (None=f32)
    fault_policy: str = "strict"  # strict | quarantine: exchange validation
    prior_var: float = 0.5  # conjugate_linreg prior N(0, prior_var I)

    def validate(self) -> None:
        if self.method not in ("bbb", "conjugate_linreg"):
            raise ValueError(f"unknown inference method {self.method!r}")
        if self.optimizer not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.consensus not in ("gaussian", "mean_only", "none"):
            raise ValueError(f"unknown consensus mode {self.consensus!r}")
        if self.consensus_impl not in ("auto", "masked", "ppermute", "segments"):
            raise ValueError(
                f"unknown consensus_impl {self.consensus_impl!r}; known: "
                "auto | masked | ppermute | segments"
            )
        if self.wire_dtype not in ("f32", "bf16", "f16"):
            raise ValueError(
                f"unknown wire_dtype {self.wire_dtype!r}; known: "
                "f32 | bf16 | f16"
            )
        if self.history_dtype not in (None, "f32", "bf16", "f16"):
            raise ValueError(
                f"unknown history_dtype {self.history_dtype!r}; known: "
                "None | f32 | bf16 | f16"
            )
        if self.wire_dtype != "f32" and self.consensus != "gaussian":
            raise ValueError(
                "wire_dtype compresses the gaussian (prec, prec*mu) "
                f"exchange; consensus={self.consensus!r} (mean_only has no "
                "wire-compressed path, none exchanges nothing) would "
                "silently ignore it"
            )
        if self.wire_dtype != "f32" and self.method == "conjugate_linreg":
            raise ValueError(
                "wire_dtype applies to the mean-field consensus exchange; "
                "the conjugate_linreg engine would silently ignore it"
            )
        if self.fault_policy not in ("strict", "quarantine"):
            raise ValueError(
                f"unknown fault_policy {self.fault_policy!r}; known: "
                "strict | quarantine"
            )
        if self.fault_policy == "quarantine" and self.consensus != "gaussian":
            raise ValueError(
                "fault_policy='quarantine' validates the gaussian (prec, "
                f"prec*mu) exchange; consensus={self.consensus!r} has no "
                "quarantined path and would silently ignore it"
            )
        if self.consensus_shards is not None:
            if self.consensus_shards <= 0:
                raise ValueError(
                    "consensus_shards must be a positive int or None"
                )
            if self.consensus_impl != "ppermute":
                raise ValueError(
                    "consensus_shards only applies to consensus_impl="
                    "'ppermute' (it would be silently ignored otherwise)"
                )


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """The serving-tier contract (ROADMAP "Serving"; ``repro.serve``).

    ``snapshot_dtype`` picks the RESIDENCY of published posterior snapshots
    (``"f32" | "bf16" | "f16"`` — the shared ``core.numerics`` wire-dtype
    vocabulary): a bf16-resident snapshot halves the serving HBM
    (``launch.costmodel.serve_roofline``) and is decoded to fp32 inside the
    jitted apply.  ``mc_samples`` is the default predictive ensemble size L
    (0 = point estimate at the posterior mean); ``bucket_sizes`` the
    ascending padding buckets the request micro-batcher compiles for;
    ``max_staleness`` the SLO bound in training windows (None = unbounded)
    enforced under ``staleness_policy`` (``"strict"`` refuses with
    ``serve.StalenessSLOError``, ``"flag"`` serves with ``slo_ok=False``).
    """

    snapshot_dtype: str = "f32"  # f32 | bf16 | f16: snapshot residency
    mc_samples: int = 8
    bucket_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32)
    max_staleness: int | None = None  # SLO bound in windows (None = off)
    staleness_policy: str = "strict"  # strict | flag

    def __post_init__(self):
        # normalize to tuple so from_doc(to_doc(spec)) == spec (the doc
        # format lowers tuples to lists)
        object.__setattr__(self, "bucket_sizes", tuple(
            int(b) for b in self.bucket_sizes
        ))

    def validate(self) -> None:
        if self.snapshot_dtype not in ("f32", "bf16", "f16"):
            raise ValueError(
                f"unknown snapshot_dtype {self.snapshot_dtype!r}; known: "
                "f32 | bf16 | f16"
            )
        if self.mc_samples < 0:
            raise ValueError("mc_samples must be >= 0 (0 = point estimate)")
        if (not self.bucket_sizes
                or any(b <= 0 for b in self.bucket_sizes)
                or list(self.bucket_sizes) != sorted(set(self.bucket_sizes))):
            raise ValueError(
                "bucket_sizes must be a strictly ascending sequence of "
                f"positive ints, got {self.bucket_sizes!r}"
            )
        if self.max_staleness is not None and self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0 windows (or None)")
        if self.staleness_policy not in ("strict", "flag"):
            raise ValueError(
                f"unknown staleness_policy {self.staleness_policy!r}; "
                "known: strict | flag"
            )


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """The observability contract (ROADMAP "Observability"; ``repro.obs``).

    OFF by default, and a pure observer when on: enabling observability
    never changes trajectories, jit trace counts, or checkpoint leaf
    structure (pinned by ``tests/test_obs.py``).  With ``enabled=True`` the
    session carries an ``Observability`` bundle (``session.obs``): a
    ``MetricsRegistry`` every telemetry number lands in, a wall-clock
    ``Tracer`` over the round lifecycle (``trace``), and a
    ``ConvergenceTracker`` sampling network disagreement / KL-to-network-
    mean every ``convergence_every`` rounds (``convergence``) — overlaid
    against ``core.theory``'s predicted decay for static topologies.
    ``jsonl_path`` streams metric events and spans to an append-only JSONL
    file.  ``session.dashboard()`` renders the compact terminal summary.
    """

    enabled: bool = False
    trace: bool = True  # wall-clock spans (compile-vs-warm attributed)
    convergence: bool = True  # per-round disagreement/KL tracking
    convergence_every: int = 1  # rounds between convergence samples
    jsonl_path: str | None = None  # stream events/spans to this JSONL file

    def validate(self) -> None:
        if self.convergence_every < 1:
            raise ValueError("convergence_every must be >= 1 (rounds)")
        if self.jsonl_path is not None and not isinstance(self.jsonl_path, str):
            raise ValueError("jsonl_path must be a path string or None")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Run envelope: length, seed, engine, eval cadence."""

    n_rounds: int = 20
    seed: int = 0
    engine: str = "simulated"  # simulated | launch | gossip
    eval_every: int = 0
    jit: bool = True

    def validate(self) -> None:
        if self.engine not in ("simulated", "launch", "gossip"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.n_rounds < 0:
            raise ValueError("n_rounds must be nonnegative")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment = topology x data x inference x run (+ serving,
    observability)."""

    topology: TopologySpec = dataclasses.field(default_factory=TopologySpec)
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    inference: InferenceSpec = dataclasses.field(default_factory=InferenceSpec)
    run: RunSpec = dataclasses.field(default_factory=RunSpec)
    serve: ServeSpec = dataclasses.field(default_factory=ServeSpec)
    obs: ObsSpec = dataclasses.field(default_factory=ObsSpec)

    def validate(self) -> None:
        self.data.validate()
        self.inference.validate()
        self.run.validate()
        self.serve.validate()
        self.obs.validate()
        if self.inference.method == "conjugate_linreg" and self.data.dataset != "linreg":
            raise ValueError("conjugate_linreg inference requires dataset='linreg'")
        if self.data.dataset == "linreg" and self.inference.method != "conjugate_linreg":
            raise ValueError("dataset='linreg' requires method='conjugate_linreg'")
        if self.inference.method == "conjugate_linreg" and self.run.engine == "launch":
            raise ValueError("the launch engine backs Bayes-by-Backprop inference only")
        # "gossiping" = the GossipEngine drives the run: a dense gossip
        # topology, or a sparse topology with an edge-native clock attached
        gossiping = (self.topology.kind == "gossip"
                     or (self.topology.kind == "sparse"
                         and self.topology.clock is not None))
        if gossiping:
            if self.run.engine == "launch":
                raise ValueError(
                    "a gossip topology runs on the GossipEngine (engine="
                    "'gossip' or the 'simulated' default, auto-upgraded); "
                    "the launch engine is synchronous"
                )
            if self.inference.method == "conjugate_linreg":
                raise ValueError(
                    "the gossip runtime backs Bayes-by-Backprop inference only"
                )
        elif self.run.engine == "gossip":
            raise ValueError(
                "engine='gossip' requires a TopologySpec(kind='gossip') "
                "or kind='sparse' with a clock "
                "(the event windows come from the activation clock)"
            )
        if (self.inference.history_dtype is not None
                and self.topology.kind != "gossip"):
            raise ValueError(
                "history_dtype controls the delayed-gossip posterior "
                "history ring and requires a TopologySpec(kind='gossip') "
                "with a delayed clock (it would be silently ignored "
                "otherwise)"
            )
        if self.inference.fault_policy != "strict" and not gossiping:
            raise ValueError(
                "fault_policy='quarantine' guards the gossip consensus "
                "exchange and requires a TopologySpec(kind='gossip') (the "
                "synchronous engines have no exchange boundary to validate)"
            )
        if self.inference.consensus_impl != "auto":
            if not gossiping:
                raise ValueError(
                    "consensus_impl selects the gossip window execution and "
                    "requires a TopologySpec(kind='gossip') or kind='sparse' "
                    "with a clock; the synchronous engines dispatch via "
                    "core.posterior.consensus_all_agents"
                )
            if (self.inference.consensus_impl == "ppermute"
                    and self.inference.consensus != "gaussian"):
                raise ValueError(
                    "consensus_impl='ppermute' shards the gaussian eq.-(6) "
                    "window; mean_only/none consensus run the dense path"
                )
            if (self.inference.consensus_impl == "segments"
                    and self.topology.kind != "sparse"):
                raise ValueError(
                    "consensus_impl='segments' executes edge-native "
                    "SparseWindows and requires a TopologySpec(kind="
                    "'sparse') with a clock (dense gossip clocks emit "
                    "[N, N] EventWindows — use 'masked' or 'ppermute')"
                )
            if (self.inference.consensus_impl == "segments"
                    and self.inference.consensus == "mean_only"):
                raise ValueError(
                    "consensus_impl='segments' implements gaussian/none "
                    "consensus; mean_only (the FedAvg baseline) runs on "
                    "the dense masked path"
                )
        self.topology.validate()

    # -- checkpoint doc (msgpack-able plain data) ----------------------------

    def to_doc(self) -> dict:
        if self.topology.kind == "callable":
            raise ValueError(
                "a callable topology schedule cannot be embedded in a "
                "checkpoint; use kind='schedule' (materialized W list) for "
                "resumable runs"
            )
        doc = dataclasses.asdict(self)
        return _plainify(doc)

    @classmethod
    def from_doc(cls, doc: dict) -> "ExperimentSpec":
        topo = dict(doc["topology"])
        if topo.get("w") is not None:
            topo["w"] = np.asarray(topo["w"], np.float64)
        if topo.get("schedule") is not None:
            topo["schedule"] = [np.asarray(m, np.float64) for m in topo["schedule"]]
        return cls(
            topology=TopologySpec(**topo),
            data=DataSpec(**doc["data"]),
            inference=InferenceSpec(**doc["inference"]),
            run=RunSpec(**doc["run"]),
            # absent in pre-serving / pre-observability checkpoints: defaults
            serve=ServeSpec(**doc.get("serve") or {}),
            obs=ObsSpec(**doc.get("obs") or {}),
        )


def _plainify(node):
    """Recursively lower numpy arrays/scalars and tuples to msgpack-able
    lists/py-scalars (the checkpoint document format)."""
    if isinstance(node, dict):
        return {k: _plainify(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plainify(v) for v in node]
    if isinstance(node, np.ndarray):
        return _plainify(node.tolist())
    if isinstance(node, np.generic):
        return node.item()
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    raise TypeError(f"spec field of type {type(node)} is not checkpoint-embeddable")
