"""Activation clocks: continuous-time gossip discretized into event windows.

A copy of the JAX package's ``gossip/clocks.py`` (numpy only, imports
repointed at this package), so that a clock doc gives the same window
stream, bit for bit, in both packages.

The asynchronous model (paper Sec 1/2; BayGo, Lalitha et al. 2019) lets each
directed edge (i <- j) of the communication graph fire on its own clock.  A
naive simulation dispatches Python per event — unjittable and orders of
magnitude too slow.  Instead a clock discretizes time into **event
windows**: all edge activations inside one window are applied as one masked
consensus over the flat [N, P] posterior, so every window is the SAME jitted
program (static shapes) and the runtime does zero per-event dispatch.

An ``EventWindow`` carries

* ``edges [E_max, 2]`` int32 — the window's directed activation events
  ``(dst, src)`` (dst merges src's posterior), zero-padded to the clock's
  static ``e_max``;
* ``weights [E_max]`` — the base mixing weight of each event edge (0.0 on
  pad slots);
* ``active [N]`` bool — agents with at least one incoming event (only these
  merge; everyone else passes through the window untouched);
* ``w_eff [N, N]`` — the window's effective row-stochastic W-tilde (see
  below), the matrix handed to ``Session``/``Engine.run_round``;
* ``delays [E_max]`` int32 — per-event delivery lag in windows (0 = the
  classic instant-delivery model).  A lag-k event delivers the SRC POSTERIOR
  AS OF FIRE TIME: the engine merges src's post-local-step (pre-merge)
  posterior of window ``index - k``, read from a bounded [K, N, P] history
  ring buffer (``gossip.engine``).  Only ``DelayedClock`` emits
  nonzero lags.

W-tilde construction, two rules:

* ``"conserve"`` (default; requires a row-stochastic base W): an active
  row keeps the base weight on each fired in-edge and moves every
  non-fired in-edge's weight onto SELF —
  ``w_eff[i,i] = W[i,i] + sum_{j not fired} W[i,j]``.  With ALL edges
  fired, ``w_eff == W`` exactly (bitwise), which is what makes the
  all-active gossip window reproduce the synchronous fused consensus
  bit-identically.
* ``"table"`` (for weight-table traces, e.g. a re-expressed
  ``time_varying_star_schedule`` whose base rows need not sum to 1):
  ``w_eff[i,i] = 1 - sum_{j fired} W[i,j]``.

Rows with no event are EXACTLY ``e_i`` (diag 1.0) either way.  The
window's host-computed ``active`` mask is the AUTHORITATIVE activity
signal: the engine threads it into the jitted window as an explicit
argument (re-deriving it from the float32-cast diagonal would silently
drop any fired in-edge whose weight is below f32 resolution — ``1.0 - w``
rounds back to exactly 1.0 for w < 2^-24) and the masked consensus kernel
passes inactive rows through without touching them.

Population scale (``SparseWindow`` / ``SparseClock``): above
``SPARSE_DENSE_GUARD`` agents no ``[N, N]`` matrix may exist, so the
edge-native clock family samples fired edges directly from a CSR
``SparseGraph``'s non-self edge list and emits ``SparseWindow``s — fired
``[E_w]`` dst/src/weight arrays plus the per-agent conserve-rule
self-weight vector and the explicit ``active`` mask, built in O(fired + N)
host work per window.  The dense ``w_eff`` survives only as a derived view
below the guard (the equivalence ladder against the dense masked engine).

Determinism contract: ``window(r)`` is a pure function of ``(seed, r)``
(fresh ``np.random.default_rng([seed, r])`` per window), so a resumed
session regenerates the identical event stream from any round index.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import graphs


@dataclasses.dataclass(frozen=True)
class EventWindow:
    """One jit-ready event window (see module docstring)."""

    index: int
    edges: np.ndarray  # [E_max, 2] int32 (dst, src), zero-padded
    weights: np.ndarray  # [E_max] float32, 0.0 on pad slots
    active: np.ndarray  # [N] bool
    w_eff: np.ndarray  # [N, N] float64 row-stochastic
    n_events: int  # real events before padding
    delays: np.ndarray = None  # [E_max] int32 delivery lag, 0 on pad slots

    def __post_init__(self):
        if self.delays is None:
            object.__setattr__(
                self, "delays", np.zeros((self.edges.shape[0],), np.int32)
            )

    @property
    def n_agents(self) -> int:
        return self.w_eff.shape[0]

    @property
    def active_fraction(self) -> float:
        return float(self.active.mean())

    @property
    def max_lag(self) -> int:
        """Largest delivery lag carried by a real (non-pad) event."""
        if not self.n_events:
            return 0
        return int(self.delays[: self.n_events].max())

    def participating(self) -> np.ndarray:
        """[N] bool: agents touched by any event (as dst or src) — the rows a
        traffic-optimal window kernel must read (see
        ``launch.costmodel.gossip_window_roofline``)."""
        part = self.active.copy()
        if self.n_events:
            part[self.edges[: self.n_events, 1]] = True
        return part


@dataclasses.dataclass(frozen=True)
class SparseWindow:
    """One edge-native event window: no ``[N, N]`` anywhere.

    The population-scale counterpart of ``EventWindow``: the window is the
    fired edge LIST itself — ``[E_max]`` dst/src/weight arrays (zero-padded
    to the clock's static capacity so every window shares one jit trace) —
    plus the per-agent ``"conserve"``-rule self-weight vector and the
    EXPLICIT host-exact ``active`` mask.  The engine folds ``self_weight``
    into the segment-sum consensus (``core.flat.consensus_flat_segments``)
    as N additional self edges; an all-fired window's self-weights equal
    the base diagonal EXACTLY (bitwise), mirroring ``EventWindow``'s
    all-fired ``w_eff == W`` contract.

    ``active`` is authoritative: inactive rows carry ``self_weight`` 1.0
    and zero fired in-edges, but the engine never re-derives activity from
    those weights (the f32 diagonal trick loses sub-2^-24 in-weights).

    ``w_eff`` exists only as a derived dense view BELOW the spec's
    ``SPARSE_DENSE_GUARD`` — the equivalence-ladder bridge that lets the
    dense masked engine execute the same window for comparison.
    """

    index: int
    dst: np.ndarray  # [E_max] int32 fired-edge destinations, zero-padded
    src: np.ndarray  # [E_max] int32 fired-edge sources, zero-padded
    weights: np.ndarray  # [E_max] float32 base mixing weights, 0.0 on pads
    self_weight: np.ndarray  # [N] float64 conserve diagonal (1.0 on idle rows)
    active: np.ndarray  # [N] bool, host-exact
    n_agents: int
    n_events: int  # real events before padding

    @property
    def e_max(self) -> int:
        return int(self.dst.shape[0])

    @property
    def active_fraction(self) -> float:
        return float(self.active.mean())

    @property
    def max_lag(self) -> int:
        """Sparse clocks are instant-delivery (no latency wrapper yet)."""
        return 0

    def participating(self) -> np.ndarray:
        """[N] bool: agents touched by any fired event (as dst or src)."""
        part = self.active.copy()
        if self.n_events:
            part[self.src[: self.n_events]] = True
        return part

    @property
    def w_eff(self) -> np.ndarray:
        """Derived dense [N, N] view (memoized) — the equivalence-ladder
        bridge to the dense masked engine.  Refuses above the spec's
        ``SPARSE_DENSE_GUARD``: past it this window must execute
        edge-native (``consensus_impl="segments"``)."""
        cached = getattr(self, "_w_eff_cache", None)
        if cached is not None:
            return cached
        from repro_torch.api.spec import SPARSE_DENSE_GUARD

        n = self.n_agents
        if n > SPARSE_DENSE_GUARD:
            raise ValueError(
                f"SparseWindow has N={n} agents, above the dense-"
                f"materialization guard ({SPARSE_DENSE_GUARD}): refusing to "
                "derive [N, N] w_eff; execute the window edge-native "
                "(consensus_impl='segments')"
            )
        w = np.zeros((n, n), np.float64)
        idx = np.arange(n)
        w[idx, idx] = self.self_weight
        e = self.n_events
        w[self.dst[:e], self.src[:e]] = self.weights[:e].astype(np.float64)
        object.__setattr__(self, "_w_eff_cache", w)
        return w


def window_from_events(
    W_base: np.ndarray,
    events: Sequence[tuple[int, int]],
    e_max: int,
    index: int = 0,
    rule: str = "conserve",
    delays: Sequence[int] | None = None,
) -> EventWindow:
    """Build one ``EventWindow`` from a list of fired ``(dst, src)`` edges.

    Events must be edges of the base support (``W_base[dst, src] > 0``,
    ``dst != src``); duplicates within a window collapse to one merge (the
    FIRST occurrence wins, including its delay — callers wanting a different
    collapse rule, e.g. ``DelayedClock``'s most-recent-firing, dedup before
    calling).  ``delays`` (parallel to ``events``) records each delivery's
    lag in windows; ``None`` means instant delivery (all zeros).
    """
    Wb = np.asarray(W_base, np.float64)
    n = Wb.shape[0]
    lag_of = list(delays) if delays is not None else [0] * len(events)
    if len(lag_of) != len(events):
        raise ValueError(
            f"{len(lag_of)} delays for {len(events)} events — must be parallel"
        )
    uniq: list[tuple[int, int]] = []
    uniq_lags: list[int] = []
    seen = set()
    for (i, j), lag in zip(events, lag_of):
        i, j, lag = int(i), int(j), int(lag)
        if i == j:
            raise ValueError(f"self-event ({i}, {j}): self-loops are implicit")
        if Wb[i, j] <= 0:
            raise ValueError(f"event ({i}, {j}) is not an edge of the base graph")
        if lag < 0:
            raise ValueError(f"event ({i}, {j}) has negative delivery lag {lag}")
        if (i, j) not in seen:
            seen.add((i, j))
            uniq.append((i, j))
            uniq_lags.append(lag)
    if len(uniq) > e_max:
        raise ValueError(f"{len(uniq)} events exceed the clock's e_max={e_max}")
    if rule not in ("conserve", "table"):
        raise ValueError(f"unknown w_eff rule {rule!r}")

    active = np.zeros((n,), bool)
    w_eff = np.eye(n)
    for i, j in uniq:
        active[i] = True
    for i in np.nonzero(active)[0]:
        fired = [j for (d, j) in uniq if d == i]
        if rule == "conserve":
            # base weight on fired edges; every NON-fired in-edge's weight
            # moves onto self -> all-fired reproduces the base row bitwise
            support = [j for j in np.nonzero(Wb[i])[0] if j != i]
            idle = [j for j in support if j not in fired]
            w_eff[i, i] = Wb[i, i] + sum(Wb[i, j] for j in idle)
        else:  # "table": leftover mass on self (weight-table traces)
            w_eff[i, i] = 1.0 - sum(Wb[i, j] for j in fired)
        for j in fired:
            w_eff[i, j] = Wb[i, j]
        if w_eff[i, i] <= 0:
            raise ValueError(
                f"window row {i}: fired in-weights sum to "
                f"{1.0 - w_eff[i, i]:.6f} >= 1 (weight table not row-feasible)"
            )

    edges = np.zeros((max(e_max, 1), 2), np.int32)
    weights = np.zeros((max(e_max, 1),), np.float32)
    lags = np.zeros((max(e_max, 1),), np.int32)
    for k, (i, j) in enumerate(uniq):
        edges[k] = (i, j)
        weights[k] = Wb[i, j]
        lags[k] = uniq_lags[k]
    return EventWindow(
        index=index, edges=edges, weights=weights, active=active,
        w_eff=w_eff, n_events=len(uniq), delays=lags,
    )


def _directed_edges(W_base: np.ndarray) -> list[tuple[int, int]]:
    """Non-self directed edges (dst, src) of the base support, fixed order."""
    Wb = np.asarray(W_base)
    return [
        (i, j)
        for i in range(Wb.shape[0])
        for j in np.nonzero(Wb[i])[0]
        if i != int(j)
    ]


def thinned_poisson_indices(
    rng: np.random.Generator, n_edges: int, mu: float, e_max: int | None = None
) -> np.ndarray:
    """O(fired) Poisson edge sampling by superposition thinning.

    The union of ``n_edges`` independent Poisson(mu) edge processes is one
    Poisson(n_edges * mu) process whose firings land on uniformly chosen
    edges: draw the window's TOTAL firing count K ~ Poisson(E * mu), then K
    uniform edge picks.  Each edge's firing count is then exactly
    Poisson(mu), independent across edges — the same per-window event-set
    law as an O(E) pass of per-edge draws, in O(K) work.  At the sparse
    scales this serves (E = 10^5+, mu << 1) the window cost is proportional
    to what actually fires, not to the graph.

    Returns the sorted unique fired edge indices ([K'] int64).  Consumes
    only ``rng``, so a ``default_rng([seed, r])`` caller keeps every window
    a pure function of ``(seed, round)``.  ``e_max`` is the clock-declared
    unique-edge cap: exceeding it raises (the static window shape cannot
    hold the realization) rather than silently truncating.
    """
    if n_edges <= 0:
        return np.zeros(0, np.int64)
    k = int(rng.poisson(n_edges * mu))
    if k == 0:
        return np.zeros(0, np.int64)
    fired = np.unique(rng.integers(0, n_edges, size=k))
    if e_max is not None and fired.size > e_max:
        raise ValueError(
            f"thinned Poisson window fired {fired.size} unique edges, above "
            f"the clock-declared cap e_max={e_max}; raise e_max or lower "
            "rate * window_len"
        )
    return fired


class GossipClock:
    """Base class: a deterministic stream of fixed-shape event windows.

    Subclasses implement ``_events(r, rng) -> list[(dst, src)]``; everything
    else (padding, w_eff, union validation) is shared.  ``e_max`` is the
    static per-window edge capacity — identical across windows so one jit
    trace serves the whole run.  It is a CLOCK-DECLARED cap, not "all
    directed edges": subclasses that know their per-window support
    (``RoundRobinClock``, ``TraceClock``) or accept a declared bound
    (``PoissonClock(e_max=...)``) shrink it, and with it every static
    ``[E_max]`` window buffer the engine jits over.
    """

    rule = "conserve"

    def __init__(self, W_base: np.ndarray, seed: int = 0):
        self.W_base = np.asarray(W_base, np.float64)
        self.n_agents = self.W_base.shape[0]
        self.seed = int(seed)
        self.e_max = max(len(_directed_edges(self.W_base)), 1)
        # agent-level fault model (gossip.faults.FaultModel) — attached on
        # the OUTERMOST clock only (build_clock enforces this; wrappers reach
        # inner clocks through _events, which carries no fault filtering)
        self.faults = None

    # -- subclass hook -------------------------------------------------------

    def _events(self, r: int, rng: np.random.Generator) -> list[tuple[int, int]]:
        raise NotImplementedError

    # -- shared machinery ----------------------------------------------------

    def window(self, r: int) -> EventWindow:
        # one-slot memo: the Session builds window r for its W-tilde and the
        # engine's delayed/sharded paths immediately ask for the same window
        # again — don't pay the (DelayedClock: K+1 inner scans) construction
        # twice per round
        cached = getattr(self, "_last_window", None)
        if cached is not None and cached[0] == int(r):
            return cached[1]
        win = self._build_window(int(r))
        self._last_window = (int(r), win)
        return win

    def _build_window(self, r: int) -> EventWindow:
        rng = np.random.default_rng([self.seed, r])
        events, _ = self._filter_crashed(r, self._events(r, rng))
        return window_from_events(
            self.W_base, events, self.e_max, index=r, rule=self.rule,
        )

    def windows(self, n: int) -> list[EventWindow]:
        return [self.window(r) for r in range(n)]

    # -- agent churn (gossip.faults) -----------------------------------------

    def attach_faults(self, model) -> None:
        """Attach a ``FaultModel`` (see ``gossip.faults``).  A crashed agent
        fires no out-edges and receives nothing: every event whose src was
        down at FIRE time or whose dst is down at DELIVERY time is removed
        before the W-tilde build, so the ``"conserve"`` rule moves the
        dropped in-edge mass onto self and rows stay row-stochastic."""
        self.faults = model
        self._last_window = None  # invalidate the one-slot window memo

    def crashed(self, r: int) -> np.ndarray:
        """[N] bool: agents down during window ``r`` (all-False unfaulted)."""
        if self.faults is None:
            return np.zeros((self.n_agents,), bool)
        return self.faults.crashed(r)

    def _filter_crashed(self, r: int, events, lags=None):
        """Drop events touching crashed agents; returns ``(events, lags)``
        filtered in parallel (``lags`` may be None for instant delivery).

        src must be up at fire time ``r - lag``, dst at delivery time ``r``.
        """
        if self.faults is None or not events:
            return events, lags
        lag_of = [0] * len(events) if lags is None else [int(d) for d in lags]
        up_now = self.faults.up(r)
        keep_e, keep_l = [], []
        for (i, j), d in zip(events, lag_of):
            if up_now[int(i)] and self.faults.up(r - d)[int(j)]:
                keep_e.append((i, j))
                keep_l.append(d)
        return keep_e, (None if lags is None else keep_l)

    def union_support(self) -> np.ndarray:
        """[N, N] 0/1 adjacency of every edge that can EVER activate (self
        loops included) — the graph Assumption 1 is checked against."""
        return (self.W_base > 0).astype(float) + np.eye(self.n_agents)

    def validate(self) -> None:
        """Eager Assumption-1 check on the activation union (the
        time-varying relaxation: each window need not be connected, the
        union must be strongly connected)."""
        graphs.check_schedule_union([self.union_support()])


class PoissonClock(GossipClock):
    """Independent Poisson clock per directed edge (the classic asynchronous
    gossip model): edge (i <- j) fires ~ Poisson(rate * window_len) per
    window; >= 1 firing activates the edge for that window (multiple firings
    within one window collapse — the discretization this module trades for
    jittability).  Base W must be row-stochastic (``rule="conserve"``).

    Sampling is by superposition thinning (``thinned_poisson_indices``):
    O(fired) per window instead of an O(E) per-edge draw, same event-set
    law, still a pure function of ``(seed, round)``.  ``e_max`` optionally
    declares the per-window unique-edge cap (shrinking the engine's static
    window buffers); a window whose realization exceeds it raises rather
    than truncating.  Default: all directed edges (the cap never binds).
    """

    def __init__(
        self,
        W_base: np.ndarray,
        rate: float = 1.0,
        window_len: float = 1.0,
        seed: int = 0,
        e_max: int | None = None,
    ):
        super().__init__(W_base, seed)
        graphs.check_w(self.W_base, require_connected=False)
        if rate <= 0 or window_len <= 0:
            raise ValueError("rate and window_len must be positive")
        self.rate = float(rate)
        self.window_len = float(window_len)
        self._edges = _directed_edges(self.W_base)
        if e_max is not None:
            if not 1 <= int(e_max) <= len(self._edges):
                raise ValueError(
                    f"e_max must be in [1, {len(self._edges)}] (the directed "
                    f"edge count), got {e_max}"
                )
            self.e_max = int(e_max)

    def _events(self, r, rng):
        fired = thinned_poisson_indices(
            rng, len(self._edges), self.rate * self.window_len, e_max=self.e_max
        )
        return [self._edges[int(k)] for k in fired]


class RoundRobinClock(GossipClock):
    """Deterministic cyclic activation: ``edges_per_window`` consecutive
    edges of the base support fire each window, cycling in fixed order.  The
    union over one full cycle is the whole base graph — the minimal
    scheduled-gossip baseline (and a deterministic stand-in for Poisson in
    tests)."""

    def __init__(self, W_base: np.ndarray, edges_per_window: int = 1, seed: int = 0):
        super().__init__(W_base, seed)
        graphs.check_w(self.W_base, require_connected=False)
        if edges_per_window <= 0:
            raise ValueError("edges_per_window must be positive")
        self._edges = _directed_edges(self.W_base)
        self.edges_per_window = int(min(edges_per_window, len(self._edges)))
        self.e_max = self.edges_per_window

    def _events(self, r, rng):
        del rng  # deterministic
        k, m = self.edges_per_window, len(self._edges)
        start = (r * k) % m
        return [self._edges[(start + t) % m] for t in range(k)]


class TraceClock(GossipClock):
    """Explicit per-window edge lists, cycled over rounds — the replay /
    re-expression form (e.g. ``trace_from_schedule`` turns the paper's
    ``time_varying_star_schedule`` into a gossip trace).  ``rule="table"``
    accepts weight-table bases whose rows need not sum to 1; every distinct
    window is validated eagerly at construction."""

    def __init__(
        self,
        W_base: np.ndarray,
        trace: Sequence[Sequence[tuple[int, int]]],
        rule: str = "conserve",
        seed: int = 0,
    ):
        super().__init__(W_base, seed)
        if not trace:
            raise ValueError("TraceClock requires a non-empty trace")
        if rule == "conserve":
            # the conserve rule moves idle in-edge mass onto self, which is
            # only weight-conserving for a row-stochastic base; weight
            # tables (rows may exceed 1) must use rule="table"
            graphs.check_w(self.W_base, require_connected=False)
        self.rule = rule
        self.trace = [[(int(i), int(j)) for i, j in slot] for slot in trace]
        self.e_max = max(max((len(s) for s in self.trace), default=1), 1)
        for k, slot in enumerate(self.trace):  # eager per-window feasibility
            window_from_events(self.W_base, slot, self.e_max, index=k, rule=rule)

    def _events(self, r, rng):
        del rng
        return self.trace[r % len(self.trace)]

    def union_support(self) -> np.ndarray:
        adj = np.eye(self.n_agents)
        for slot in self.trace:
            for i, j in slot:
                adj[i, j] = 1.0
        return adj


class FailureInjectedClock(GossipClock):
    """Wrap any clock and drop each of its fired edges i.i.d. with
    probability ``drop_rate`` — the unreliable-link scenario.  The
    activation UNION is unchanged (every edge still fires infinitely often
    a.s. for drop_rate < 1), so Assumption 1 validation delegates to the
    inner clock."""

    def __init__(self, inner: GossipClock, drop_rate: float, seed: int = 0):
        if not 0.0 <= drop_rate < 1.0:
            raise ValueError("drop_rate must be in [0, 1)")
        _reject_wrapped_delay(inner, "failure_injected")
        super().__init__(inner.W_base, seed)
        self.inner = inner
        self.drop_rate = float(drop_rate)
        self.rule = inner.rule
        self.e_max = inner.e_max

    def _events(self, r, rng):
        del rng  # the shared [seed, r] stream family collides with the
        #          inner clock's when both seeds are equal (the default),
        #          which would make drops a deterministic function of the
        #          firings; salt the drop stream with a distinct word
        events = self.inner._events(r, np.random.default_rng([self.inner.seed, r]))
        drop_rng = np.random.default_rng([self.seed, 0xFA11ED, r])
        keep = drop_rng.random(len(events)) >= self.drop_rate
        return [e for e, k in zip(events, keep) if k]

    def union_support(self) -> np.ndarray:
        return self.inner.union_support()


def _reject_wrapped_delay(inner: GossipClock, outer_kind: str) -> None:
    """Delivery latency must be the OUTERMOST wrapper: every wrapper reaches
    its inner clock through ``_events``, which carries only the delivered
    edges — a ``DelayedClock`` buried inside another wrapper would have its
    lags silently stripped (the engine sees no ``max_delay`` on the outer
    clock and runs the instant path on time-shifted events: neither model).
    Reject the composition loudly instead."""
    if getattr(inner, "max_delay", 0) > 0:
        raise ValueError(
            f"a delayed clock cannot be wrapped inside {outer_kind!r}: the "
            "wrapper would silently drop its delivery lags.  Make 'delayed' "
            "the OUTERMOST wrapper (e.g. delayed(failure_injected(poisson)))"
        )


# salt word for the delivery-latency stream — like FailureInjectedClock's
# 0xFA11ED drop salt, it keeps the delay draws independent of the inner
# clock's firing draws even when both use the same (default) seed
DELAY_SALT = 0xDE1A7


class DelayedClock(GossipClock):
    """Wrap any clock with per-event DELIVERY LATENCY: an edge fired at
    window r is delivered (merged) at window ``r + d``, with d drawn from the
    latency model.  The delivered merge uses the SRC POSTERIOR AS OF FIRE
    TIME — src's post-local-step, pre-merge posterior of window r — which the
    engine reads from a bounded ``[K, N, P]`` history ring buffer
    (K = ``max_delay + 1`` slots).  This is the staleness regime the async
    analyses (BayGo arXiv:2011.04345; Lalitha et al. arXiv:1901.11173)
    bound: consensus mixes k-window-old information.

    latency models (checkpoint-embeddable plain dicts):

    * ``{"kind": "constant", "delay": k}`` — every message takes exactly k
      windows; k=0 reduces BITWISE to the inner clock (and the engine to the
      instant-delivery path).
    * ``{"kind": "geometric", "p": q, "max": k}`` — i.i.d. truncated
      geometric per event (support 0..k): memoryless per-hop retransmission.
    * ``{"kind": "per_edge", "delays": [[...]]}`` — an [N, N] int matrix of
      constant per-directed-edge lags (heterogeneous interconnect: slow WAN
      links next to fast local ones).

    Delay draws come from the salted stream ``[seed, DELAY_SALT, r_fire]``
    so they are deterministic per (seed, fire window) and independent of the
    inner clock's firing draws.  If one edge's firings from several windows
    pile up into the same delivery window, the MOST RECENT firing wins (one
    merge per in-edge per window keeps W-tilde row-feasible).  The
    activation UNION is the inner clock's — every fired edge still delivers
    within ``max_delay`` windows — so Assumption-1 validation delegates.
    Must be the OUTERMOST wrapper (``delayed(failure_injected(...))``, never
    the reverse): wrappers reach their inner clock through ``_events``,
    which strips lags — the inverted composition is rejected eagerly.
    """

    def __init__(self, inner: GossipClock, latency: dict, seed: int = 0):
        _reject_wrapped_delay(inner, "delayed")  # lags do not compose
        super().__init__(inner.W_base, seed)
        self.inner = inner
        self.rule = inner.rule
        if not isinstance(latency, dict) or "kind" not in latency:
            raise ValueError("latency must be a dict with a 'kind' key")
        self.latency = dict(latency)
        kind = self.latency["kind"]
        if kind == "constant":
            self.max_delay = int(self.latency.get("delay", 1))
            if self.max_delay < 0:
                raise ValueError("constant latency delay must be >= 0")
        elif kind == "geometric":
            p = float(self.latency.get("p", 0.5))
            if not 0.0 < p <= 1.0:
                raise ValueError("geometric latency p must be in (0, 1]")
            self.max_delay = int(self.latency.get("max", 4))
            if self.max_delay < 0:
                raise ValueError("geometric latency max must be >= 0")
        elif kind == "per_edge":
            mat = np.asarray(self.latency.get("delays"), np.int64)
            if mat.shape != self.W_base.shape:
                raise ValueError(
                    f"per_edge latency matrix shape {mat.shape} != base W "
                    f"shape {self.W_base.shape}"
                )
            if (mat < 0).any():
                raise ValueError("per_edge latency delays must be >= 0")
            self._delay_matrix = mat
            support = (self.W_base > 0) & ~np.eye(self.n_agents, dtype=bool)
            self.max_delay = int(mat[support].max()) if support.any() else 0
        else:
            raise ValueError(
                f"unknown latency kind {kind!r}; known: "
                "constant | geometric | per_edge"
            )
        # deliveries dedup to one merge per directed edge per window, so the
        # base-graph edge count bounds every window regardless of pile-up
        # (GossipClock.__init__ already set e_max to exactly that)

        # A lag-MIXING latency (geometric, or per_edge with unequal lags
        # WITHIN one row's in-edges) can re-combine individually-feasible
        # fire windows into one delivery window; under rule="table" the
        # combined in-weights could reach >= 1 and crash mid-run AFTER
        # eager validation.  Check the worst case (a row's whole in-edge
        # support delivered together) eagerly, per row.  Constant/uniform
        # latency never mixes lags — deliveries are exactly one
        # (already-validated) inner window — so it needs no check, and
        # rule="conserve" rows are feasible under ANY subset (in-weights
        # sum to 1 - W[i,i] < 1 by row-stochasticity).
        if self.rule == "table":
            off_diag = self.W_base * (1.0 - np.eye(self.n_agents))
            worst = off_diag.sum(axis=1)
            bad = np.nonzero(self._row_mixes_lags() & (worst >= 1.0))[0]
            if bad.size:
                raise ValueError(
                    f"delaying this weight-table trace with a lag-mixing "
                    f"latency ({kind!r}) can co-deliver row "
                    f"{int(bad[0])}'s in-edges (combined weight "
                    f"{worst[bad[0]]:.6f} >= 1); use a constant delay, or "
                    "a table whose rows stay feasible under simultaneous "
                    "delivery"
                )

    def _row_mixes_lags(self) -> np.ndarray:
        """[N] bool: rows whose deliveries within one window can come from
        DIFFERENT fire windows (the re-combination hazard the table-rule
        eager check guards against).  Per row: a row whose own in-edges all
        share one lag only ever receives one shifted fire window, no matter
        what lags the rest of the graph carries."""
        kind = self.latency["kind"]
        n = self.n_agents
        if kind == "geometric":
            return np.full((n,), self.max_delay > 0)
        if kind == "constant":
            return np.zeros((n,), bool)
        support = (self.W_base > 0) & ~np.eye(n, dtype=bool)
        out = np.zeros((n,), bool)
        for i in range(n):
            lags = self._delay_matrix[i, support[i]]
            out[i] = lags.size > 1 and int(lags.min()) != int(lags.max())
        return out

    def _fire_delays(self, r_fire: int, events: list) -> np.ndarray:
        """Per-event delivery lag for the firings of window ``r_fire``."""
        kind = self.latency["kind"]
        if kind == "constant":
            return np.full((len(events),), self.max_delay, np.int64)
        if kind == "per_edge":
            return np.asarray(
                [self._delay_matrix[i, j] for i, j in events], np.int64
            )
        rng = np.random.default_rng([self.seed, DELAY_SALT, r_fire])
        p = float(self.latency.get("p", 0.5))
        return np.minimum(
            rng.geometric(p, size=len(events)) - 1, self.max_delay
        )

    def _events(self, r, rng):
        del rng
        return [e for e, _ in self._deliveries(int(r))]

    def _deliveries(self, r: int) -> list[tuple[tuple[int, int], int]]:
        """[(edge, lag)] delivered at window r, most-recent firing per edge."""
        latest: dict[tuple[int, int], int] = {}
        for r_fire in range(max(0, r - self.max_delay), r + 1):
            fired = self.inner._events(
                r_fire, np.random.default_rng([self.inner.seed, r_fire])
            )
            lags = self._fire_delays(r_fire, fired)
            for e, d in zip(fired, lags):
                if r_fire + int(d) == r:
                    latest[(int(e[0]), int(e[1]))] = r - r_fire
        return [(e, lag) for e, lag in latest.items()]

    def _build_window(self, r: int) -> EventWindow:
        deliveries = self._deliveries(r)
        events, lags = self._filter_crashed(
            r, [e for e, _ in deliveries], [lag for _, lag in deliveries]
        )
        return window_from_events(
            self.W_base, events, self.e_max,
            index=r, rule=self.rule, delays=lags,
        )

    def union_support(self) -> np.ndarray:
        return self.inner.union_support()


# ---------------------------------------------------------------------------
# edge-native clocks (population scale: SparseGraph -> SparseWindow streams)
# ---------------------------------------------------------------------------


class SparseClock:
    """Base class: a deterministic stream of edge-native ``SparseWindow``s.

    The sparse analogue of ``GossipClock``, built over a CSR
    ``SparseGraph`` (arriving pre-validated from the spec layer) instead
    of a dense base W.  Subclasses implement ``_fired(r, rng) -> [K]
    int64`` — indices into the graph's NON-SELF directed edge list, unique
    within a window — and the shared machinery assembles the window in
    O(fired + N) host work: the conserve-rule self-weights come from two
    ``np.bincount`` passes over the fired edges against per-graph
    precomputed off-diagonal row sums, never from a per-row scan (let
    alone an ``np.eye``).  ``rule="conserve"`` only: an all-fired row's
    self-weight is EXACTLY the base diagonal (bitwise), a partial row adds
    its idle in-edge mass onto self, an idle row is exactly ``e_i``
    (self-weight 1.0, active False).

    Determinism contract: identical to ``GossipClock`` — ``window(r)`` is
    a pure function of ``(seed, r)`` via ``default_rng([seed, r])``, with
    the same one-slot memo, fault attachment (vectorized edge-list crash
    filtering, ``gossip.faults.edge_keep_mask``) and Assumption-1
    validation (O(E) iterative strong connectivity on the CSR arrays).
    """

    rule = "conserve"

    def __init__(self, graph: graphs.SparseGraph, seed: int = 0):
        self.graph = graph
        self.n_agents = graph.n_agents
        self.seed = int(seed)
        self.faults = None
        self.max_delay = 0
        dst, src, w32 = graph.edge_arrays()
        ns = dst != src
        # fired-edge tables (non-self, edge_arrays order — CSR row-major)
        self._ns_dst = dst[ns]
        self._ns_src = src[ns]
        self._ns_w32 = w32[ns]
        # f64 twins for exact conserve-rule self-weight arithmetic (the CSR
        # weights array shares edge_arrays' ordering)
        w64 = np.asarray(graph.weights, np.float64)
        self._ns_w64 = w64[ns]
        n = self.n_agents
        diag = np.zeros(n, np.float64)
        diag[dst[~ns]] = w64[~ns]
        self._w_diag = diag
        self._offdiag_sum = np.bincount(
            self._ns_dst, weights=self._ns_w64, minlength=n
        )
        self._deg_offdiag = np.bincount(self._ns_dst, minlength=n)
        #: non-self directed edge count — the fired-index space of _fired
        self.n_edges = int(self._ns_dst.shape[0])
        self.e_max = max(self.n_edges, 1)

    # -- subclass hook -------------------------------------------------------

    def _fired(self, r: int, rng: np.random.Generator) -> np.ndarray:
        """[K] int64 unique indices into the non-self edge list."""
        raise NotImplementedError

    # -- shared machinery ----------------------------------------------------

    def window(self, r: int) -> SparseWindow:
        cached = getattr(self, "_last_window", None)
        if cached is not None and cached[0] == int(r):
            return cached[1]
        win = self._build_window(int(r))
        self._last_window = (int(r), win)
        return win

    def _build_window(self, r: int) -> SparseWindow:
        rng = np.random.default_rng([self.seed, r])
        fired = np.asarray(self._fired(r, rng), np.int64)
        f_dst = self._ns_dst[fired]
        f_src = self._ns_src[fired]
        if self.faults is not None:
            from repro_torch.gossip.faults import edge_keep_mask

            keep = edge_keep_mask(self.faults, r, f_dst, f_src)
            fired, f_dst, f_src = fired[keep], f_dst[keep], f_src[keep]
        n_ev = int(fired.shape[0])
        if n_ev > self.e_max:
            raise ValueError(
                f"window {r} fired {n_ev} edges, above the clock's static "
                f"e_max={self.e_max}"
            )
        n = self.n_agents
        fired_count = np.bincount(f_dst, minlength=n)
        fired_sum = np.bincount(
            f_dst, weights=self._ns_w64[fired], minlength=n
        )
        active = fired_count > 0
        # all-fired rows keep EXACTLY the base diagonal (the bitwise
        # all-edges contract); partial rows add idle in-edge mass onto self
        w_self = np.where(
            fired_count == self._deg_offdiag,
            self._w_diag,
            self._w_diag + (self._offdiag_sum - fired_sum),
        )
        w_self = np.where(active, w_self, 1.0)
        if np.any(w_self[active] <= 0.0):
            bad = int(np.nonzero(active & (w_self <= 0.0))[0][0])
            raise ValueError(
                f"window row {bad}: conserve self-weight "
                f"{w_self[bad]:.6g} <= 0 (base graph is not row-stochastic?)"
            )
        cap = self.e_max
        dst_p = np.zeros(cap, np.int32)
        src_p = np.zeros(cap, np.int32)
        wts_p = np.zeros(cap, np.float32)
        dst_p[:n_ev] = f_dst
        src_p[:n_ev] = f_src
        wts_p[:n_ev] = self._ns_w32[fired]
        return SparseWindow(
            index=r, dst=dst_p, src=src_p, weights=wts_p,
            self_weight=w_self, active=active, n_agents=n, n_events=n_ev,
        )

    def windows(self, n: int) -> list[SparseWindow]:
        return [self.window(r) for r in range(n)]

    # -- agent churn (gossip.faults) -----------------------------------------

    def attach_faults(self, model) -> None:
        """Attach a ``FaultModel``: fired edges touching a crashed agent are
        filtered (vectorized, on the edge list) before the self-weight
        build, so the conserve rule moves their mass onto self exactly as
        the dense clocks do."""
        self.faults = model
        self._last_window = None

    def crashed(self, r: int) -> np.ndarray:
        if self.faults is None:
            return np.zeros((self.n_agents,), bool)
        return self.faults.crashed(r)

    def validate(self) -> None:
        """Assumption 1 on the activation union — the base graph's own
        support, checked in O(E) on the CSR arrays (never a dense union
        matrix)."""
        if not self.graph.strongly_connected():
            raise ValueError(
                "sparse gossip base graph must be strongly connected "
                "(Assumption 1 on the activation union)"
            )


class SparsePoissonClock(SparseClock):
    """Independent Poisson clock per non-self directed edge over a
    ``SparseGraph`` — ``PoissonClock`` without the dense base.  Sampling is
    the same superposition thinning (``thinned_poisson_indices``): O(fired)
    per window, a pure function of ``(seed, round)``.  ``e_max`` optionally
    declares the per-window unique-edge cap, shrinking the engine's static
    ``[E_max]`` buffers; an overflowing realization raises rather than
    truncating."""

    def __init__(
        self,
        graph: graphs.SparseGraph,
        rate: float = 1.0,
        window_len: float = 1.0,
        seed: int = 0,
        e_max: int | None = None,
    ):
        super().__init__(graph, seed)
        if rate <= 0 or window_len <= 0:
            raise ValueError("rate and window_len must be positive")
        self.rate = float(rate)
        self.window_len = float(window_len)
        if e_max is not None:
            if not 1 <= int(e_max) <= self.n_edges:
                raise ValueError(
                    f"e_max must be in [1, {self.n_edges}] (the non-self "
                    f"directed edge count), got {e_max}"
                )
            self.e_max = int(e_max)

    def _fired(self, r, rng):
        return thinned_poisson_indices(
            rng, self.n_edges, self.rate * self.window_len, e_max=self.e_max
        )


class SparseAllEdgesClock(SparseClock):
    """Every non-self edge fires every window — the sparse ladder anchor:
    each window's self-weights equal the base diagonal bitwise, so the
    segment-sum window reproduces the synchronous segment consensus over
    ``SparseGraph.edge_arrays()`` exactly (same edge set, same weights)."""

    def __init__(self, graph: graphs.SparseGraph, seed: int = 0):
        super().__init__(graph, seed)
        self._all = np.arange(self.n_edges, dtype=np.int64)

    def _fired(self, r, rng):
        del rng  # deterministic
        return self._all


class SparseFailureInjectedClock(SparseClock):
    """Drop each of the inner sparse clock's fired edges i.i.d. with
    probability ``drop_rate`` — ``FailureInjectedClock`` on edge lists.
    The drop stream is salted with the same ``0xFA11ED`` word so drops
    stay independent of the inner clock's firing draws."""

    def __init__(self, inner: SparseClock, drop_rate: float, seed: int = 0):
        if not 0.0 <= drop_rate < 1.0:
            raise ValueError("drop_rate must be in [0, 1)")
        super().__init__(inner.graph, seed)
        self.inner = inner
        self.drop_rate = float(drop_rate)
        self.e_max = inner.e_max

    def _fired(self, r, rng):
        del rng  # salted stream, as in FailureInjectedClock
        fired = np.asarray(
            self.inner._fired(r, np.random.default_rng([self.inner.seed, r])),
            np.int64,
        )
        drop_rng = np.random.default_rng([self.seed, 0xFA11ED, r])
        return fired[drop_rng.random(fired.shape[0]) >= self.drop_rate]


def build_sparse_clock(
    doc: dict, graph: graphs.SparseGraph, _inner: bool = False
) -> SparseClock:
    """Build an edge-native clock from a plain dict (the
    ``TopologySpec.clock`` form on ``kind="sparse"`` topologies).  Same
    conventions as ``build_clock``: keys beyond the per-kind parameters
    (``local_policy``) are ignored here, and a top-level ``"faults"`` key
    attaches agent churn — rejected on inner docs for the same
    silently-ignored reason.

    kinds:
      ``poisson``           rate, window_len, seed, e_max (optional cap)
      ``all_edges``         every non-self edge every window (ladder anchor)
      ``failure_injected``  inner=<sparse clock doc>, drop_rate, seed
    """
    if not isinstance(doc, dict) or "kind" not in doc:
        raise ValueError("clock must be a dict with a 'kind' key")
    if "faults" in doc and _inner:
        raise ValueError(
            "'faults' must sit on the OUTERMOST clock doc: an inner clock's "
            "fault model would be silently ignored"
        )
    kind = doc["kind"]
    if kind == "poisson":
        clock: SparseClock = SparsePoissonClock(
            graph,
            rate=doc.get("rate", 1.0),
            window_len=doc.get("window_len", 1.0),
            seed=doc.get("seed", 0),
            e_max=doc.get("e_max"),
        )
    elif kind == "all_edges":
        clock = SparseAllEdgesClock(graph, seed=doc.get("seed", 0))
    elif kind == "failure_injected":
        if "inner" not in doc:
            raise ValueError("clock kind='failure_injected' requires 'inner'")
        clock = SparseFailureInjectedClock(
            build_sparse_clock(doc["inner"], graph, _inner=True),
            drop_rate=doc.get("drop_rate", 0.1),
            seed=doc.get("seed", 0),
        )
    else:
        raise ValueError(
            f"unknown sparse clock kind {kind!r}; known: "
            "poisson | all_edges | failure_injected"
        )
    if doc.get("faults") is not None:
        from repro_torch.gossip import faults as _faults

        clock.attach_faults(
            _faults.build_faults(doc["faults"], clock.n_agents)
        )
    return clock


# ---------------------------------------------------------------------------
# trace builders
# ---------------------------------------------------------------------------


def all_edges_trace(W_base: np.ndarray) -> TraceClock:
    """The degenerate trace where EVERY base edge fires EVERY window — each
    window's w_eff equals the base W bitwise (``rule="conserve"``), so the
    gossip runtime reproduces the synchronous fused consensus bit-identically
    (the equivalence property the tests pin)."""
    return TraceClock(W_base, [_directed_edges(W_base)], rule="conserve")


def trace_from_schedule(mats: Sequence[np.ndarray]) -> tuple[np.ndarray, list]:
    """Re-express a W schedule (e.g. ``graphs.time_varying_star_schedule``)
    as (weight table, per-window edge list) for a ``TraceClock(rule="table")``.

    Requires each directed edge to carry the SAME weight in every slot where
    it is active (true for the paper's time-varying star); the table's row
    sums may exceed 1 — only the per-window fired subsets must be feasible.
    """
    mats = [np.asarray(m, np.float64) for m in mats]
    n = mats[0].shape[0]
    table = np.zeros((n, n))
    np.fill_diagonal(table, 1.0)  # placeholder; diag comes from the rule
    trace = []
    for W in mats:
        slot = []
        for i in range(n):
            for j in np.nonzero(W[i])[0]:
                j = int(j)
                if i == j:
                    continue
                if table[i, j] != 0.0 and not np.isclose(table[i, j], W[i, j]):
                    raise ValueError(
                        f"edge ({i}, {j}) has inconsistent weights across "
                        f"slots: {table[i, j]} vs {W[i, j]}"
                    )
                table[i, j] = W[i, j]
                slot.append((i, j))
        trace.append(slot)
    return table, trace


# ---------------------------------------------------------------------------
# spec-dict registry (checkpoint-embeddable clock descriptions)
# ---------------------------------------------------------------------------


def build_clock(doc: dict, W_base: np.ndarray, _inner: bool = False) -> GossipClock:
    """Build a clock from a plain dict (the ``TopologySpec.clock`` form that
    rides in session checkpoints).  Keys beyond the per-kind parameters
    (e.g. ``local_policy``, consumed by the engine) are ignored here.

    A TOP-LEVEL ``"faults"`` key (a ``gossip.faults.FaultSpec`` doc) attaches
    agent churn to the built clock: crashed agents fire no out-edges and
    receive nothing (their in-edge mass moves to self via the w_eff rule).
    ``"faults"`` on an INNER clock doc is rejected — wrappers reach inner
    clocks through ``_events``, which carries no fault filtering, so a
    nested fault model would be silently ignored.

    kinds:
      ``poisson``           rate, window_len, seed, e_max (optional declared
                            per-window unique-edge cap; default all edges)
      ``round_robin``       edges_per_window, seed
      ``trace``             trace=[[[dst, src], ...], ...], rule, seed
      ``failure_injected``  inner=<clock doc>, drop_rate, seed
      ``delayed``           inner=<clock doc>, latency=<latency doc>, seed
                            (latency: constant | geometric | per_edge —
                            see ``DelayedClock``)
    """
    if not isinstance(doc, dict) or "kind" not in doc:
        raise ValueError("clock must be a dict with a 'kind' key")
    if "faults" in doc and _inner:
        raise ValueError(
            "'faults' must sit on the OUTERMOST clock doc: an inner clock's "
            "fault model would be silently ignored (wrappers reach inner "
            "clocks through _events, which carries no fault filtering)"
        )
    kind = doc["kind"]
    clock = None
    if kind == "poisson":
        clock = PoissonClock(
            W_base,
            rate=doc.get("rate", 1.0),
            window_len=doc.get("window_len", 1.0),
            seed=doc.get("seed", 0),
            e_max=doc.get("e_max"),
        )
    elif kind == "round_robin":
        clock = RoundRobinClock(
            W_base,
            edges_per_window=doc.get("edges_per_window", 1),
            seed=doc.get("seed", 0),
        )
    elif kind == "trace":
        if "trace" not in doc:
            raise ValueError("clock kind='trace' requires a 'trace' list")
        clock = TraceClock(
            W_base,
            trace=[[(e[0], e[1]) for e in slot] for slot in doc["trace"]],
            rule=doc.get("rule", "conserve"),
            seed=doc.get("seed", 0),
        )
    elif kind == "failure_injected":
        if "inner" not in doc:
            raise ValueError("clock kind='failure_injected' requires 'inner'")
        clock = FailureInjectedClock(
            build_clock(doc["inner"], W_base, _inner=True),
            drop_rate=doc.get("drop_rate", 0.1),
            seed=doc.get("seed", 0),
        )
    elif kind == "delayed":
        if "inner" not in doc:
            raise ValueError("clock kind='delayed' requires 'inner'")
        clock = DelayedClock(
            build_clock(doc["inner"], W_base, _inner=True),
            latency=doc.get("latency", {"kind": "constant", "delay": 1}),
            seed=doc.get("seed", 0),
        )
    else:
        raise ValueError(
            f"unknown clock kind {kind!r}; known: "
            "poisson | round_robin | trace | failure_injected | delayed"
        )
    if doc.get("faults") is not None:
        from repro_torch.gossip import faults as _faults

        clock.attach_faults(
            _faults.build_faults(doc["faults"], clock.n_agents)
        )
    return clock
