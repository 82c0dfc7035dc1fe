"""``repro_torch.gossip`` — the event-driven asynchronous gossip runtime.

* ``clocks`` — per-edge activation clocks (``poisson | round_robin | trace |
  failure_injected | delayed`` and the edge-native sparse clocks), copied
  from the JAX package: each emits fixed-size **event windows** (a padded
  ``[E_max, 2]`` edge list, a per-agent activity mask and the effective
  row-stochastic W-tilde), bitwise the JAX package's for the same doc.
* ``faults`` — deterministic agent churn and payload corruption (copied).
* ``engine`` — ``GossipEngine``, the Engine-protocol runtime that executes
  one event window per ``run_round``: local VI steps, then the window's
  consensus, masked (the CUDA kernel ``consensus_fused_masked`` on the
  card), delayed from a ``[K, N, P]`` history ring, or edge-native over a
  ``SparseWindow``'s fired edges (both on ``consensus_fused_segments``);
  the strict/quarantine fault policies and per-agent staleness telemetry.

A gossip experiment is declared like any other: ``TopologySpec.gossip(...)``
inside an ``ExperimentSpec``, then ``build_session(spec)``.
"""
from repro_torch.gossip.clocks import (
    EventWindow,
    FailureInjectedClock,
    GossipClock,
    PoissonClock,
    RoundRobinClock,
    TraceClock,
    all_edges_trace,
    build_clock,
    trace_from_schedule,
    window_from_events,
)
from repro_torch.gossip.engine import GossipEngine, GossipState, gossip_state_from_numpy

__all__ = [
    "EventWindow",
    "FailureInjectedClock",
    "GossipClock",
    "GossipEngine",
    "GossipState",
    "PoissonClock",
    "RoundRobinClock",
    "TraceClock",
    "all_edges_trace",
    "build_clock",
    "gossip_state_from_numpy",
    "trace_from_schedule",
    "window_from_events",
]
