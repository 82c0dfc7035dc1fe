"""``repro_torch.obs`` — the pure-observer observability layer (port of
``repro.obs``).

Three pillars, one contract:

* ``obs.metrics`` — the unified ``MetricsRegistry`` (counters / gauges /
  histograms with labels, JSONL event sink, Prometheus-style exporter);
* ``obs.trace`` — nested spans with compile-vs-warm attribution: each
  reads the host's clock, and on the card records a timing event pair that
  ``Tracer.resolve()`` turns into the device time of the work inside it; a
  span never synchronises, and while ``torch.profiler`` records it is a
  ``record_function`` range of its name;
* ``obs.convergence`` + ``obs.roofline`` — theory-vs-measured: live
  network disagreement / KL against ``core.theory``'s predicted decay,
  measured window time against the ``launch.costmodel`` rooflines (at the
  H100's constants).

The contract: observability is READ-ONLY and OFF by default.  With
``ObsSpec`` unset a run is the uninstrumented run; with it enabled the
posterior, the optimizer state and the checkpoint leaves are still
bitwise those of the run without it — the instruments observe host values
the session computes anyway, and the only device work they add is the
spans' timing events and the convergence reduction, neither of which
writes training state.  ``tests/test_torch_obs.py`` pins both directions.

Front door: ``ExperimentSpec(obs=ObsSpec(enabled=True))`` →
``session.obs`` (an ``Observability``) → ``session.dashboard()``.
"""
from __future__ import annotations

from repro_torch.obs.convergence import ConvergenceTracker, network_stats
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    JsonlSink,
    MetricsRegistry,
)
from repro_torch.obs.roofline import (
    attainment,
    consensus_attainment,
    window_attainment,
)
from repro_torch.obs.trace import Tracer

__all__ = [
    "ConvergenceTracker",
    "network_stats",
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MetricsRegistry",
    "attainment",
    "consensus_attainment",
    "window_attainment",
    "Tracer",
    "Observability",
]


class Observability:
    """One session's observability bundle: registry + tracer (+ optional
    convergence tracker), wired to a shared JSONL sink.

    Built by ``api.session.build_session`` when ``spec.obs.enabled``; the
    session and the engines talk to THIS object (never to the spec), and
    everything on it is a pure observer of already-computed values.
    ``device`` is where the spans' work runs (``None``: the host's clock
    alone); on a CUDA device each span also records the card's time.
    """

    def __init__(self, obs_spec, static_w=None, device=None):
        self.spec = obs_spec
        self.sink = (
            JsonlSink(obs_spec.jsonl_path) if obs_spec.jsonl_path else None
        )
        self.registry = MetricsRegistry(sink=self.sink)
        self.tracer = Tracer(enabled=obs_spec.trace, sink=self.sink, device=device)
        self.convergence = (
            ConvergenceTracker(W=static_w) if obs_spec.convergence else None
        )

    @classmethod
    def from_spec(cls, spec, device=None) -> "Observability | None":
        """``None`` unless ``spec.obs.enabled``.  For the convergence
        tracker's theory overlay, a STATIC topology (named topology /
        explicit / single-matrix schedule) contributes its W; scheduled,
        callable, and gossip topologies track measured decay only (their
        per-round W varies, so the spectral rate is not a constant).  The
        tracer times the spans' work on ``device``."""
        if not spec.obs.enabled:
            return None
        static_w = None
        if spec.obs.convergence:
            try:
                mats = spec.topology._static_list()
            except ValueError:
                mats = None
            if mats is not None and len(mats) == 1:
                static_w = mats[0]
        return cls(spec.obs, static_w=static_w, device=device)

    def flush(self) -> None:
        """Push buffered spans/events to the JSONL sink, if one is set."""
        self.tracer.flush()
        if self.sink is not None:
            self.sink.flush()
