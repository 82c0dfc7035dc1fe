"""Unified metrics registry: counters, gauges, and histograms with labels
(a copy of ``repro.obs.metrics``: standard library only).

One registry per ``Session`` (``obs.Observability.registry``) is the single
source of truth for every number observability reports: the round loop and
the engines write into it through namespaced instruments
(``session.rounds``, ``gossip.windows``, ``serve.requests``, ...), the
``evaluate()`` telemetry blocks are ingested under their namespace
(``ingest``), and every consumer — the terminal dashboard, the
Prometheus-style text exporter, the JSONL event sink — READS the registry
instead of re-deriving its own copy.

Design constraints, in order:

* **Pure observer.**  Instruments only ever receive already-materialized
  Python numbers (a producer converts a tensor to a host scalar before it
  records it), so recording can never force a device sync or touch
  training state.
* **Deterministic export.**  ``to_prometheus()`` sorts metrics and label
  sets, so identical runs produce byte-identical exporter output, and the
  same calls give the same bytes as the JAX package's registry
  (``_fmt``, ``sanitize_name`` and ``escape_label_value`` are verbatim).
* **Plain data out.**  ``collect()`` returns nested plain dicts (the same
  vocabulary ``Session.evaluate()`` speaks), and the JSONL sink writes one
  self-describing event object per line.
"""
from __future__ import annotations

import dataclasses
import io
import json
import math
import threading
from typing import Any, Iterable


def _label_key(labels: dict) -> tuple:
    """Canonical hashable form of a label set (sorted items)."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def sanitize_name(name: str) -> str:
    """Lower a dotted metric name to the Prometheus charset
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``): dots and dashes become underscores."""
    out = name.replace(".", "_").replace("-", "_")
    if out and out[0].isdigit():
        out = "_" + out
    return out


def escape_label_value(value: str) -> str:
    """Escape a label VALUE per the Prometheus text exposition format:
    backslash, double-quote and newline must be escaped inside the quoted
    value (``\\`` -> ``\\\\``, ``"`` -> ``\\"``, LF -> ``\\n``) — an
    ingested telemetry string containing any of them would otherwise emit
    unparseable exposition text.  Names go through ``sanitize_name``;
    values are free-form and only need this quoting."""
    return (str(value)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


# Default histogram buckets: wall-clock microseconds from 1us to ~1e7us
# (10s), decade-spaced with a 1-2-5 ladder — wide enough for both a
# disabled-span probe (~ns) and a cold jit compile (~s).
DEFAULT_BUCKETS = tuple(
    float(m * 10**e) for e in range(0, 7) for m in (1, 2, 5)
) + (float("inf"),)


@dataclasses.dataclass
class _Series:
    """One (metric, label-set) time series."""

    value: float = 0.0
    # histogram-only fields
    count: int = 0
    total: float = 0.0
    minimum: float = math.inf
    maximum: float = -math.inf
    bucket_counts: list | None = None


class _Instrument:
    """Shared machinery behind Counter / Gauge / Histogram handles."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str = ""):
        self.registry = registry
        self.name = name
        self.help = help
        self.series: dict[tuple, _Series] = {}

    def _series(self, labels: dict) -> _Series:
        key = _label_key(labels)
        s = self.series.get(key)
        if s is None:
            s = self.series[key] = _Series()
        return s

    def labelsets(self) -> Iterable[tuple]:
        return sorted(self.series)


class Counter(_Instrument):
    """Monotone accumulator (``inc``)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        self._series(labels).value += value
        self.registry._emit("counter", self.name, labels, value)

    def value(self, **labels) -> float:
        s = self.series.get(_label_key(labels))
        return 0.0 if s is None else s.value


class Gauge(_Instrument):
    """Last-write-wins instantaneous value (``set``)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series(labels).value = float(value)
        self.registry._emit("gauge", self.name, labels, value)

    def value(self, **labels) -> float:
        s = self.series.get(_label_key(labels))
        return 0.0 if s is None else s.value


class Histogram(_Instrument):
    """Distribution sketch: count/sum/min/max + fixed cumulative buckets."""

    kind = "histogram"

    def __init__(self, registry, name, help="", buckets=DEFAULT_BUCKETS):
        super().__init__(registry, name, help)
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(set(bs)):
            raise ValueError(f"histogram {name!r} buckets must be ascending")
        if not bs or bs[-1] != math.inf:
            bs = bs + (math.inf,)
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        s = self._series(labels)
        if s.bucket_counts is None:
            s.bucket_counts = [0] * len(self.buckets)
        s.count += 1
        s.total += v
        s.minimum = min(s.minimum, v)
        s.maximum = max(s.maximum, v)
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                s.bucket_counts[i] += 1
                break
        self.registry._emit("histogram", self.name, labels, v)

    def summary(self, **labels) -> dict:
        s = self.series.get(_label_key(labels))
        if s is None or s.count == 0:
            return {"count": 0}
        return {
            "count": s.count,
            "sum": s.total,
            "mean": s.total / s.count,
            "min": s.minimum,
            "max": s.maximum,
        }


class JsonlSink:
    """Append-only JSONL event sink: one object per metric write / span.

    Events are self-describing (``{"kind", "name", "labels", "value"}``
    for metrics, ``{"kind": "span", ...}`` for tracer spans) so the file
    needs no side schema.  Buffered in-process; ``flush()``/``close()``
    push to disk (the registry flushes on ``export`` and the session on
    ``dashboard()``)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "w")
        self._lock = threading.Lock()
        self.n_events = 0

    def emit(self, event: dict) -> None:
        line = json.dumps(event, sort_keys=True)
        with self._lock:
            self._fh.write(line + "\n")
            self.n_events += 1

    def flush(self) -> None:
        with self._lock:
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()


class MetricsRegistry:
    """Namespace of instruments; the one place observability numbers live.

    ``counter``/``gauge``/``histogram`` create-or-return an instrument by
    dotted name (idempotent, kind-checked); ``ingest`` flattens a nested
    telemetry dict into gauges under a namespace prefix; ``collect`` returns
    the whole registry as plain nested dicts; ``to_prometheus`` renders the
    deterministic text exposition format.
    """

    def __init__(self, sink: JsonlSink | None = None):
        self._instruments: dict[str, _Instrument] = {}
        self._info: dict[str, str] = {}
        self.sink = sink

    # -- instrument construction (idempotent) --------------------------------

    def _get(self, cls, name: str, help: str, **kw) -> _Instrument:
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(self, name, help, **kw)
        elif not isinstance(inst, cls):
            raise ValueError(
                f"metric {name!r} already registered as {inst.kind}"
            )
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def info(self, name: str, value: str) -> None:
        """Non-numeric annotation (wire dtype, policy names) exported as a
        ``name{value="..."} 1`` info-style series."""
        self._info[name] = str(value)
        self._emit("info", name, {}, value)

    # -- bulk ingest ---------------------------------------------------------

    def ingest(self, namespace: str, doc: Any) -> None:
        """Flatten a nested telemetry dict (the ``evaluate()`` vocabulary)
        into gauges/infos under ``namespace.``: numeric leaves become gauge
        values, strings/bools become info/0-1 gauges, lists become indexed
        leaves.  This is how the existing staleness / faults / serving
        blocks land in the registry without each producer learning the
        instrument API."""
        def walk(prefix: str, node: Any) -> None:
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(f"{prefix}.{k}", v)
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(f"{prefix}.{i}", v)
            elif isinstance(node, bool):
                self.gauge(prefix).set(1.0 if node else 0.0)
            elif isinstance(node, (int, float)):
                self.gauge(prefix).set(float(node))
            elif node is None:
                pass
            else:
                self.info(prefix, str(node))

        walk(namespace, doc)

    # -- event plumbing ------------------------------------------------------

    def _emit(self, kind: str, name: str, labels: dict, value) -> None:
        if self.sink is not None:
            self.sink.emit(
                {"kind": kind, "name": name,
                 "labels": {str(k): str(v) for k, v in labels.items()},
                 "value": value if isinstance(value, (int, float, str)) else float(value)}
            )

    # -- export --------------------------------------------------------------

    def collect(self) -> dict:
        """The registry as plain nested data: ``{name: value}`` for
        counters/gauges (label sets keyed by their sorted repr),
        ``{name: summary_dict}`` for histograms."""
        out: dict[str, Any] = {}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            per_labels = {}
            for key in inst.labelsets():
                label_repr = ",".join(f"{k}={v}" for k, v in key) or ""
                if inst.kind == "histogram":
                    s = inst.series[key]
                    per_labels[label_repr] = {
                        "count": s.count, "sum": s.total,
                        "mean": (s.total / s.count) if s.count else 0.0,
                        "min": s.minimum if s.count else 0.0,
                        "max": s.maximum if s.count else 0.0,
                    }
                else:
                    per_labels[label_repr] = inst.series[key].value
            out[name] = per_labels.get("") if list(per_labels) == [""] else per_labels
        for name in sorted(self._info):
            out[name] = self._info[name]
        return out

    def to_prometheus(self) -> str:
        """Deterministic Prometheus text exposition (sorted names, sorted
        label sets; counters get the ``_total`` suffix, histograms the
        ``_bucket``/``_sum``/``_count`` triple)."""
        buf = io.StringIO()
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            pname = sanitize_name(name)
            if inst.help:
                buf.write(f"# HELP {pname} {inst.help}\n")
            buf.write(f"# TYPE {pname} {inst.kind}\n")
            for key in inst.labelsets():
                s = inst.series[key]
                lbl = ",".join(
                    f'{sanitize_name(k)}="{escape_label_value(v)}"'
                    for k, v in key
                )

                def wrap(extra: str = "") -> str:
                    parts = ",".join(x for x in (lbl, extra) if x)
                    return "{" + parts + "}" if parts else ""

                if inst.kind == "counter":
                    buf.write(f"{pname}_total{wrap()} {_fmt(s.value)}\n")
                elif inst.kind == "gauge":
                    buf.write(f"{pname}{wrap()} {_fmt(s.value)}\n")
                else:  # histogram
                    cum = 0
                    for edge, n in zip(inst.buckets, s.bucket_counts or []):
                        cum += n
                        le = "+Inf" if edge == math.inf else _fmt(edge)
                        le_lbl = 'le="' + le + '"'
                        buf.write(f"{pname}_bucket{wrap(le_lbl)} {cum}\n")
                    buf.write(f"{pname}_sum{wrap()} {_fmt(s.total)}\n")
                    buf.write(f"{pname}_count{wrap()} {s.count}\n")
        for name in sorted(self._info):
            pname = sanitize_name(name)
            buf.write(f"# TYPE {pname}_info gauge\n")
            buf.write(
                f'{pname}_info{{value='
                f'"{escape_label_value(self._info[name])}"}} 1\n'
            )
        if self.sink is not None:
            self.sink.flush()
        return buf.getvalue()


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers bare, floats via repr."""
    f = float(v)
    if f == math.inf:
        return "+Inf"
    if f == -math.inf:
        return "-Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)
