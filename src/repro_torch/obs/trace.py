"""Nested wall-clock spans with explicit compile-vs-warm attribution (port
of ``repro.obs.trace``).

The benches all reinvented the same timing discipline by hand: run the
first call separately (it pays the one-time costs), THEN start the timer,
and report ``compile_us`` next to the warm median, because a mean over
calls that includes the first is off by orders of magnitude.  This module
promotes that discipline into a reusable API:

* ``Tracer`` — nested ``span(name, **attrs)`` context managers recording
  wall-clock intervals into an in-process buffer.  Spans carry arbitrary
  attributes; the ``compile=True`` attribute marks a span as
  compile-attributed, and ``summary()`` splits every aggregate into
  ``compile`` / ``warm`` groups so steady-state numbers are never polluted.
  A DISABLED tracer's ``span`` is a reusable no-op context manager — the
  instrumented hot path pays one attribute check and an empty ``with``.
* ``CompileWarmTimer`` — the two-phase bench pattern as an object: time
  the first call under ``with t.compile():``, the steady-state run under
  ``with t.warm():``.
* ``median_us(fn, *args)`` — median-of-warm-calls microbenchmark helper.

The card runs asynchronously: a CUDA call returns when its kernels are
queued, not done.  So a live span calls the tracer's ``sync`` (the
``Observability`` of a CUDA session passes ``torch.cuda.synchronize`` for
its device) before it reads the clock, on enter and on exit: the span then
times the device work inside it, not its launches.  ``median_us`` and
``compile_warm_split`` synchronise on a CUDA result (``_block``) for the
same reason.  A synchronise changes no result.

What the port pays once (the kernel library's build or load, cuBLAS
handles, the allocator's first growth) falls in the first call it makes;
there is no JIT, so that is what the compile bucket holds here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Callable

import torch


@dataclasses.dataclass
class Span:
    """One recorded interval (microseconds since the tracer epoch)."""

    name: str
    t0_us: float
    dur_us: float
    depth: int
    attrs: dict

    def to_event(self) -> dict:
        ev = {"kind": "span", "name": self.name, "t0_us": round(self.t0_us, 3),
              "dur_us": round(self.dur_us, 3), "depth": self.depth}
        if self.attrs:
            ev["attrs"] = {k: _plain(v) for k, v in self.attrs.items()}
        return ev


def _plain(v):
    return v if isinstance(v, (bool, int, float, str, type(None))) else str(v)


class _NullSpan:
    """Reusable no-op context manager (the disabled-tracer fast path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """An open span: closes itself into the tracer buffer on ``__exit__``."""

    __slots__ = ("tracer", "name", "attrs", "t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tr = self.tracer
        tr._depth += 1
        if tr.sync is not None:
            tr.sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        if tr.sync is not None:
            tr.sync()
        t1 = time.perf_counter()
        tr._depth -= 1
        tr.spans.append(Span(
            name=self.name,
            t0_us=(self.t0 - tr._epoch) * 1e6,
            dur_us=(t1 - self.t0) * 1e6,
            depth=tr._depth,
            attrs=self.attrs,
        ))
        return False


class Tracer:
    """In-process span recorder; free when disabled.  ``sync`` (optional,
    no arguments) runs before each clock read of a live span: pass
    ``torch.cuda.synchronize`` bound to the device whose work the spans
    should time."""

    def __init__(self, enabled: bool = True, sink=None, sync: Callable[[], Any] | None = None):
        self.enabled = enabled
        self.sync = sync
        self.spans: list[Span] = []
        self.sink = sink  # optional metrics.JsonlSink; spans land as events
        self._depth = 0
        self._flushed = 0
        self._epoch = time.perf_counter()

    def span(self, name: str, **attrs):
        """``with tracer.span("gossip.window", impl="masked"): ...`` —
        records nothing (and allocates nothing) when the tracer is off."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, attrs)

    # -- aggregation ---------------------------------------------------------

    def summary(self) -> dict:
        """Per span name: count / total / mean / p50 / max (us), split into
        ``warm`` and ``compile`` groups by the ``compile`` attribute."""
        grouped: dict[str, dict[str, list[float]]] = {}
        for s in self.spans:
            mode = "compile" if s.attrs.get("compile") else "warm"
            grouped.setdefault(s.name, {}).setdefault(mode, []).append(s.dur_us)
        out: dict[str, dict] = {}
        for name, modes in sorted(grouped.items()):
            out[name] = {}
            for mode, durs in modes.items():
                durs = sorted(durs)
                n = len(durs)
                out[name][mode] = {
                    "n": n,
                    "total_us": sum(durs),
                    "mean_us": sum(durs) / n,
                    "p50_us": durs[n // 2],
                    "max_us": durs[-1],
                }
        return out

    def flush(self) -> int:
        """Push buffered spans to the JSONL sink (if any); returns the
        number of spans written this call."""
        if self.sink is None:
            return 0
        n = 0
        for s in self.spans[self._flushed:]:
            self.sink.emit(s.to_event())
            n += 1
        self._flushed = len(self.spans)
        return n

    def to_jsonl(self, path: str) -> int:
        """Write every recorded span to ``path`` (one JSON object per
        line); returns the span count."""
        with open(path, "w") as fh:
            for s in self.spans:
                fh.write(json.dumps(s.to_event(), sort_keys=True) + "\n")
        return len(self.spans)


def maybe_span(obs, name: str, **attrs):
    """A span of ``obs``'s tracer when an ``Observability`` bundle is given,
    else the shared no-op context: an uninstrumented caller pays one
    ``is None`` check."""
    return obs.tracer.span(name, **attrs) if obs is not None else _NULL_SPAN


class CompileWarmTimer:
    """The bench_gossip ad-hoc split as a reusable object.

        t = CompileWarmTimer()
        with t.compile():
            session.round()          # pays the one-time costs
        with t.warm():
            session.run(n_rounds=m)  # steady state
        t.compile_us, t.warm_us, t.warm_us_per(m)

    Multiple ``compile()``/``warm()`` blocks accumulate (first calls under
    distinct shapes all belong to the compile bucket).  The blocks read the
    host clock only: end each with a synchronise when it launches CUDA
    work."""

    def __init__(self):
        self.compile_us = 0.0
        self.warm_us = 0.0

    @contextlib.contextmanager
    def compile(self):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.compile_us += (time.perf_counter() - t0) * 1e6

    @contextlib.contextmanager
    def warm(self):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.warm_us += (time.perf_counter() - t0) * 1e6

    def warm_us_per(self, n_calls: int) -> float:
        return self.warm_us / max(1, n_calls)

    def as_dict(self) -> dict:
        return {"compile_us": self.compile_us, "warm_us": self.warm_us}


def _block(x) -> None:
    """Wait for the device work behind ``x``: synchronise every CUDA device
    that a tensor in ``x`` (a tensor, or a list, tuple or dict of them)
    lives on.  Anything else returns at once."""
    devices = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, (list, tuple)):
            for item in v:
                walk(item)
        elif isinstance(v, dict):
            for item in v.values():
                walk(item)

    walk(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


def median_us(fn: Callable[..., Any], *args, iters: int = 5) -> float:
    """Median warm wall-clock of ``fn(*args)`` in microseconds.  The caller
    is responsible for warming ``fn`` first (or use ``compile_warm_split``);
    a CUDA result is synchronised on, so device time is counted."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append((time.perf_counter() - t0) * 1e6)
    return sorted(times)[len(times) // 2]


def compile_warm_split(
    fn: Callable[..., Any], *args, iters: int = 5
) -> dict:
    """Time ``fn(*args)``'s first call (compile) apart from its warm
    median: ``{"compile_us", "warm_us_median"}``."""
    t0 = time.perf_counter()
    _block(fn(*args))
    compile_us = (time.perf_counter() - t0) * 1e6
    return {
        "compile_us": compile_us,
        "warm_us_median": median_us(fn, *args, iters=iters),
    }
