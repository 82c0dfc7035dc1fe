"""Nested spans on the host's clock, each with the card's time of the work
inside it, and compile-vs-warm attribution (port of ``repro.obs.trace``).

* ``Tracer`` — nested ``span(name, **attrs)`` context managers recording
  intervals into an in-process buffer.  Spans carry arbitrary attributes;
  the ``compile=True`` attribute marks a span as compile-attributed, and
  ``summary()`` splits every aggregate into ``compile`` / ``warm`` groups
  so steady-state numbers are never polluted.  A DISABLED tracer's
  ``span`` is a reusable no-op context manager — the instrumented hot path
  pays one attribute check and an empty ``with``.
* The current bundle: ``Session.round`` makes its ``Observability``
  current for the call (``made_current``, which a caller of the launch
  steps may use the same way); the numeric code the engines share (the
  local step's forward, backward and optimizer, the synchronous round's
  two halves) opens its spans with ``maybe_span(current_obs(), name)``.
  With nothing current such a span costs one ``None`` check and allocates
  nothing.

The card runs asynchronously: a CUDA call returns when its kernels are
queued, not done.  A live span never synchronises.  It reads
``time.perf_counter()`` on entry and exit (``t0_s`` and ``dur_us``: the
host's time to issue the work inside it), and on a CUDA tracer
(``Tracer(device=<cuda device>)``) it also records a timing
``torch.cuda.Event`` on the device's current stream at each end.
``Tracer.resolve()`` waits for the card once, fills each pending span's
``device_us`` (the stream's time from the first event to the second: the
work queued inside the span, and any stretch in which the stream waited
for the host) and releases the events.  ``summary()`` and ``flush()``
call it; the rounds never do.  On the CPU the work ran inside the span, so
``device_us`` is its host duration.

While ``torch.profiler`` records, a live span also opens a
``record_function`` range of its name, so the program's phases sit in the
profiler's host timeline, on the clock of the device operations.

What the port pays once (the kernel library's build or load, cuBLAS
handles, the allocator's first growth) falls in the first call it makes;
there is no JIT, so that is what the compile bucket holds here.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time

import torch
from torch.autograd import profiler as _profiler


@dataclasses.dataclass
class Span:
    """One recorded interval: ``t0_us`` since the tracer epoch, ``t0_s`` on
    ``time.perf_counter()``'s clock, ``dur_us`` on the host; ``device_us``
    the card's time of the work inside it, once resolved (``None`` before)."""

    name: str
    t0_us: float
    dur_us: float
    depth: int
    attrs: dict
    t0_s: float = 0.0
    device_us: float | None = None

    def to_event(self) -> dict:
        ev = {"kind": "span", "name": self.name, "t0_us": round(self.t0_us, 3),
              "dur_us": round(self.dur_us, 3), "depth": self.depth,
              "device_us": None if self.device_us is None else round(self.device_us, 3)}
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

    __slots__ = ("tracer", "name", "attrs", "t0", "events", "range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tr = self.tracer
        tr._depth += 1
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.events = None
        self.t0 = time.perf_counter()
        if tr._cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(tr.device))
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(tr.device))
        t1 = time.perf_counter()
        tr._depth -= 1
        span = Span(name=self.name, t0_us=(self.t0 - tr._epoch) * 1e6,
                    dur_us=(t1 - self.t0) * 1e6, depth=tr._depth, attrs=self.attrs,
                    t0_s=self.t0)
        if self.events is None:
            span.device_us = span.dur_us
        else:
            tr._pending.append((span, *self.events))
            self.events = None
        tr.spans.append(span)
        if self.range is not None:
            self.range.__exit__(*exc)
            self.range = None
        return False


class Tracer:
    """In-process span recorder; free when disabled.  ``device``: where the
    spans' work runs; a CUDA device gives each span a pair of timing events
    on that device's current stream, resolved by ``resolve()``."""

    def __init__(self, enabled: bool = True, sink=None, device=None):
        self.enabled = enabled
        self.device = None if device is None else torch.device(device)
        self._cuda = self.device is not None and self.device.type == "cuda"
        self.spans: list[Span] = []
        self.sink = sink  # optional metrics.JsonlSink; spans land as events
        self._pending: list[tuple] = []  # (span, start event, end event)
        self._depth = 0
        self._flushed = 0
        self._epoch = time.perf_counter()

    def span(self, name: str, **attrs):
        """``with tracer.span("gossip.window", impl="masked"): ...`` —
        records nothing (and allocates nothing) when the tracer is off."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, attrs)

    def resolve(self) -> None:
        """Fill ``device_us`` of every span whose events are pending: one
        synchronise of the tracer's device, then each pair's elapsed time;
        the events are released.  A second call has nothing to do."""
        if not self._pending:
            return
        torch.cuda.synchronize(self.device)
        for span, start, end in self._pending:
            span.device_us = start.elapsed_time(end) * 1e3
        self._pending.clear()

    # -- aggregation ---------------------------------------------------------

    def summary(self) -> dict:
        """Per span name: count / total / mean / p50 / max (us) on the host,
        and ``device_total_us`` / ``device_p50_us`` where every span of the
        group has its device time, split into ``warm`` and ``compile``
        groups by the ``compile`` attribute.  Resolves pending spans."""
        self.resolve()
        grouped: dict[str, dict[str, list[Span]]] = {}
        for s in self.spans:
            mode = "compile" if s.attrs.get("compile") else "warm"
            grouped.setdefault(s.name, {}).setdefault(mode, []).append(s)
        out: dict[str, dict] = {}
        for name, modes in sorted(grouped.items()):
            out[name] = {}
            for mode, spans in modes.items():
                durs = sorted(s.dur_us for s in spans)
                n = len(durs)
                out[name][mode] = {
                    "n": n,
                    "total_us": sum(durs),
                    "mean_us": sum(durs) / n,
                    "p50_us": durs[n // 2],
                    "max_us": durs[-1],
                }
                dev = sorted(s.device_us for s in spans if s.device_us is not None)
                if len(dev) == n:
                    out[name][mode].update(device_total_us=sum(dev), device_p50_us=dev[n // 2])
        return out

    def flush(self) -> int:
        """Push buffered spans, resolved, to the JSONL sink (if any);
        returns the number of spans written this call."""
        if self.sink is None:
            return 0
        self.resolve()
        n = 0
        for s in self.spans[self._flushed:]:
            self.sink.emit(s.to_event())
            n += 1
        self._flushed = len(self.spans)
        return n


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_current_obs",
                                                          default=None)


def current_obs():
    """The ``Observability`` bundle made current up the call stack
    (``made_current``), else ``None``."""
    return _CURRENT.get()


@contextlib.contextmanager
def made_current(obs):
    """``obs`` is ``current_obs()`` inside the block, and whatever was
    current before it is again after (the blocks nest)."""
    token = _CURRENT.set(obs)
    try:
        yield obs
    finally:
        _CURRENT.reset(token)


def maybe_span(obs, name: str, **attrs):
    """A span of ``obs``'s tracer when an ``Observability`` bundle is given,
    else the shared no-op context: an uninstrumented caller pays one
    ``is None`` check."""
    return obs.tracer.span(name, **attrs) if obs is not None else _NULL_SPAN
