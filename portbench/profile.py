"""Reading the device trace of a traced run.

The first rounds of a traced window run under ``torch.profiler`` with the
card's activity alone.  The first of them is the profiler's own warm-up
(its start-up cost falls there, and its events are not kept); the
traffic's ``profile_rounds`` after it are the traced window: their span
on the host's clock (each round ends synchronised, so all its device work
lies inside), busy time the union of the device operations' intervals
(kernels, copies, sets), idle the rest.  One more round runs with the host's ops recorded
too, inside a ``portbench.round`` range, to name what the host was doing
in each stretch where the card idled; the host profiler's own cost makes
that round slower, so it is not part of the idle share.
"""
from __future__ import annotations

import contextlib

import numpy as np

from portbench import hw

ROUND_RANGE = "portbench.round"


class profiled:
    """``torch.profiler`` over the rounds run inside it: the card's activity
    alone (``host=False``; the profiler then adds little to the host's
    time), or with the host's ops (``host=True``, to name what the host was
    doing in each idle stretch).  With ``rounds``, the first round (ended
    by ``step()``) is the profiler's warm-up and the next ``rounds`` are
    recorded."""

    def __init__(self, device, host: bool, rounds: int | None = None):
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU] if host or device.type != "cuda" else []
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        plan = None if rounds is None else schedule(wait=0, warmup=1, active=rounds, repeat=1)
        self.prof = profile(activities=acts, schedule=plan)

    def step(self):
        self.prof.step()

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    @contextlib.contextmanager
    def round(self):
        import torch

        with torch.profiler.record_function(ROUND_RANGE):
            yield


def _merge(intervals):
    """Union of [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _device_ops(events, t0=None, t1=None):
    from torch.autograd import DeviceType

    # kernels, copies and sets; the GPU side of a host range (a user
    # annotation such as the round's own) is not one
    return [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.name != ROUND_RANGE
            and (t0 is None or (e.time_range.end > t0 and e.time_range.start < t1))]


class TraceData:
    """What the per-layer metric readers read.  ``dev_prof``: the card's
    activity over ``rounds``, the traced window (its length on the host's
    clock: the rounds run back to back and each ends synchronised, so every
    operation in the profile lies inside it); ``host_prof``: one more round
    with the host's ops, for the idle stretches' names.  Also the driver's
    per-round work and timings, and the program's spans."""

    def __init__(self, dev_prof, host_prof, rounds: list, driver):
        """``rounds``: the traced window's rounds, each with its host times
        ``t0``, ``t1`` and its work (``flops``, ``bytes``)."""
        from torch.autograd import DeviceType

        self.device_ops = _device_ops(dev_prof.prof.events())
        self.busy = _merge((s, e) for s, e, _ in self.device_ops)
        self.window_s = rounds[-1]["t1"] - rounds[0]["t0"]
        self.busy_s = sum(e - s for s, e in self.busy) * 1e-6
        events = host_prof.prof.events()
        marks = [e for e in events if e.name == ROUND_RANGE and e.device_type == DeviceType.CPU]
        self.h0 = min(e.time_range.start for e in marks)
        self.h1 = max(e.time_range.end for e in marks)
        self.host_ops = [(e.time_range.start, e.time_range.end, e.name) for e in events
                         if e.device_type == DeviceType.CPU and e.name != ROUND_RANGE]
        self.host_busy = _merge((max(s, self.h0), min(e, self.h1))
                                for s, e, _ in _device_ops(events, self.h0, self.h1))
        self.n_rounds = len(rounds)
        self.rounds = rounds
        self.stats = driver.trace_stats(rounds) if hasattr(driver, "trace_stats") else {}
        self.spans = driver.obs_spans() if hasattr(driver, "obs_spans") else []
        self.peak_flops = hw.PEAK_FLOPS[driver.cfg["compute_dtype"]]
        self.hbm = hw.HBM_BYTES_PER_S

    def idle_share(self):
        """Per cent of the traced window with no operation on the card;
        nothing where no device operation was traced."""
        if not self.device_ops or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def round_mfu(self):
        """The traced rounds' least time over the traced window, per cent:
        the larger of their FLOPs at the peak of the configuration's
        compute type and their bytes at the HBM peak."""
        if not self.device_ops or self.window_s <= 0:
            return None
        flops = sum(r["flops"] for r in self.rounds)
        nbytes = sum(r["bytes"] for r in self.rounds)
        return 100.0 * max(flops / self.peak_flops, nbytes / self.hbm) / self.window_s

    def kernel_seconds(self, names) -> float:
        """Device seconds of the operations whose name holds any of
        ``names``, summed (each kernel's own time)."""
        return sum(e - s for s, e, n in self.device_ops if any(k in n for k in names)) * 1e-6

    def ops_by_time(self, top: int = 10) -> list:
        total: dict = {}
        for s, e, n in self.device_ops:
            total[n] = total.get(n, 0.0) + (e - s) * 1e-6
        return sorted(([n[:120], t] for n, t in total.items()), key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches of the labelled round with no device
        operation, each named by the innermost host range running at its
        middle."""
        edges = [self.h0] + [x for iv in self.host_busy for x in iv] + [self.h1]
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        if not self.host_ops:
            return [["host", g * 1e-6] for g, _ in gaps[:top]]
        starts = np.array([s for s, _, _ in self.host_ops])
        ends = np.array([e for _, e, _ in self.host_ops])
        out = []
        for length, at in gaps[:top]:
            at += length / 2
            covering = np.flatnonzero((starts <= at) & (ends > at))
            name = (self.host_ops[covering[np.argmax(starts[covering])]][2] if covering.size
                    else "host")
            out.append([name[:120], length * 1e-6])
        return out

    def breakdown(self) -> dict:
        return {"device_ops": self.ops_by_time(), "idle_gaps": self.idle_gaps()}
