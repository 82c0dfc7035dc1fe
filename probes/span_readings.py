#!/usr/bin/env python3
"""The program's spans in the benchmark's cells, on the card: what each
span reads, what tracing costs a round, and what the profiler makes of
the spans.

    python3 probes/span_readings.py [--cells a,b] [--seed N] [--pairs K]
    python3 probes/span_readings.py --tiny --pairs 2   # the CPU, at portbench's tiny sizes

Each cell of ``BENCHMARK.json`` named (all three by default) is built by
the benchmark's own driver (``portbench/drivers``) from the seed, with its
check rounds, as ``--trace 1`` builds it: the MLP sessions with
``ObsSpec(enabled=True)``, the LM's steps with the driver's CUDA events.
The LM driver's local and eq. (6) steps are wrapped (``Switch``): when on,
each call runs with an ``Observability`` on the card current
(``made_current``) inside a span of this probe's own, ``probe.local_step``
or ``probe.consensus``.  After one more round, ``--pairs`` pairs of rounds
run back to back, in turns with the program's observability on and off
(on-off, then off-on; an MLP session's bundle detached for the off
rounds), each round's host time read around it; the on rounds' spans are
resolved after the last round.  Per on round:

* the local step's ``local.forward`` / ``local.backward`` /
  ``local.optimizer`` device ms and (``.host``) host ms, summed (MLP: over
  the round's blocks and steps; LM: per step, over its blocks),
  ``probe.local_step``'s host ms a step (LM), and the merge's device and
  host ms (``gossip.consensus``, ``round.consensus`` or
  ``probe.consensus``);
* beside them the LM driver's own CUDA events around each local step and
  each eq. (6) call of the same rounds.

Then one warm-up and one recorded round with observability on under the
benchmark's card-only profiler (``portbench.profile.profiled``): the
device operations it keeps (``_device_ops``) that carry a span's name
(there should be none), the span names it saw as user annotations on the
card, and the eq. (6) kernels' profiled ms beside that round's merge span.

Last, for the LM, whether the host or the card sets the local step's pace
(``pacing``): one warm-up and one recorded round, observability off, under
the profiler with the host's ops, each local step in a ``probe.step``
range that ends synchronised (the driver reads the step's loss right after
it anyway) and its call in a ``probe.issue`` range.  Per step: the host's
ms to issue it, the card's busy ms inside the range (the union of its
device operations), the launch calls (``cudaLaunchKernel`` and the like,
copies and sets) and their ms past the round's median call, which is the
host's time blocked on a full launch queue.  A card-paced step reads busy
near the range's length and a large blocked time; a host-paced one reads
the card idle in stretches and no blocked time.  The host profiler slows
the host, so a host-paced reading is an upper bound of the host's part.

Everything lands in ``chiprun_out/span_readings.json``; one line a cell
is printed.  The card's name and power limit are in both.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import hw  # noqa: E402
from portbench.profile import _device_ops, _merge, profiled  # noqa: E402
from portbench.run import Ctx  # noqa: E402
from repro_torch.obs.trace import made_current  # noqa: E402

CELLS = ("mlp_gossip_ws4200", "mlp_sync_grid1024", "lm_repro100m_train_u4")
LOCAL = ("local.forward", "local.backward", "local.optimizer")
MERGES = ("gossip.consensus", "round.consensus", "probe.consensus")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync")
EQ6_KERNELS = ("consensus_small_kernel", "consensus_generic_kernel",
               "consensus_segments_kernel", "consensus_segments_tile_kernel")


class Switch:
    """A step of the LM driver's; when on, each call runs with ``obs``
    current in a span ``name`` of its tracer."""

    def __init__(self, step, obs, name: str):
        self.step, self.obs, self.name, self.on = step, obs, name, False

    def __call__(self, *args, **kwargs):
        if not self.on:
            return self.step(*args, **kwargs)
        with made_current(self.obs), self.obs.tracer.span(self.name):
            return self.step(*args, **kwargs)


def lm_switches(obs):
    """Patch ``launch.steps``' step factories so that the LM driver's set-up
    builds each step as a ``Switch``; returns the switches made."""
    from repro_torch.launch import steps

    made = []

    def factory(orig, name):
        def build(*args, **kwargs):
            sw = Switch(orig(*args, **kwargs), obs, name)
            made.append(sw)
            return sw

        return build

    steps.make_local_step = factory(steps.make_local_step, "probe.local_step")
    steps.make_consensus_step = factory(steps.make_consensus_step, "probe.consensus")
    return made


def pacing(driver, dev) -> list:
    """Per LM local step of one recorded round under the profiler with the
    host's ops (observability off): the host's ms in the step and to issue
    it, the card's busy ms inside it, and the launch calls' count, ms and
    ms past the round's median call (module docstring)."""
    from torch.autograd import DeviceType

    step = driver.local_step

    def paced(*args, **kwargs):
        with torch.profiler.record_function("probe.step"):
            with torch.profiler.record_function("probe.issue"):
                out = step(*args, **kwargs)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return out

    driver.local_step = paced
    with profiled(dev, host=True, rounds=1) as prof:
        for _ in range(2):
            driver.round()
            prof.step()
    driver.local_step = step
    events = prof.prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = {name: sorted((e.time_range.start, e.time_range.end) for e in host if e.name == name)
              for name in ("probe.step", "probe.issue")}
    calls = [(e.time_range.start, e.time_range.end) for e in host if e.name in LAUNCH_CALLS]
    med = statistics.median(b - a for a, b in calls) if calls else 0.0
    busy = _merge((s, e) for s, e, _ in _device_ops(events))
    out = []
    for (t0, t1), (i0, i1) in zip(ranges["probe.step"], ranges["probe.issue"]):
        inside = [(a, b) for a, b in calls if t0 <= a < t1]
        out.append({
            "step_ms": (t1 - t0) / 1e3, "issue_ms": (i1 - i0) / 1e3,
            "busy_ms": sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in busy) / 1e3,
            "launches": len(inside), "launch_ms": sum(b - a for a, b in inside) / 1e3,
            "blocked_ms": sum(max(0.0, b - a - med) for a, b in inside) / 1e3,
            "median_launch_us": med})
    return out


def set_obs(driver, obs, on: bool):
    if hasattr(driver, "session"):
        driver.session._obs = obs if on else None
        driver.session.engine.obs = obs if on else None
    for sw in driver.switches:
        sw.on = on


def q(xs):
    """Median and quartiles, as ``statistics.quantiles`` gives them."""
    if len(xs) < 2:
        return {"median": xs[0] if xs else None}
    lo, mid, hi = statistics.quantiles(xs, n=4)
    return {"median": mid, "q1": lo, "q3": hi, "n": len(xs)}


def one_cell(cell: str, seed: int, pairs: int, dev, overrides=None) -> dict:
    from repro_torch.api import ObsSpec
    from repro_torch.obs import Observability

    ctx = Ctx(cell, seed, True, dev, overrides)
    lm = ctx.traffic["driver"] == "lm_train_rounds"
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)
    obs = Observability(ObsSpec(enabled=True, convergence=False), device=dev) if lm else None
    switches = lm_switches(obs) if lm else []
    driver = ctx.driver_module.Driver(ctx)
    driver.switches = switches
    t0 = time.perf_counter()
    driver.setup()
    setup_s = time.perf_counter() - t0
    if not lm:
        obs = driver.session.obs
    tracer = obs.tracer
    set_obs(driver, obs, False)
    driver.round()  # the window's first round: the program's own draws
    walls = {"on": [], "off": []}
    on_rounds = []  # (span range, driver event counts before and after)
    for i in range(pairs):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            set_obs(driver, obs, on)
            mark = len(tracer.spans)
            ev0 = {k: len(v) for k, v in driver.events.items()} if lm else None
            sync(dev)
            ts = time.perf_counter()
            driver.round()
            sync(dev)
            walls["on" if on else "off"].append((time.perf_counter() - ts) * 1e3)
            if on:
                ev1 = {k: len(v) for k, v in driver.events.items()} if lm else None
                on_rounds.append((mark, len(tracer.spans), ev0, ev1))
    tracer.resolve()
    events = driver.trace_stats([]) if lm else {}
    per_round = []
    for a, b, ev0, ev1 in on_rounds:
        spans = tracer.spans[a:b]
        dev_ms = {n: sum(s.device_us for s in spans if s.name == n) / 1e3
                  for n in LOCAL + MERGES}
        rec = {k: dev_ms[k] for k in LOCAL}
        rec.update({f"{n}.host": sum(s.dur_us for s in spans if s.name == n) / 1e3
                    for n in LOCAL})
        rec["merge_ms"] = sum(dev_ms[k] for k in MERGES)
        rec["merge_host_ms"] = sum(s.dur_us for s in spans if s.name in MERGES) / 1e3
        rec["span_names"] = sorted({s.name for s in spans})
        rec["n_spans"] = len(spans)
        if lm:
            steps = [s for s in spans if s.name == "probe.local_step"]
            u = len(steps)
            rec.update({k: v / u for k, v in rec.items() if k.startswith(LOCAL)})
            rec["local_step_host_ms"] = sum(s.dur_us for s in steps) / u / 1e3
            rec["local_step_span_ms"] = sum(s.device_us for s in steps) / u / 1e3
            rec["local_step_event_ms"] = (sum(events["local_step_ms"][ev0["local_step_ms"]:
                                                                   ev1["local_step_ms"]]) / u)
            rec["consensus_event_ms"] = sum(events["consensus_ms"][ev0["consensus_ms"]:
                                                                ev1["consensus_ms"]])
        per_round.append(rec)
    # one round under the benchmark's card-only profiler, spans on
    set_obs(driver, obs, True)
    with profiled(dev, host=False, rounds=1) as prof:
        for _ in range(2):
            mark = len(tracer.spans)
            driver.round()
            prof.step()
    sync(dev)
    tracer.resolve()
    names = {s.name for s in tracer.spans}
    raw = prof.prof.events()
    kept = _device_ops(raw)
    profiled_merge = sum(s.device_us for s in tracer.spans[mark:] if s.name in MERGES) / 1e3
    eq6_ms = sum(e - s for s, e, n in kept if any(k in n for k in EQ6_KERNELS)) / 1e3
    out = {
        "cell": cell, "seed": seed, "setup_s": setup_s, "pairs": pairs,
        "round_ms": {k: q(v) for k, v in walls.items()},
        "cost_share": (statistics.median(walls["on"]) / statistics.median(walls["off"]) - 1),
        "per_round": per_round,
        "readings": {k: q([r[k] for r in per_round]) for k in per_round[0]
                     if isinstance(per_round[0][k], float)},
        "profiled": {
            "device_ops_named_as_spans": sorted({n for _, _, n in kept if n in names}),
            "span_annotations_on_the_card": sorted(
                {e.name for e in raw if e.name in names
                 and e.device_type == torch.autograd.DeviceType.CUDA}),
            "merge_span_ms": profiled_merge, "eq6_kernels_ms": eq6_ms,
        },
    }
    if lm:
        set_obs(driver, obs, False)
        out["pacing"] = pacing(driver, dev)
    driver.release()
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--seed", type=int, default=2147480001)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.tiny else "cuda", 0 if not args.tiny else None)
    card = "cpu" if args.tiny else hw.power_limit()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    results = {"card": card, "torch": torch.__version__, "cells": []}
    for i, cell in enumerate(args.cells.split(",")):
        overrides = None
        if args.tiny:
            from portbench.tests import tiny

            overrides = tiny.CELLS[cell]
        res = one_cell(cell, args.seed + i, args.pairs, dev, overrides)
        results["cells"].append(res)
        print(json.dumps({k: res[k] for k in ("cell", "round_ms", "cost_share", "readings",
                                               "profiled", "pacing") if k in res}), flush=True)
    path = ROOT / "chiprun_out" / ("span_readings_tiny.json" if args.tiny else "span_readings.json")
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
