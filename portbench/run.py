"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration,
traffic mix, driver, limits and per-layer metric readers are files of
their own under ``portbench/`` (see ``portbench/common.py``).  A run
builds the program's state from the seed and runs the cell's check rounds
(the set-up, which is also the warm-up), then runs whole rounds back to
back until ``--seconds`` have passed (the window).  With ``--trace 1`` the
first rounds of the window (one warm-up round of the profiler, then the
traffic's ``profile_rounds``) run under ``torch.profiler``
(``portbench/profile.py``) and the program's spans are on; the per-layer
metrics are read from them.  Once the window
has closed the program's state is freed and the plain reference follows
the check rounds from the same seed; ``correct`` says whether every
compared number is within its limit.

The last line of standard output is one JSON object; the numbers compared
are also the last lines of standard error.  It measures the PyTorch port
(``repro_torch``) only, and exits non-zero without a result where there is
no CUDA card, too few cards, or JAX or the JAX package is loaded.
"""
from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
# caches of the card's runtime inside the checkout, at a fixed path
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "portbench" / "cuda_cache"))

import numpy as np  # noqa: E402

from portbench import common, hw  # noqa: E402
from portbench.profile import TraceData, profiled  # noqa: E402


class Ctx:
    """What a driver is handed: the cell's files, the seed, the device, and
    whether the run is traced."""

    def __init__(self, cell: str, seed: int, trace: bool, device, overrides=None):
        files = common.cell_files(cell)
        overrides = overrides or {}
        self.cell, self.seed, self.trace, self.device = cell, seed, trace, device
        self.entry = files["entry"]
        self.workload = {**files["workload"], **overrides.get("workload", {})}
        self.config = {**files["config"], **overrides.get("config", {})}
        self.traffic = {**files["traffic"], **overrides.get("traffic", {})}
        self.reference = common.load_module(files["reference_path"], self.entry["config"])
        self.driver_module = common.load_module(files["driver_path"], self.traffic["driver"])


def end_to_end(cell: str, rounds: list, t0: float, setup_s: float) -> dict:
    """The cell's end-to-end metrics over the window: a rate is all the
    work kept over the time from the window's start to the end of its last
    round; a tail is over every round."""
    span = rounds[-1]["t1"] - t0
    work = sum(r["work"] for r in rounds)
    walls = [(r["t1"] - r["t0"]) * 1e3 for r in rounds]
    values = {"setup_s": setup_s, "round_ms_p95": float(np.percentile(walls, 95)),
              "mlp_samples_per_s": work / span, "lm_tokens_per_s": work / span}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in common.cell_metrics(cell, "end_to_end")}


def per_layer(cell: str, data: TraceData) -> dict:
    """Each per-layer metric of the cell from its own reader; a reader that
    finds nothing to read returns None, and the metric is left out."""
    out = {}
    for m in common.cell_metrics(cell, "per_layer"):
        reader = common.load_module(common.find("metrics", m["name"], ".py"), m["name"])
        value = reader.read(data)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device=None,
             overrides=None) -> dict:
    """One run of ``cell``; returns the result object.  ``device`` None is
    the first CUDA card (the benchmark's runs); tests pass the CPU and
    ``overrides`` of the configuration and traffic at a tiny size."""
    import torch

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    ctx = Ctx(cell, seed, trace, dev, overrides)
    driver = ctx.driver_module.Driver(ctx)
    driver.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        # the peak of the window, not of the check rounds' injected draws
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    setup_s = t0 - _T_START
    rounds, deadline = [], t0 + seconds

    def timed_round():
        ts = time.perf_counter()
        rec = driver.round()
        rec.update(t0=ts, t1=time.perf_counter())
        rounds.append(rec)

    if trace:  # the window's first rounds, profiled after one warm-up round
        n_prof = ctx.traffic["profile_rounds"]
        with profiled(dev, host=False, rounds=n_prof) as dev_prof:
            for _ in range(1 + n_prof):
                timed_round()
                dev_prof.step()
        traced = rounds[1:]
        with profiled(dev, host=True) as host_prof, host_prof.round():
            timed_round()
    n_profiled = len(rounds)
    while not rounds or rounds[-1]["t1"] < deadline:
        timed_round()
    window_closed = common.forbidden_loaded(sys.modules)
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    result = {"correct": False, "attempted": len(rounds),
              "failed": sum(bool(r["failed"]) for r in rounds), "metrics": {},
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        data = TraceData(dev_prof, host_prof, traced, driver)
        result["metrics"] = per_layer(cell, data)
        result["device"].update(busy_s=data.busy_s, window_s=data.window_s)
        result["breakdown"] = data.breakdown()
    else:
        result["metrics"] = end_to_end(cell, rounds, t0, setup_s)
    result["device"]["card"] = hw.power_limit() if dev.type == "cuda" else "cpu"
    driver.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = driver.compare(driver.readings, driver.reference_readings())
    # the rounds that ran with no profiler on
    walls = [(r["t1"] - r["t0"]) * 1e3 for r in rounds[n_profiled:]]
    result["timing"] = {"setup_s": setup_s, **getattr(driver, "times", {}),
                        "window_s": rounds[-1]["t1"] - t0,
                        "reference_s": time.perf_counter() - t_ref,
                        "round_ms_quartiles": ([float(q) for q in np.percentile(walls, [25, 50, 75])]
                                               if walls else None)}
    ok, checks = common.judge(numbers, ctx.workload["limits"])
    result["correct"] = ok and result["failed"] == 0
    result["forbidden"] = window_closed + [m for m in common.forbidden_loaded(sys.modules)
                                           if m not in window_closed]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def err(msg):
        print(msg, file=sys.stderr, flush=True)

    if not (ROOT / "src" / "repro_torch").is_dir():
        err(f"the program (src/repro_torch) is not in this checkout: {ROOT}")
        return 2
    entry = next((w for w in common.benchmark_doc()["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        err(f"BENCHMARK.json has no workload {args.workload!r}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        err(f"needs {entry['chips']} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    err(f"timing {json.dumps(result.pop('timing'))}")
    forbidden = result.pop("forbidden")
    if forbidden:
        err(f"JAX or the JAX package was loaded in the measured process: {forbidden}")
        return 4
    line, check_lines = result_line(result)
    for c in check_lines:
        err(c)
    print(line, flush=True)
    return 0


def result_line(result: dict) -> tuple[str, list[str]]:
    """The result object as one JSON line, the numbers compared under the
    last key, and the same numbers as lines for standard error."""
    body = {k: v for k, v in result.items() if k != "checks"}
    body["checks"] = result["checks"]
    lines = [f"check {name} {c['value']!r} limit {c['limit']!r}"
             for name, c in result["checks"].items()]
    return json.dumps(body), lines


if __name__ == "__main__":
    sys.exit(main())
