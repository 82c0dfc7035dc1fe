"""Shared pieces of the benchmark: where its files are, how a cell's files
are found by name, seeds derived from ``--seed``, and the comparison
arithmetic that decides ``correct``.

Nothing here imports the program (``repro_torch``) or JAX.
"""
from __future__ import annotations

import importlib.util
import json
import re
import zlib
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_doc() -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return load_json(ROOT / "BENCHMARK.json")


def find(kind: str, name: str, suffix: str) -> Path:
    """``portbench/<kind>/<name><suffix>``; a missing file raises."""
    path = BENCH_DIR / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def load_module(path: Path, name: str):
    """Import a Python file by its path (names may hold dots and dashes)."""
    mod_name = re.sub(r"\W", "_", f"portbench_{path.parent.name}_{name}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(cell: str) -> dict:
    """Everything a cell is made of, found by name: its ``BENCHMARK.json``
    entry, its workload file (limits), its configuration, its traffic mix
    and the driver the traffic names."""
    doc = benchmark_doc()
    entry = next((w for w in doc["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {cell!r}")
    config = load_json(find("configs", entry["config"], ".json"))
    traffic = load_json(find("traffic", entry["traffic"], ".json"))
    return {
        "entry": entry,
        "workload": load_json(find("workloads", cell, ".json")),
        "config": config,
        "traffic": traffic,
        "driver_path": find("drivers", traffic["driver"], ".py"),
        "reference_path": find("configs", entry["config"], ".reference.py"),
    }


def cell_metrics(cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those without a ``workloads`` key, and those that
    list it."""
    doc = benchmark_doc()
    return [m for m in doc[section] if cell in m.get("workloads", [cell])]


def sub_seed(seed: int, *words) -> int:
    """A 63-bit seed for one named stream of the run, a pure function of
    ``--seed`` and the words (strings or integers)."""
    ints = [int(seed) % (1 << 64)]
    for w in words:
        ints.append(zlib.crc32(w.encode()) if isinstance(w, str) else int(w) % (1 << 64))
    state = np.random.SeedSequence(ints).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


def forbidden_loaded(modules) -> list[str]:
    """Loaded module names whose top-level name (before the first dot) is
    JAX, jaxlib, flax or the JAX package, compared whole: ``repro_torch``
    is not ``repro``."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES})


# -- comparison -------------------------------------------------------------


def norm_gaps(prog: dict, ref: dict, skip=()) -> float:
    """The worst leaf's gap between two sets of per-leaf norms: for each
    leaf, |norm_prog - norm_ref| over the larger of the reference's norm of
    that leaf and the median of the reference's leaf norms.  Leaves in
    ``skip`` are left out; a non-finite norm is an infinite gap."""
    keys = [k for k in ref if k not in skip]
    if set(keys) - set(prog):
        raise KeyError(f"program norms lack leaves {sorted(set(keys) - set(prog))}")
    med = float(np.median([ref[k] for k in keys]))
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]
    return float(max(gaps)) if np.all(np.isfinite(gaps)) else float("inf")


def still_leaves(grad_norms: dict) -> list[str]:
    """Leaves whose reference gradient is nought to rounding: under a
    thousandth of the median leaf's.  Adam moves such a leaf by round-off
    alone, so its change is left out of the comparison."""
    med = float(np.median(list(grad_norms.values())))
    return sorted(k for k, v in grad_norms.items() if v < 1e-3 * med)


def loss_gap(prog, ref, q: float = 1.0) -> float:
    """Relative gap between two arrays of losses, each against the larger
    of the reference's value and the median of the reference's magnitudes:
    the worst (``q`` = 1) or the ``q``-quantile over the entries; NaN on
    one side and not the other is an infinite gap."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape or not np.array_equal(np.isnan(prog), np.isnan(ref)):
        return float("inf")
    ok = ~np.isnan(ref)
    if not ok.any():
        return 0.0
    p, r = prog[ok], ref[ok]
    if not np.isfinite(p).all():
        return float("inf")
    scale = np.maximum(np.abs(r), np.median(np.abs(r)))
    return float(np.quantile(np.abs(p - r) / np.maximum(scale, 1e-30), q))


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; ``correct`` holds when every
    number is at or under its limit (an exact comparison has limit 0)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and np.isfinite(value) and value <= limit
        ok &= bool(good)
        checks[name] = {"value": None if value is None else float(value), "limit": float(limit)}
    return ok, checks
