"""The readings a cell's limits are set from, on the card at the cell's own
size (not part of a benchmark run):

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 \\
        [--program] [--control] [--faults unchanged,half_batch,no_exchange] \\
        [--more-seeds 14,15,16]

For each seed, in one process: ``--program`` runs the program's set-up
(the check rounds a benchmark run makes) and compares it with the
reference, the lower reading of each number; ``--control`` puts the
reference computed in the precision below the configuration's in the
program's place (TF32 for the float32 MLP, float8 products for the
bfloat16 LM); each fault puts the reference with that fault planted in
the program's place.  Every comparison prints one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np

from portbench.common import still_leaves
from portbench.run import Ctx


def detail(got: dict, ref: dict) -> dict:
    """Each leaf's gap (against its own or the median norm), and the
    quantiles of the per-agent loss gaps of each round, for the look at
    what a number's worst case is made of."""
    out = {"left_out": still_leaves(ref["moment_norms"])}
    for key, r in ref.items():
        g = got.get(key)
        if isinstance(r, dict):
            med = float(np.median(list(r.values())))
            out[key] = {k: abs(g[k] - v) / max(v, med, 1e-30) for k, v in r.items()}
        elif key == "losses":
            r, g = np.atleast_2d(np.asarray(r, float)), np.atleast_2d(np.asarray(g, float))
            rows = []
            for gr, rr in zip(g, r):
                ok = ~np.isnan(rr) & ~np.isnan(gr)
                rel = np.abs(gr[ok] - rr[ok]) / np.maximum(np.abs(rr[ok]), 1e-30)
                rows.append([float(np.quantile(rel, q)) for q in (0.5, 0.9, 0.99, 1.0)])
            out[key] = rows
    return out


def readings(cell: str, seeds, program: bool, control: bool, faults, device=None,
             overrides=None, emit=print):
    import torch

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    out = []
    for seed in seeds:
        ctx = Ctx(cell, seed, False, dev, overrides)
        driver = ctx.driver_module.Driver(ctx)
        t0 = time.perf_counter()
        prog = None
        if program:
            driver.setup()
            prog = driver.readings
            driver.release()
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        ref = driver.reference_readings()
        sides = [("program", prog)] if program else []
        if control:
            sides.append(("control", driver.reference_readings(control=True)))
        for f in faults:
            sides.append((f, driver.reference_readings(faults=(f,))))
        for name, got in sides:
            line = {"cell": cell, "seed": seed, "side": name,
                    "numbers": driver.compare(got, ref), "s": time.perf_counter() - t0,
                    "detail": detail(got, ref)}
            out.append(line)
            emit(json.dumps(line), flush=True)
        del driver
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--more-seeds", default="", help="seeds for the program's reading alone")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    readings(args.workload, seeds, args.program, args.control, faults)
    more = [int(s) for s in args.more_seeds.split(",") if s]
    if more:
        readings(args.workload, more, True, False, [])
    return 0


if __name__ == "__main__":
    sys.exit(main())
