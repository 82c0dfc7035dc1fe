#!/usr/bin/env python3
"""Timing study of ``consensus_fused`` (``csrc/consensus_row.cu``) on one
NVIDIA GPU, at the ops path's shape (N = 9, P = 199,210, f32 wire):

    python3 probes/consensus_row.py

It times, by ``chip_smoke.cuda_ms`` (warm, cold after a dirty flush, cold
after a clean flush; see ``chip_smoke.Flush``) and beside the launch floor:

* ``shipped``: ``kernels.consensus.consensus_fused`` (the planned instance);
* ``generic``: the same call forced onto the first port's kernel;
* the kernels of ``probes/consensus_row.cu``: ``pairs`` (2 lanes a thread,
  8-byte loads), ``async`` (an 8-byte ``cp.async`` ring in shared memory),
  ``arithmetic_only`` and ``loads_only`` (the shipped layout with one of the
  two parts taken out), ``stream`` (a lane a thread over a grid of 3
  blocks an SM, the next tile's rows loaded during this tile's
  arithmetic).

Each line says whether the variant gives the generic kernel's bits (the two
``_only`` variants compute something else) and the registers ptxas gave it.
Two rounds, in turns.  Exits 2 without a GPU.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PROBES = {0: "pairs", 1: "async", 2: "arithmetic_only", 3: "loads_only", 4: "stream"}
KERNEL_NAMES = {0: "12pairs_kernel", 1: "12async_kernel", 2: "12lanes_kernelILi1E",
                3: "12lanes_kernelILi2E", 4: "13stream_kernel"}  # as mangled


def build():
    """nvcc the probe kernels into build/probes/; returns the library and
    ptxas's report."""
    from repro_torch.kernels import dispatch

    out = ROOT / "build" / "probes" / "consensus_row_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f.replace("c++17", "c++20") for f in dispatch.NVCC_FLAGS]
    proc = subprocess.run([dispatch._nvcc(), *flags, "-shared", "-o", str(out),
                           str(ROOT / "probes" / "consensus_row.cu")],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_launch.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i64, i32, ptr]
    return lib, proc.stdout + proc.stderr


def registers(report, name):
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            found = re.search(r"Used (\d+) registers", " ".join(lines[i:i + 4]))
            return int(found.group(1)) if found else None
    return None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probes/consensus_row.py needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import consensus as k
    from repro_torch.kernels import dispatch

    dev = torch.device("cuda", 0)
    lib, report = build()
    n, p = 9, cs.P_SLICE
    W, mean, rho = cs.eq6_inputs(n, p, seed=7, device=dev)  # chip_smoke phase 5's inputs
    w = W[0]
    ref = k._row_launch(w, mean, rho, None, instance=0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {"shipped": (lambda: k.consensus_fused(w, mean, rho), None),
             "generic": (lambda: k._row_launch(w, mean, rho, None, instance=0), None)}
    for v, name in PROBES.items():
        threads, lanes = lib.probe_threads(v), lib.probe_lanes(v)
        blocks = -(-p // (threads * lanes))
        wave = lib.probe_blocks_per_sm(v) * sms
        grid = -(-blocks // -(-blocks // wave))  # launch_plan._grid's balanced wave
        if lib.probe_grid_per_sm(v):
            grid = min(lib.probe_grid_per_sm(v) * sms, wave)
        mo, ro = torch.empty(p, device=dev), torch.empty(p, device=dev)

        def call(v=v, mo=mo, ro=ro, grid=grid):
            dispatch.check_cuda(lib.probe_launch(v, w.data_ptr(), mean.data_ptr(),
                                                 rho.data_ptr(), mo.data_ptr(), ro.data_ptr(),
                                                 p, grid, stream), PROBES[v])
            return mo, ro

        calls[name] = (call, {"threads": threads, "lanes": lanes, "grid": grid,
                              "ptxas_registers": registers(report, KERNEL_NAMES[v])})
    flush = cs.Flush(dev)
    floor = cs.cuda_ms(lambda: torch.cuda._sleep(1))
    print(cs.smi_name_power())
    for rnd in range(2):
        for name, (fn, fields) in calls.items():
            got = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            warm, dirty, clean = (cs.cuda_ms(fn), cs.cuda_ms(fn, flush.dirty),
                                  cs.cuda_ms(fn, flush.clean))
            print("probe " + json.dumps({
                "round": rnd, "variant": name, "ms": warm, "cold_l2_ms": dirty,
                "cold_l2_clean_ms": clean, "launch_floor_ms": floor,
                "ms_less_floor": warm - floor, "cold_l2_clean_ms_less_floor": clean - floor,
                "generic_bits": same, **(fields or {})}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
