#!/usr/bin/env python3
"""Timing study of the generic dense eq. (6) path (N > 16,
``csrc/consensus_network.cu``: ``consensus_generic_kernel_nonzeros`` lists
W's nonzeros on the card, ``consensus_generic_kernel`` walks them over each
source's terms computed once a tile) on one NVIDIA GPU, beside the generic
kernel it replaced:

    python3 probes/consensus_generic.py

The earlier kernel (input rows staged in chunks of 16 and re-read for each
chunk of 16 output rows, N fmaf pairs a lane whatever W holds) is
``csrc/consensus_network.cu`` as it stood at commit ``0a517a3``: the probe
writes it and its header from git into ``build/probes/consensus_generic_parent/``
(first thing, before it looks for a GPU, so that a run from a git checkout
leaves them there for a copy of the tree without ``.git``) and builds it
there, so that both are timed in the same process on the same card.

Cases, at P = 199,210 (the MLP's posterior): the sync cell's 32 x 32 grid
(N = 1,024, degree-uniform W) at the f32 and bf16 wires; a complete W at
N = 64, 256 and 1,024 (f32); the grid masked with half the rows idle. For
each, by ``chip_smoke.cuda_ms`` (median of 20 CUDA-event calls, warm):
the shipped path (``consensus_fused_network`` / ``_masked``, both kernels,
and each kernel's device ms by the profiler), the earlier kernel, whether
the two give the same bits, the byte bound (16 N P + 4 N^2 bytes at
3.35 TB/s), the shipped path's share of it, and the card's walk counter
over one call (W entries walked of N^2).  The grid
at f32 also times the plain version.  Each result is one JSON line on
stdout.  Exits 2 without a GPU.
"""
from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PARENT = "0a517a3"  # the last commit with the chunked generic kernel
PARENT_DIR = ROOT / "build" / "probes" / "consensus_generic_parent"
SOURCES = ("consensus_network.cu", "eq6_common.cuh")
P = 199_210
HBM = 3.35e12  # bytes/s, H100 SXM


def parent_source():
    """Write the earlier kernel's sources from git into ``PARENT_DIR``,
    unless they are there already."""
    if all((PARENT_DIR / name).exists() for name in SOURCES):
        return
    PARENT_DIR.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
        src = subprocess.run(
            ["git", "-C", str(ROOT), "show", f"{PARENT}:src/repro_torch/kernels/csrc/{name}"],
            capture_output=True, text=True, check=True).stdout
        (PARENT_DIR / name).write_text(src)


def build_parent():
    """nvcc the earlier kernel into ``PARENT_DIR``; returns its library."""
    from repro_torch.kernels import dispatch

    out = PARENT_DIR / "consensus_network_parent.so"
    proc = subprocess.run([dispatch._nvcc(), *dispatch.NVCC_FLAGS, "-shared", "-o", str(out),
                           str(PARENT_DIR / SOURCES[0])], capture_output=True, text=True,
                          check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.consensus_network_blocks_per_sm.argtypes = [i32, i32]
    lib.consensus_network_blocks_per_sm.restype = i32
    lib.consensus_network_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, i32, i32,
                                             i32, i32, ptr]
    lib.consensus_network_launch.restype = i32
    return lib


def parent_call(lib, W, active, mean, rho, wire):
    """One launch of the earlier generic kernel (256-lane tiles on a
    one-wave grid, as its launch plan gave them); returns (mean, rho)."""
    import torch

    from repro_torch.kernels import consensus as k
    from repro_torch.kernels import launch_plan

    n, p = mean.shape
    code = k._WIRE_CODE[k.canonical_wire_dtype(wire)]
    mean_out, rho_out, vec = k._outputs_and_vec(mean, rho)
    per_sm = lib.consensus_network_blocks_per_sm(code, 0)
    sms = torch.cuda.get_device_properties(mean.device).multi_processor_count
    items = -(-p // 256)
    grid = launch_plan._grid(items, sms * per_sm)
    err = lib.consensus_network_launch(
        W.data_ptr(), None if active is None else active.data_ptr(), mean.data_ptr(),
        rho.data_ptr(), mean_out.data_ptr(), rho_out.data_ptr(), n, p, code, 0,
        min(vec, 2), grid, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent consensus_network_launch: cudaError {err}")
    return mean_out, rho_out


def kernel_ms(fn):
    """Device ms of each kernel of one call of ``fn`` (torch.profiler),
    after a warm-up call; empty where the profiler sees no device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:90]: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def same_bits(a, b):
    import torch

    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def main() -> int:
    import torch

    parent_source()
    if not torch.cuda.is_available():
        print("probes/consensus_generic.py needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import graphs
    from repro_torch.kernels import consensus as k
    from repro_torch.kernels import dispatch

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in true fp32
    dev = torch.device("cuda", 0)
    smi = cs.smi_name_power()
    dispatch.library()
    report = dispatch.build_info.get("ptxas", "").splitlines()
    ptxas = [" | ".join(x.strip() for x in report[i:i + 4]) for i, line in enumerate(report)
             if "Compiling entry function" in line and "consensus_generic_kernel" in line]
    print(json.dumps({"probe": "build", "nvidia_smi": smi, "built": dispatch.build_info.get("built"),
                      "ptxas": ptxas}))  # ptxas reports only when this process built the library
    parent = build_parent()

    g = torch.Generator(device=dev).manual_seed(37)
    mean = torch.randn((1024, P), generator=g, device=dev)
    rho = torch.rand((1024, P), generator=g, device=dev) * 5.0 - 4.5
    grid_w = torch.from_numpy(graphs.grid_w(32, 32)).to(dev, torch.float32)
    half = torch.arange(1024, device=dev) % 2 == 0
    cases = [("grid32x32", grid_w, None, "f32"), ("grid32x32", grid_w, None, "bf16"),
             ("complete64", None, None, "f32"), ("complete256", None, None, "f32"),
             ("complete1024", None, None, "f32"), ("grid32x32_masked_half", grid_w, half, "f32")]
    for name, W, active, wire in cases:
        if W is None:
            n = int(name.removeprefix("complete"))
            W = torch.from_numpy(graphs.complete_w(n)).to(dev, torch.float32)
        n = W.shape[0]
        m, r = mean[:n].contiguous(), rho[:n].contiguous()
        if active is None:
            shipped = functools.partial(k.consensus_fused_network, W, m, r, wire_dtype=wire)
        else:
            shipped = functools.partial(k.consensus_fused_masked, W, active, m, r,
                                        wire_dtype=wire)
        old = functools.partial(parent_call, parent, W, active, m, r, wire)
        dispatch.reset_launch_counts()
        got = shipped()
        walks = dispatch.walk_counts()
        bitwise = same_bits(got, old())
        del got
        bound_ms = (16 * n * P + 4 * n * n) / HBM * 1e3
        row = {"probe": name, "n": n, "p": P, "wire": wire,
               "idle_rows": 0 if active is None else int((~active).sum()),
               "nvidia_smi": smi, "bitwise_parent": bitwise,
               "walked": walks["walked"], "dense_entries": walks["dense"],
               "walked_share": walks["walked"] / walks["dense"],
               "kernel_ms": kernel_ms(shipped),
               "ms": cs.cuda_ms(shipped), "parent_ms": cs.cuda_ms(old), "bound_ms": bound_ms}
        if name == "grid32x32" and wire == "f32":
            row["plain_ms"] = cs.cuda_ms(functools.partial(k.consensus_network_plain, W, m, r,
                                                           wire), reps=5)
        row["bound_share"] = bound_ms / row["ms"]
        row["parent_bound_share"] = bound_ms / row["parent_ms"]
        row["parent_over_shipped"] = row["parent_ms"] / row["ms"]
        print(json.dumps(row), flush=True)
        del m, r
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
