#!/usr/bin/env python3
"""Timing study of ``consensus_fused_segments`` (``csrc/consensus_segments.cu``)
on one NVIDIA GPU: how the tile kernel's lanes a thread, its chunk of terms,
its register cap, its idle-row copy tile and the list's row order move its
time.

    python3 probes/consensus_segments.py

At the delayed slice's window 4 (N = 9, P = 199,210, 18 terms over a K = 4
ring, f32 and bf16 ring rows, wp_first) and at N = 4,200, full width, on
``chip_smoke``'s ``sparse_4200_full`` term list, it times by
``chip_smoke.cuda_ms`` (warm, and cold after a clean flush), beside the
launch floor:

* ``lane``: PR 19's kernel (``_segments_launch(..., instance=0)``);
* ``tile1`` / ``tile4``: the shipped tile kernel forced to 1 and 4 lanes a
  thread (4 needs P even and every row aligned to a pair, which both cases
  are); ``tile4_unordered``: 4 lanes without the list's row order (every
  row tiled alike, idle rows copied in the compute rows' tiles);
* ``planned``: what ``consensus_fused_segments`` launches;
* ``lanes<L>_chunk<C>_min<B>_copy<T>``: the tile kernel at L lanes a thread
  built from the same source with ``-DSEGMENT_PROBE_LANES=1`` (instances 2
  and 8 too) ``-DSEGMENT_CHUNK_LANES=C -DSEGMENT_MIN_BLOCKS=B
  -DSEGMENT_COPY_TILE=T`` into ``build/probes/`` and launched through its
  own C entry point;
* ``torch_copy_x``: ``Tensor.copy_`` of x's mean and rho, the card's copy
  rate beside the kernel's idle-row copies.

Each line says whether the variant gives the lane kernel's bits, the
kernel instance that ran and the registers and spill bytes ptxas gave it.
Two rounds, in turns.  Exits 2 without a GPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# (lanes a thread, chunk lanes, blocks an SM, copy tile); the shipped kernel: (4, 8, 4, 4096)
VARIANTS = [
    (2, 8, 4, 4096), (8, 16, 4, 4096), (8, 16, 2, 4096), (4, 16, 4, 4096), (4, 8, 3, 4096),
    (4, 8, 4, 1024),
]


def build_variants():
    """nvcc the shipped source once per variant, all at once; returns
    {tag: (library, ptxas report, copy tile)}."""
    from repro_torch.kernels import dispatch

    out = ROOT / "build" / "probes"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lanes, chunk, blocks, copy in VARIANTS:
        tag = f"lanes{lanes}_chunk{chunk}_min{blocks}_copy{copy}"
        so = out / f"segments_{tag}.so"
        flags = ["-DSEGMENT_PROBE_LANES=1", f"-DSEGMENT_CHUNK_LANES={chunk}",
                 f"-DSEGMENT_MIN_BLOCKS={blocks}", f"-DSEGMENT_COPY_TILE={copy}"]
        procs[tag] = (so, (lanes, copy), subprocess.Popen(
            [dispatch._nvcc(), *dispatch.NVCC_FLAGS, *flags, "-shared", "-o", str(so),
             str(dispatch.CSRC / "consensus_segments.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for tag, (so, shape, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{report}")
        lib = ctypes.CDLL(str(so))
        lib.consensus_segments_blocks_per_sm.argtypes = [i32, i32, i32, i32]
        lib.consensus_segments_launch.argtypes = [ptr] * 11 + [i64] * 5 + [i32] * 5 + [ptr]
        libs[tag] = (lib, report, shape)
    return libs


def variant_call(lib, shape, terms, xm, xr, hm, hr, wp_first, hist):
    """A launch of a variant library's tile kernel at ``shape = (lanes a
    thread, copy tile)``, its grid planned as ``launch_plan.segments_plan``
    plans the shipped one."""
    import torch

    from repro_torch.kernels import dispatch, launch_plan

    n, p = terms.n_rows, xm.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lanes, copy = shape
    wave = sms * lib.consensus_segments_blocks_per_sm(hist, 0, int(wp_first), lanes)
    items = terms.n_active * -(-p // (256 * lanes)) + (n - terms.n_active) * -(-p // copy)
    grid = launch_plan._grid(items, wave)

    def call():
        mo, ro = torch.empty((n, p), device=xm.device), torch.empty((n, p), device=xm.device)
        err = lib.consensus_segments_launch(
            terms.row_ptr.data_ptr(), terms.src.data_ptr(), terms.weight.data_ptr(),
            None if terms.pass_src is None else terms.pass_src.data_ptr(),
            terms.order.data_ptr(), xm.data_ptr(), xr.data_ptr(), hm.data_ptr(), hr.data_ptr(),
            mo.data_ptr(), ro.data_ptr(), xm.shape[0], hm.shape[0], n, terms.n_active, p,
            hist, 0, int(wp_first), lanes, grid, torch.cuda.current_stream().cuda_stream)
        dispatch.check_cuda(err, "probe variant")
        return mo, ro

    return call


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probes/consensus_segments.py needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import consensus as k
    from repro_torch.kernels import dispatch

    dev = torch.device("cuda", 0)
    dispatch.library()
    libs = build_variants()
    n, p = 9, cs.P_SLICE
    win = cs.gossip_spec(clock=cs.DELAYED_CLOCK).topology.gossip_clock().window(4)
    cases = []
    mean, rho = cs.seg_inputs(n, p, seed=7, device=dev)
    h_mean, h_rho = cs.seg_inputs(4 * n, p, seed=8, device=dev)
    slice_terms = cs.delayed_terms(win, 4, 4).to(dev)
    for ring in (torch.float32, torch.bfloat16):
        cases.append((f"delayed_slice_{str(ring)[6:]}", slice_terms, mean, rho,
                      h_mean.to(ring), h_rho.to(ring), True))
    _, full, _, n_x, p4, n_h, _, wp = next(c for c in cs.segment_cases()
                                           if c[0] == "sparse_4200_full")
    g = torch.Generator(dev).manual_seed(4200)
    big = [torch.randn((r, p4), generator=g, device=dev) for r in (n_x, n_h)]
    big_rho = [torch.rand((r, p4), generator=g, device=dev) * 5.0 - 4.5 for r in (n_x, n_h)]
    cases.append(("sparse_4200_full", full.to(dev), big[0], big_rho[0], big[1], big_rho[1], wp))
    flush = cs.Flush(dev)
    floor = cs.cuda_ms(lambda: torch.cuda._sleep(1))
    print(cs.smi_name_power())
    for rnd in range(2):
        for name, t, xm, xr, hm, hr, wp_first in cases:
            hist = {torch.float32: 0, torch.bfloat16: 1}[hm.dtype]
            unordered = dataclasses.replace(t, order=None, n_active=None)
            calls = {v: (functools.partial(k._segments_launch, terms, xm, xr, hm, hr, None,
                                           wp_first, inst), None)
                     for v, (terms, inst) in {"lane": (t, 0), "tile1": (t, 1), "tile4": (t, 4),
                                              "tile4_unordered": (unordered, 4),
                                              "planned": (t, None)}.items()}
            for tag, (lib, report, shape) in libs.items():
                calls[tag] = (variant_call(lib, shape, t, xm, xr, hm, hr, wp_first, hist), report)
            ref = k._segments_launch(t, xm, xr, hm, hr, None, wp_first, 0)
            for variant, (fn, report) in calls.items():
                got = fn()
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, ref))
                del got
                kernel = cs.kernel_variant(fn)
                if report is not None:  # read ptxas's report of the variant's own build
                    dispatch.build_info["ptxas"], shipped = report, dispatch.build_info.get(
                        "ptxas", "")
                usage = cs.ptxas_usage(kernel)
                if report is not None:
                    dispatch.build_info["ptxas"] = shipped
                warm, clean = cs.cuda_ms(fn), cs.cuda_ms(fn, flush.clean)
                print("probe " + json.dumps({
                    "round": rnd, "case": name, "variant": variant, "kernel": kernel,
                    "ms": warm, "cold_l2_clean_ms": clean, "launch_floor_ms": floor,
                    "ms_less_floor": warm - floor, "cold_l2_clean_ms_less_floor": clean - floor,
                    "lane_bits": same, **usage}), flush=True)
            del ref
            if rnd == 0:  # the card's copy rate: x's [N, P] mean and rho copied by torch
                dst = torch.empty_like(xm), torch.empty_like(xr)
                copy = lambda: (dst[0].copy_(xm), dst[1].copy_(xr))  # noqa: E731
                print("probe " + json.dumps({"case": name, "variant": "torch_copy_x",
                                             "bytes": 4 * xm.numel() * 4, "ms": cs.cuda_ms(copy),
                                             "launch_floor_ms": floor}), flush=True)
                del dst
    return 0


if __name__ == "__main__":
    sys.exit(main())
