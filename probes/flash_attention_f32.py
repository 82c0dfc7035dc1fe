#!/usr/bin/env python3
"""Timing study of the float32 flash attention kernel
(``csrc/flash_attention.cu``, 3xTF32 on ``mma.sync``) on one NVIDIA GPU,
beside the kernel it replaced and beside SDPA:

    python3 probes/flash_attention_f32.py [--quick]

The earlier float32 kernel (fp32 products on the CUDA cores) is
``csrc/flash_attention.cu`` as it stood at commit ``cccf734``, before the
3xTF32 design: the probe writes it from git into
``build/probes/flash_attention_simt.cu`` (first thing, before it looks for a
GPU, so that a run from a git checkout leaves it there for a copy of the
tree without ``.git``) and builds it there, so that its time can be taken
again on the same card.

First it holds the shipped kernel against ``flash_attention_plain`` at
atol = rtol = 2e-5 on ragged shapes at every head dim (and rows with no key
left).  Then at each shape of ``chip_smoke.ATTN_F32_SHAPES`` it reports, by
``chip_smoke.cuda_ms``: the shipped kernel warm, after a dirty and after a
clean L2 flush, and less the launch floor; the earlier kernel warm; the
plain version; SDPA on the same float32 tensors with the device kernels it
ran; the max abs errors against the plain version; and the bounds (3xTF32:
3 x 4 hd flops a pair at 495 TFLOP/s; fp32 SIMT: 4 hd a pair at
67 TFLOP/s).  ``--quick`` times the Qwen3-8B shape only.

``--rate`` times ``probes/mma_rate.cu``: ``mma.sync`` m16n8k8 tf32 and
m16n8k16 bf16 from registers, with no loads, at a few grid shapes (the
ceiling of this kernel's route on the card).

Each result is one JSON line on stdout.  Exits 2 without a GPU.
"""
from __future__ import annotations

import ctypes
import functools
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                                           i32, ctypes.c_float, ptr]
    lib.flash_attention_launch.restype = i32
    return lib


PARENT = "cccf734"  # the last commit with the fp32 SIMT kernel
SIMT_SRC = ROOT / "build" / "probes" / "flash_attention_simt.cu"


def parent_source():
    """Write the earlier float32 kernel's source from git into
    ``SIMT_SRC``, unless it is there already."""
    if SIMT_SRC.exists():
        return
    src = subprocess.run(
        ["git", "-C", str(ROOT), "show",
         f"{PARENT}:src/repro_torch/kernels/csrc/flash_attention.cu"],
        capture_output=True, text=True, check=True).stdout
    SIMT_SRC.parent.mkdir(parents=True, exist_ok=True)
    SIMT_SRC.write_text(src)


def build_simt():
    """nvcc the earlier float32 kernel into build/probes/; returns its
    library and ptxas's report."""
    from repro_torch.kernels import dispatch

    out = SIMT_SRC.with_suffix(".so")
    proc = subprocess.run([dispatch._nvcc(), *dispatch.NVCC_FLAGS, "-shared", "-o", str(out),
                           str(SIMT_SRC)], capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return _bind(ctypes.CDLL(str(out))), proc.stdout + proc.stderr


def call_launch(lib, q, k, v, causal, window):
    """One launch of ``flash_attention_launch`` from ``lib`` (the earlier
    kernel); returns its output."""
    import torch

    b, h, s, hd = q.shape
    out = torch.empty_like(q)
    err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     b, h, s, k.shape[2], hd, int(causal), int(window),
                                     1.0 / math.sqrt(hd),
                                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_launch: cudaError {err}")
    return out


def run_rate(dev, smi):
    """``--rate``: TFLOP/s of mma.sync alone (8 independent chains a warp)."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import dispatch

    out = ROOT / "build" / "probes" / "mma_rate.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([dispatch._nvcc(), *dispatch.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(ROOT / "probes" / "mma_rate.cu")], capture_output=True, check=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mma_rate_launch.argtypes = [ptr, i32, i32, i32, i32, ptr]
    lib.mma_rate_launch.restype = i32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    buf = torch.empty(sms * 8 * 1024, device=dev)
    iters, chains = 2048, 8
    for tf32, flop in ((1, 2 * 16 * 8 * 8), (0, 2 * 16 * 8 * 16)):
        for per_sm, threads in ((1, 128), (2, 128), (1, 256), (2, 256), (4, 256)):
            blocks = sms * per_sm

            def call(blocks=blocks, threads=threads, tf32=tf32):
                err = lib.mma_rate_launch(buf.data_ptr(), blocks, threads, iters, tf32,
                                          torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"mma_rate: cudaError {err}")
            ms = cs.cuda_ms(call)
            total = blocks * threads // 32 * iters * chains * flop
            row = {"probe": "mma_rate", "type": "tf32" if tf32 else "bf16",
                   "blocks_per_sm": per_sm, "threads": threads, "ms": ms,
                   "tflops": total / ms / 1e9, "nvidia_smi": smi}
            print(json.dumps(row))


def main() -> int:
    import torch
    import torch.nn.functional as F

    parent_source()
    if not torch.cuda.is_available():
        print("probes/flash_attention_f32.py needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import PEAK_FLOPS_FP32, PEAK_FLOPS_TF32

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in true fp32
    dev = torch.device("cuda", 0)
    smi = cs.smi_name_power()
    if "--rate" in sys.argv[1:]:
        run_rate(dev, smi)
        print(smi)
        return 0
    dispatch.library()
    report = dispatch.build_info.get("ptxas", "").splitlines()
    ptxas = [" | ".join(x.strip() for x in report[i:i + 4]) for i, line in enumerate(report)
             if "Compiling entry function" in line and "flash_attention_kernel" in line]
    print(json.dumps({"probe": "build", "nvidia_smi": smi, "ptxas": ptxas}))
    simt, _ = build_simt()

    worst = 0.0
    for hd in fa.HEAD_DIMS:
        for s, sk, causal, window in cs.ATT_HD_CASES + [(128, 64, True, 16), (256, 256, True, 0),
                                                         (320, 320, False, 0)]:
            g = torch.Generator(device=dev).manual_seed(hd + s + sk)
            q = torch.randn((2, 3, s, hd), generator=g, device=dev)
            k, v = (torch.randn((2, 3, sk, hd), generator=g, device=dev) for _ in range(2))
            err = cs.attention_errors(f"f32 hd {hd} s {s} sk {sk}",
                                      fa.flash_attention(q, k, v, causal=causal, window=window,
                                                         block_q=s, block_k=sk),
                                      fa.flash_attention_plain(q, k, v, causal=causal,
                                                               window=window),
                                      cs.ATT_TOL["f32"])
            worst = max(worst, err)
    print(json.dumps({"probe": "sweep", "max_abs_err": worst, "tol": cs.ATT_TOL["f32"]}))

    flush = cs.Flush(dev)
    floor = cs.cuda_ms(lambda: torch.cuda._sleep(1))
    names = ["flash_attention_f32"] if "--quick" in sys.argv[1:] else list(cs.ATTN_F32_SHAPES)
    for name in names:
        q, k, v, causal, window = cs.attention_f32_inputs(name, dev)
        b, h, s, hd = q.shape
        sk = k.shape[2]
        pairs = cs.attention_pairs(s, sk, causal, window) * b * h
        kern = functools.partial(fa.flash_attention, q, k, v, causal=causal, window=window,
                                 block_q=s, block_k=sk)  # one block: S = 1,500 is ragged
        plain = functools.partial(fa.flash_attention_plain, q, k, v, causal=causal,
                                  window=window)
        old = functools.partial(call_launch, simt, q, k, v, causal, window)
        if window:
            mask = fa.attention_mask(s, sk, causal, window, dev)
            sdpa = functools.partial(F.scaled_dot_product_attention, q, k, v, attn_mask=mask)
        else:
            sdpa = functools.partial(F.scaled_dot_product_attention, q, k, v, is_causal=causal)
        want = plain()
        row = {"probe": name, "shape": [b, h, s, sk, hd], "causal": causal, "window": window,
               "pairs": pairs, "nvidia_smi": smi,
               "max_abs_err": cs.attention_errors(f"{name} kernel", kern(), want,
                                                  cs.ATT_TOL["f32"]),
               "simt_max_abs_err": cs.attention_errors(f"{name} simt", old(), want,
                                                       cs.ATT_TOL["f32"]),
               "sdpa_max_abs_err": float((sdpa() - want).abs().max())}
        del want
        flops = 4 * hd * pairs
        row.update(
            ms=cs.cuda_ms(kern), cold_l2_ms=cs.cuda_ms(kern, flush.dirty),
            cold_l2_clean_ms=cs.cuda_ms(kern, flush.clean), launch_floor_ms=floor,
            simt_ms=cs.cuda_ms(old), plain_ms=cs.cuda_ms(plain, reps=5),
            sdpa_ms=cs.cuda_ms(sdpa), sdpa_kernels=cs.device_kernels(sdpa),
            kernel_names=cs.device_kernels(kern, top=1),
            bound_tf32_ms=3 * flops / PEAK_FLOPS_TF32 * 1e3,
            bound_fp32_ms=flops / PEAK_FLOPS_FP32 * 1e3)
        row["ms_less_floor"] = row["ms"] - floor
        row["bound_share"] = row["bound_tf32_ms"] / row["ms"]
        row["sdpa_over_kernel"] = row["sdpa_ms"] / row["ms"]
        row["simt_over_kernel"] = row["simt_ms"] / row["ms"]
        print(json.dumps(row))
        del q, k, v
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
