#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failed phase raises and the script exits non-zero):

1. device: the card's name and power limit, torch and CUDA versions, and the
   build of the kernel library from ``src/repro_torch/kernels/csrc/*.cu``;
2. every kernel against its plain PyTorch version on the card, at wire
   f32/bf16/f16: ``consensus_fused_network`` and ``consensus_fused_masked``
   at (N, P) = (9, 199210), (300, 4099), (1, 5), the masked kernel with
   masks all-true, all-false and mixed and its active rows bitwise the
   network kernel's; ``consensus_fused_sparse`` and
   ``consensus_fused_masked_sparse`` on the CSR tables of the 3x3 grid
   (D = 5) and of three gossip windows at P = 199210, and of N = 300
   ring and Watts-Strogatz graphs; ``payload_validity_fused`` bit-equal on
   buffers with NaN, +-inf, huge and f16-overflowing lanes planted, aligned
   and as views 4 and 8 bytes off 16-byte alignment, and at N = 70,000,
   P = 3 (each line names the kernel instance that ran, read from a CUDA
   graph of one call); the kernels of
   ``kernels.ops``: ``consensus_fused`` at (N, P) = (9, 199210), (300,
   4099), (1, 5) with zero weights in the row, ``sample_and_kl_fused`` at
   P = 199210, 2049, 5 and on views 16, 8 and 4 bytes aligned (theta
   bitwise the plain version's, the KL bitwise the same twice and on an
   aligned copy), and
   ``flash_attention`` on tests/test_kernels.py's sweep at f32, bf16 and
   f16 (bf16/f16 on the tensor-core kernel, f32 on the SIMT kernel), at
   every head dim 32-256 on ragged tiles at bf16 and f16, and on a case
   with Sk < S whose window leaves rows with no key (zeros) at each dtype;
3. the paths at full width, each with the launch counters set to 0 just
   before and read just after.  The synchronous slice: the paper's Fig. 4
   setting (3x3 grid, 9 agents, ``mnist_like`` 784-dim 10-class data, grid
   partition, the 784-200-200-10 Bayes-by-Backprop MLP, P = 199,210 per
   agent, batch 16, u = 4) through ``build_session -> run(3) -> evaluate()
   -> health()``.  The gossip slice: the same data and model on
   ``TopologySpec.gossip("grid", ...)`` with examples/async_gossip.py's
   unreliable Poisson clock and chaos faults under ``fault_policy=
   "quarantine"``, ``run(4) -> evaluate() -> health()``, then the same spec
   strict and fault-free.  The CSR path: ``consensus_flat_masked_sparse_
   quarantined`` on three of the slice's windows against the dense
   quarantined consensus, and ``consensus_flat_sparse`` on the base W.  The
   ops path (``kernels.ops``): ``consensus_posterior`` for each of the
   synchronous slice's 9 agents on its posterior pytree after ``run(3)``
   against row i of ``consensus_flat``; ``sample_and_kl`` on each agent's
   posterior pytree against its pre-round posterior, against the pytree
   ``kl_gaussian``; ``attention`` at B = 1, S = 4096 (``train_4k``), bf16,
   at the head shapes of Qwen3-8B (H = 32, hd = 128, causal, K/V repeated
   from 8 heads) and of RecurrentGemma-9B's local attention (H = 16,
   hd = 256, window 2048, K/V repeated from 1 head);
4. card vs CPU: one more synchronous round and one more gossip window from
   the same state with the same injected batches and noise, the card through
   the kernels, the CPU through the plain versions; and the equivalence
   ladder on the card, bitwise: all-edges gossip == synchronous, zero-fault
   quarantine == strict;
5. timings: each kernel's median time over warm launches (CUDA events), with
   its inputs in L2 and with L2 flushed, its plain version's, and its bound
   at the slice's shapes (``consensus_fused`` and ``sample_and_kl_fused`` at
   one agent's P = 199,210, ``flash_attention`` at both head shapes above,
   beside ``scaled_dot_product_attention``'s time and backend, with its
   TFLOP/s, share of the bound, ratio to SDPA and largest error in output
   ulps, and the f32 SIMT kernel's time at the Qwen3-8B heads); for
   ``payload_validity_fused`` and ``sample_and_kl_fused`` also the device
   operations one call runs and its kernel instance (both read from a CUDA
   graph of one call, not from a profiler), and the launch floor (a
   one-cycle ``torch.cuda._sleep`` under the same timer);
6. profile: the wall time of a warm synchronous round and of a warm gossip
   window of the slice, and their device time by kernel (torch.profiler).

The last lines are the card's ``nvidia-smi`` name and power limit, one JSON
line describing the kernels, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks: 3.35 TB/s HBM, 67 TFLOP/s fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores

# stated tolerances
F32_TOL = 1e-5            # kernel vs cuBLAS/plain, fp32 reduction order
WIRE_EPS = {"bf16": 2.0 ** -7, "f16": 2.0 ** -10}  # one wire ulp
PARITY_ATOL = 1e-4        # card vs CPU round: posterior and Adam first moment
PARITY_RTOL = 1e-4        # card vs CPU round: losses
# Adam divides by sqrt(v): where the second moment is this small the gradient
# is rounding noise (a ReLU unit no sample activates, a KL term at q == prior)
# and Adam scales it to a +-lr step whose sign differs between any two fp32
# implementations.  Such lanes (unless their gradient is exactly zero on both
# devices), and the lanes consensus mixes them into, are counted and exempt
# from PARITY_ATOL.
NU_NOISE_FLOOR = 1e-12

HIDDEN = 200  # the 784-200-200-10 MLP
P_SLICE = 199_210  # its parameters per agent
FIG4 = dict(
    dataset="mnist_like",
    dataset_params=dict(dim=784, n_classes=10),
    partition="grid",
    partition_params=dict(type1_labels=list(range(2, 10)), type2_labels=[0, 1],
                          type1_position=4),
    batch_size=16,
    local_updates=4,
)


# examples/async_gossip.py's unreliable Poisson clock and its chaos faults
GOSSIP_CLOCK = {"kind": "failure_injected", "inner": {"kind": "poisson", "rate": 0.8, "seed": 0},
                "drop_rate": 0.1}
CHAOS = {"crash_rate": 0.15, "recover_rate": 0.5, "corrupt_rate": 0.2, "corrupt_kind": "mix",
         "seed": 7}
CSR_ATOL = 1e-5  # CSR vs dense quarantined consensus: another fp32 sum order
KL_RTOL = 1e-5    # sample_and_kl vs the pytree kl_gaussian: another fp32 sum order
THETA_ATOL = 1e-6  # sample_and_kl's theta vs its plain version
ATT_TOL = {"f32": 2e-5, "bf16": 2e-2, "f16": 2e-2}  # attention vs plain (tests/test_kernels.py:75)
S_TRAIN = 4_096  # configs/base.py INPUT_SHAPES["train_4k"]
ATTN_SHAPES = {  # (heads, kv heads, head dim, window), causal, B = 1, bf16
    "qwen3_8b": (32, 8, 128, 0),  # configs/qwen3_8b.py
    "recurrentgemma_9b_local": (16, 1, 256, 2048),  # configs/recurrentgemma_9b.py
}
ATT_SWEEP = [  # tests/test_kernels.py:56-66: (s, block_q, block_k, causal, window)
    (128, 64, 64, True, 0),
    (128, 128, 64, False, 0),
    (256, 64, 64, True, 100),
    (256, 128, 128, True, 0),
    (64, 64, 64, True, 16),
]
ATT_HD_CASES = [  # ragged tiles at every head dim: (s, sk, causal, window)
    (100, 100, True, 0), (192, 160, False, 50), (200, 300, True, 64),
]
WIRES = ("f32", "bf16", "f16")
SRC = "src/repro_torch/kernels/csrc/"
REF = "src/repro/kernels/consensus.py:"


def phase(tag: str, **fields) -> None:
    print(f"phase {tag} " + json.dumps(fields, default=str), flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def fig4_spec():
    from repro_torch.api import DataSpec, ExperimentSpec, InferenceSpec, RunSpec, TopologySpec

    return ExperimentSpec(
        topology=TopologySpec.grid(3, 3),
        data=DataSpec(**FIG4),
        inference=InferenceSpec(hidden=HIDDEN, depth=2),
        run=RunSpec(n_rounds=3, seed=0),
    )


def gossip_spec(policy="quarantine", faults=True, clock=None):
    from repro_torch.api import DataSpec, ExperimentSpec, InferenceSpec, RunSpec, TopologySpec

    clock = dict(clock or GOSSIP_CLOCK, **({"faults": CHAOS} if faults else {}))
    return ExperimentSpec(
        topology=TopologySpec.gossip("grid", {"rows": 3, "cols": 3}, clock=clock),
        data=DataSpec(**FIG4),
        inference=InferenceSpec(hidden=HIDDEN, depth=2, fault_policy=policy),
        run=RunSpec(n_rounds=4, seed=0),
    )


def gossip_windows(n=3):
    """The first ``n`` event windows of the gossip slice's clock."""
    return [gossip_spec().topology.gossip_clock().window(r) for r in range(n)]


def eq6_inputs(n, p, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    w = torch.rand((n, n), generator=g) + 0.05
    w = w / w.sum(dim=1, keepdim=True)
    mean = torch.randn((n, p), generator=g)
    rho = torch.rand((n, p), generator=g) * 5.0 - 4.5  # sigma ~1e-2..1: f16-safe
    return w.to(device), mean.to(device), rho.to(device)


def poisoned(n, p, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    mean = torch.randn((n, p), generator=g)
    rho = torch.rand((n, p), generator=g) * 3.5 - 3.0
    mean[1, 17] = float("nan")
    rho[2, p // 2] = float("inf")    # sigma inf -> prec 0
    rho[3, 5] = float("-inf")        # sigma 0 -> prec inf
    mean[4, p - 1] = 1e30            # huge, finite
    rho[5, 42] = -6.0                # prec ~1.6e5 overflows f16 only
    mean[6, 7] = float("-inf")
    return mean.to(device), rho.to(device)


def eq6_errors(what, got, want, wire):
    """Max abs errors of a kernel's (mean, rho) against its plain version;
    raises beyond the stated tolerance (F32_TOL at f32, one wire ulp of the
    output scale otherwise)."""
    import torch

    torch.cuda.synchronize()
    errs = []
    for g_, w_ in zip(got, want):
        err = (g_ - w_).abs()
        if wire == "f32":
            tol = F32_TOL + F32_TOL * w_.abs()
        else:
            u = WIRE_EPS[wire]
            tol = u * w_.abs() + u * w_.abs().max()
        if not bool(torch.all(err <= tol)):
            raise AssertionError(f"{what} wire={wire}: max err {float(err.max())} "
                                 "beyond tolerance")
        errs.append(float(err.max()))
    return errs


def check_kernels(dev):
    """Phase 2: every kernel against its plain version on the card."""
    import numpy as np
    import torch

    from repro_torch.core import graphs
    from repro_torch.core.flat import neighbor_tables
    from repro_torch.kernels import consensus as k

    worst = {}
    for (n, p) in [(9, P_SLICE), (300, 4_099), (1, 5)]:
        for wire in WIRES:
            W, mean, rho = eq6_inputs(n, p, seed=n + p, device=dev)
            got = k.consensus_fused_network(W, mean, rho, wire_dtype=wire)
            want = k.consensus_network_plain(W, mean, rho, wire)
            errs = eq6_errors(f"consensus_fused_network N={n} P={p}", got, want, wire)
            phase("2.consensus", n=n, p=p, wire=wire, max_abs_err_mean=errs[0],
                  max_abs_err_rho=errs[1])
            if (n, p, wire) == (9, P_SLICE, "f32"):
                worst["consensus_fused_network"] = max(errs)
            masks = {"all": torch.ones(n, dtype=torch.bool), "none": torch.zeros(n, dtype=torch.bool),
                     "mixed": torch.arange(n) % 3 != 1}
            for mask, active in masks.items():
                active = active.to(dev)
                got_m = k.consensus_fused_masked(W, active, mean, rho, wire_dtype=wire)
                want_m = k.consensus_masked_plain(W, active, mean, rho, wire)
                errs = eq6_errors(f"consensus_fused_masked N={n} P={p} mask={mask}", got_m,
                                  want_m, wire)
                for g_, x, nt in zip(got_m, (mean, rho), got):
                    if not (torch.equal(g_[active], nt[active])
                            and torch.equal(g_[~active], x[~active])):
                        raise AssertionError(
                            f"consensus_fused_masked N={n} P={p} mask={mask} wire={wire}: "
                            "active rows not bitwise the network kernel's, or inactive "
                            "rows not passed through")
                phase("2.masked", n=n, p=p, wire=wire, mask=mask, max_abs_err_mean=errs[0],
                      max_abs_err_rho=errs[1], active_rows_bitwise_network=True)
                if (n, p, wire, mask) == (9, P_SLICE, "f32", "mixed"):
                    worst["consensus_fused_masked"] = max(errs)
    tables = [("grid_base", neighbor_tables(graphs.grid_w(3, 3)), P_SLICE, None)]
    tables += [(f"window{w.index}", neighbor_tables(w.w_eff), P_SLICE, w.active)
               for w in gossip_windows()]
    tables += [("ring300", neighbor_tables(graphs.bidirectional_ring_w(300)), 4_099, None),
               ("ws300", graphs.watts_strogatz_sparse(300, 6, 0.2, seed=0).neighbor_tables(),
                4_099, None)]
    for name, (nbr, wts), p, win_active in tables:
        n, d = nbr.shape
        nbr, wts = torch.from_numpy(nbr).to(dev), torch.from_numpy(wts).to(dev)
        active = (torch.from_numpy(np.asarray(win_active)) if win_active is not None
                  else torch.arange(n) % 4 != 2).to(dev)
        for wire in WIRES:
            _, mean, rho = eq6_inputs(n, p, seed=n + p + d, device=dev)
            errs = eq6_errors(f"consensus_fused_sparse {name}",
                              k.consensus_fused_sparse(nbr, wts, mean, rho, wire_dtype=wire),
                              k.consensus_sparse_plain(nbr, wts, mean, rho, wire), wire)
            got_m = k.consensus_fused_masked_sparse(nbr, wts, active, mean, rho, wire_dtype=wire)
            errs_m = eq6_errors(f"consensus_fused_masked_sparse {name}", got_m,
                                k.consensus_masked_sparse_plain(nbr, wts, active, mean, rho,
                                                                wire), wire)
            if not (torch.equal(got_m[0][~active], mean[~active])
                    and torch.equal(got_m[1][~active], rho[~active])):
                raise AssertionError(f"consensus_fused_masked_sparse {name}: inactive rows "
                                     "not passed through")
            phase("2.sparse", tables=name, n=n, d=d, p=p, wire=wire,
                  n_active=int(active.sum()), max_abs_err=max(errs),
                  masked_max_abs_err=max(errs_m))
            if wire == "f32" and name == "grid_base":
                worst["consensus_fused_sparse"] = max(errs)
            if wire == "f32" and name == "window1":
                worst["consensus_fused_masked_sparse"] = max(errs_m)
    expect = {"f32": [True, False, False, False, False, True, False, True, True],
              "bf16": [True, False, False, False, False, True, False, True, True],
              "f16": [True, False, False, False, False, False, False, True, True]}
    for wire in ("f32", "bf16", "f16"):
        mean, rho = poisoned(9, P_SLICE, seed=3, device=dev)
        for case, start in (("aligned", 0), ("4B_off", 1), ("8B_off", 2)):
            if start:  # the same rows, a view `start` floats into a larger buffer
                mean, rho = (torch.cat([torch.zeros(start, device=dev), x.view(-1)])[start:]
                             .view(x.shape) for x in (mean, rho))
            fn = functools.partial(k.payload_validity_fused, mean, rho, bound=1e20,
                                   wire_dtype=wire)
            got, want = fn(), k.payload_validity_plain(mean, rho, bound=1e20, wire_dtype=wire)
            torch.cuda.synchronize()
            if not torch.equal(got.cpu(), want.cpu()) or got.cpu().tolist() != expect[wire]:
                raise AssertionError(f"payload_validity_fused wire={wire} {case}: "
                                     f"{got.tolist()} vs plain {want.tolist()}, expected "
                                     f"{expect[wire]}")
            phase("2.validity", wire=wire, case=case, ok=got.cpu().tolist(), bit_equal=True,
                  variant=kernel_variant(fn))
        n, p = 70_000, 3  # more agents than a grid dimension holds; chunks span many rows
        g = torch.Generator().manual_seed(70)
        mean, rho = torch.randn((n, p), generator=g), torch.rand((n, p), generator=g) * 3.5 - 3.0
        bad = torch.randperm(n, generator=g)[:700]
        mean.view(-1)[bad * p + bad % p] = float("nan")
        mean, rho = mean.to(dev), rho.to(dev)
        fn = functools.partial(k.payload_validity_fused, mean, rho, bound=1e20, wire_dtype=wire)
        got, want = fn(), k.payload_validity_plain(mean, rho, bound=1e20, wire_dtype=wire)
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want.cpu()) or int((~got).sum()) != len(bad):
            raise AssertionError(f"payload_validity_fused wire={wire} N={n}: "
                                 f"{int((~got).sum())} invalid, plain {int((~want).sum())}")
        phase("2.validity", wire=wire, case=f"n{n}_p{p}", n_invalid=int((~got).sum()),
              bit_equal=True, variant=kernel_variant(fn))
    worst["payload_validity_fused"] = 0.0
    return worst


def kernel_variant(fn):
    """The template instance of the one device kernel ``fn`` launches (e.g.
    ``payload_validity_kernel<0, 4>``: wire code, lanes per load), read from
    the captured graph of one call (``captured_work``)."""
    work = captured_work(fn)
    if len(work) != 1 or work[0]["type"] != "kernel" or "<" not in work[0]["name"]:
        raise AssertionError(f"expected one templated device kernel, got {work}")
    return work[0]["name"]


def attention_inputs(name, dev, dtype=None):
    """q [1, H, S, hd] and k, v repeated from the config's KV heads to H
    (``ops.attention`` has no grouped heads), from a seed, on the card."""
    import torch

    h, kv, hd, window = ATTN_SHAPES[name]
    g = torch.Generator(device=dev).manual_seed(hd + h)
    dtype = dtype or torch.bfloat16
    q = torch.randn((1, h, S_TRAIN, hd), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((1, kv, S_TRAIN, hd), generator=g, device=dev).to(dtype)
            .repeat_interleave(h // kv, dim=1) for _ in range(2))
    return q, k, v, window


def attention_pairs(s, sk, causal, window):
    """The number of (query, key) pairs the mask leaves, counted exactly."""
    import torch

    q = torch.arange(s, dtype=torch.int64)
    hi = torch.clamp(q, max=sk - 1) if causal else torch.full_like(q, sk - 1)
    lo = torch.clamp(q - window + 1, min=0) if window else torch.zeros_like(q)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def attention_errors(what, got, want, tol):
    """Max abs error of an attention output against its plain version;
    raises beyond atol = rtol = ``tol``."""
    import torch

    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if got.shape != want.shape or got.dtype != want.dtype or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
                             f"{tuple(want.shape)}, or not finite")
    err = (g - w).abs()
    if not bool(torch.all(err <= tol + tol * w.abs())):
        raise AssertionError(f"{what}: max err {float(err.max())} beyond {tol}")
    return float(err.max())


def attention_ulps(got, want):
    """The largest difference of a bf16 attention output from its plain
    version in units of the last place of max(|plain|, 2^-10), and how many
    elements differ at all.  Below 2^-10 an output is a near-cancelling sum
    whose own last place is far finer than the fp32 rounding of its terms."""
    import torch

    w, g = want.float(), got.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -10))) - 7)
    return float(((g - w).abs() / ulp).max()), int((g != w).sum())


def check_ops_kernels(dev):
    """Phase 2, the kernels of ``kernels.ops`` against their plain versions
    on the card."""
    import torch

    from repro_torch.kernels import consensus as k
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gauss_vi

    worst = {}
    for (n, p) in [(9, P_SLICE), (300, 4_099), (1, 5)]:
        for wire in WIRES:
            W, mean, rho = eq6_inputs(n, p, seed=n + p + 1, device=dev)
            w = W[n // 2].clone()
            if n > 2:  # zero weights in the row are computed, not skipped
                w[0] = w[-1] = 0.0
                w = w / w.sum()
            errs = eq6_errors(f"consensus_fused N={n} P={p}",
                              k.consensus_fused(w, mean, rho, wire_dtype=wire),
                              k.consensus_row_plain(w, mean, rho, wire), wire)
            phase("2.consensus_row", n=n, p=p, wire=wire, zero_weights=int((w == 0).sum()),
                  max_abs_err_mean=errs[0], max_abs_err_rho=errs[1])
            if (n, p, wire) == (9, P_SLICE, "f32"):
                worst["consensus_fused"] = max(errs)
    vi_cases = [(P_SLICE, None), (2_049, None), (5, None), (P_SLICE, (P_SLICE, 1, 2, 3, 0))]
    for p, starts in vi_cases:
        g = torch.Generator(device=dev).manual_seed(p)
        args = [torch.randn(p, generator=g, device=dev) * sc + off
                for sc, off in ((1.0, 0.0), (0.3, -1.0), (1.0, 0.0), (0.1, 0.0), (0.1, 0.0))]
        if starts:  # each a view `start` floats into a buffer: 16, 8 and 4 bytes aligned
            args = [torch.cat([torch.zeros(st, device=dev), a])[st:]
                    for st, a in zip(starts, args)]
        fn = functools.partial(gauss_vi.sample_and_kl_fused, *args)
        (theta, kl), (theta2, kl2) = fn(), fn()
        want_theta, want_kl = gauss_vi.sample_and_kl_plain(*args)
        kl_aligned = gauss_vi.sample_and_kl_fused(*(a.clone() for a in args))[1]
        torch.cuda.synchronize()
        err = float((theta - want_theta).abs().max())
        kl_rel = abs(float(kl) - float(want_kl)) / abs(float(want_kl))
        if (not torch.equal(theta, want_theta) or kl_rel > KL_RTOL
                or not (torch.equal(kl, kl2) and torch.equal(theta, theta2)
                        and torch.equal(kl, kl_aligned))):
            raise AssertionError(f"sample_and_kl_fused P={p} starts={starts}: theta err {err}, "
                                 f"KL rel err {kl_rel}, or not the same twice or aligned")
        phase("2.sample_and_kl", p=p, starts=starts, max_abs_err_theta=err, theta_bitwise=True,
              kl=float(kl), kl_rel_err=kl_rel, same_twice=True, same_as_aligned_copy=True,
              variant=kernel_variant(fn))
        if p == P_SLICE and starts is None:
            worst["sample_and_kl_fused"] = err
    cases = [(dt, (2, 2, s_, 64), s_, causal, window, dict(block_q=bq, block_k=bk))
             for dt in WIRES for s_, bq, bk, causal, window in ATT_SWEEP]
    cases += [(dt, (1, 3, s_, hd), sk, causal, window, dict(block_q=s_, block_k=sk))
              for dt in ("bf16", "f16") for hd in fa.HEAD_DIMS
              for s_, sk, causal, window in ATT_HD_CASES]
    cases += [(dt, (1, 2, 128, 64), 64, True, 16, dict(block_q=64, block_k=64)) for dt in WIRES]
    worst["flash_attention"] = 0.0
    for dt, shape, sk, causal, window, blocks in cases:
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[dt]
        g = torch.Generator(device=dev).manual_seed(shape[2] + blocks["block_q"])
        q = torch.randn(shape, generator=g, device=dev).to(dtype)
        kk, vv = (torch.randn(shape[:2] + (sk, shape[3]), generator=g, device=dev).to(dtype)
                  for _ in range(2))
        got = fa.flash_attention(q, kk, vv, causal=causal, window=window, **blocks)
        want = fa.flash_attention_plain(q, kk, vv, causal=causal, window=window)
        err = attention_errors(f"flash_attention {dt} {shape} Sk={sk}", got, want, ATT_TOL[dt])
        dead = torch.arange(shape[2], device=dev) >= sk + window - 1 if sk < shape[2] else None
        if dead is not None and not bool((got[:, :, dead] == 0).all()):
            raise AssertionError("flash_attention: rows with no key left are not 0")
        phase("2.flash_attention", dtype=dt, shape=shape, sk=sk, causal=causal, window=window,
              max_abs_err=err, rows_without_keys=0 if dead is None else int(dead.sum()))
        if dt != "f32":  # the row reports the tensor-core kernel
            worst["flash_attention"] = max(worst["flash_attention"], err)
    return worst


def run_slice(dev):
    """Phase 3: the main path at full width, counters around it."""
    import numpy as np
    import torch

    from repro_torch.api import build_session
    from repro_torch.kernels import dispatch

    t0 = time.perf_counter()
    session = build_session(fig4_spec(), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prior = session.posterior()
    prior = dataclasses.replace(prior, mean=prior.mean.clone(), rho=prior.rho.clone())
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    hist = session.run(n_rounds=3, eval_every=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ev = session.evaluate()
    health = session.health()
    counts = dispatch.launch_counts()
    losses = [r["loss"] for r in hist]
    p = session.posterior().n_params()
    if p != P_SLICE:
        raise AssertionError(f"P = {p}, expected {P_SLICE} for 784-200-200-10")
    if not np.all(np.isfinite(losses)) or not np.isfinite(session.posterior().mean.cpu().numpy()).all():
        raise AssertionError(f"non-finite losses or posterior: {losses}")
    if not health["all_ok"]:
        raise AssertionError(f"health(): {health}")
    if min(counts["consensus_fused_network"], counts["payload_validity_fused"]) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {counts}")
    phase("3.slice", agents=session.data.n_agents, n_params=p, losses=losses,
          avg_acc=ev["avg_acc"], acc=ev["acc"], health=health["n_healthy"],
          launches=counts, setup_s=setup_s, run3_s=run_s)
    return session, counts, prior


def card_vs_cpu(tag, session, spec):
    """One more round on the card and on the CPU from the same state with
    the same injected draws; the CPU runs the plain versions."""
    import numpy as np
    import torch

    from repro_torch.api import build_session

    cpu = build_session(spec, device="cpu")
    cpu.state = session.state.to("cpu")
    cpu.round_idx = session.round_idx
    W = torch.as_tensor(np.asarray(spec.topology.w_schedule()(session.round_idx)),
                        dtype=torch.float32)
    n, p = session.posterior().mean.shape
    u, b = FIG4["local_updates"], FIG4["batch_size"]
    g = torch.Generator().manual_seed(2024)
    idx = torch.randint(0, 150, (n, u * b), generator=g)  # every shard holds >= 150
    eps = torch.randn((n, u, 1, p), generator=g)
    rec_card = session.round(batch_idx=idx, eps=eps)
    rec_cpu = cpu.round(batch_idx=idx, eps=eps)
    a, c = session.state.to("cpu"), cpu.state
    noise = torch.zeros((n, p), dtype=torch.bool)
    for field in ("mean", "rho"):  # lanes without a zero gradient on both devices
        x, y = getattr(a.opt_state.nu, field), getattr(c.opt_state.nu, field)
        noise |= (torch.minimum(x, y) < NU_NOISE_FLOOR) & (torch.maximum(x, y) > 0)
    exempt = ((W > 0).float() @ noise.float()) > 0  # lanes consensus mixes noise into
    errs, exempt_errs = {}, {}
    for name, x, y in [("mean", a.posterior.mean, c.posterior.mean),
                       ("rho", a.posterior.rho, c.posterior.rho),
                       ("adam_mu_mean", a.opt_state.mu.mean, c.opt_state.mu.mean),
                       ("adam_mu_rho", a.opt_state.mu.rho, c.opt_state.mu.rho)]:
        d = (x - y).abs()
        errs[name] = float(torch.where(exempt, 0.0, d).max())
        exempt_errs[name] = float(torch.where(exempt, d, 0.0).max())
    lc, lp = rec_card["losses"], rec_cpu["losses"]
    if not np.array_equal(np.isnan(lc), np.isnan(lp)):
        raise AssertionError(f"{tag}: agents trained differ: {lc} vs {lp}")
    ok = ~np.isnan(lp)
    loss_rel = float(abs(lc[ok] - lp[ok]).max() / abs(lp[ok]).max())
    same_counters = all(torch.equal(getattr(a, f), getattr(c, f))
                        for f in ("step", "round", "last_merge", "n_merges", "n_quarantined")
                        if getattr(c, f, None) is not None)
    phase(tag, max_abs_err=errs, loss_max_rel_err=loss_rel, atol=PARITY_ATOL,
          rtol=PARITY_RTOL, noise_lanes=int(noise.sum()), exempt_lanes=int(exempt.sum()),
          lanes=n * p, exempt_max_abs_err=exempt_errs, counters_equal=same_counters,
          n_trained=rec_card["n_trained"])
    if max(errs.values()) > PARITY_ATOL or loss_rel > PARITY_RTOL or not same_counters:
        raise AssertionError(f"{tag}: card vs CPU disagree beyond tolerance")


def run_gossip(dev):
    """Phase 3.gossip: the gossip slice at full width, chaos + quarantine,
    then strict and fault-free; counters around each run."""
    import numpy as np
    import torch

    from repro_torch.api import build_session
    from repro_torch.kernels import dispatch

    out = {}
    for tag, spec, n_rounds in [("3.gossip", gossip_spec("quarantine", faults=True), 4),
                                ("3.gossip_strict", gossip_spec("strict", faults=False), 2)]:
        session = build_session(spec, device=dev)
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        hist = session.run(n_rounds=n_rounds, eval_every=1)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        ev = session.evaluate()
        health = session.health()
        counts = dispatch.launch_counts()
        losses = [r["loss"] for r in hist]
        tel = ev["engine"]
        if any(x is None or not np.isfinite(x) for x in losses):
            raise AssertionError(f"{tag}: losses {losses}")
        if not health["all_ok"] or not torch.isfinite(session.posterior().mean).all():
            raise AssertionError(f"{tag}: health() {health}")
        if counts["consensus_fused_masked"] <= 0 or counts["payload_validity_fused"] <= 0:
            raise AssertionError(f"{tag}: a kernel of the path was never launched: {counts}")
        if tag == "3.gossip" and not tel["faults"]["quarantined"]["total"] > 0:
            raise AssertionError(f"{tag}: nothing quarantined: {tel['faults']}")
        phase(tag, n_params=session.posterior().n_params(), losses=losses,
              n_trained=[r["n_trained"] for r in hist],
              n_crashed=[r.get("n_crashed") for r in hist], avg_acc=ev["avg_acc"],
              engine=tel, health=health["n_healthy"], launches=counts, run_s=run_s)
        out[tag] = (session, counts)
    return out


def run_csr(dev, session):
    """Phase 3.csr: the CSR kernels' path: the quarantined CSR consensus on
    three of the slice's windows against the dense quarantined consensus
    (with that window's corrupted transmissions), and the CSR consensus on
    the base W against the dense one; counters around it."""
    import numpy as np
    import torch

    from repro_torch.core import flat
    from repro_torch.kernels import dispatch

    post = session.posterior()
    faults = session.engine.faults
    base = session.spec.topology.base_w()
    dispatch.reset_launch_counts()
    errs = []
    for win in gossip_windows():
        corrupt = torch.from_numpy(faults.corrupted(win.index)).to(dev)[:, None]
        fm, fr = (torch.from_numpy(a).to(dev)[:, None] for a in faults.fills(win.index))
        mean_src = torch.where(corrupt, fm, post.mean)
        rho_src = torch.where(corrupt, fr, post.rho)
        nbr, wts = flat.neighbor_tables(win.w_eff)
        got, vs = flat.consensus_flat_masked_sparse_quarantined(
            post, nbr, wts, win.active, mean_src=mean_src, rho_src=rho_src)
        want, vd = flat.consensus_flat_masked_quarantined(
            post, win.w_eff, win.active, mean_src=mean_src, rho_src=rho_src)
        err = max(float((got.mean - want.mean).abs().max()),
                  float((got.rho - want.rho).abs().max()))
        if not torch.equal(vs, vd) or not err <= CSR_ATOL:
            raise AssertionError(f"3.csr window {win.index}: err {err}, valid {vs} vs {vd}")
        errs.append(err)
    nbr, wts = flat.neighbor_tables(base)
    got = flat.consensus_flat_sparse(post, nbr, wts)
    want = flat.consensus_flat(post, torch.from_numpy(np.asarray(base)))
    base_err = max(float((got.mean - want.mean).abs().max()),
                   float((got.rho - want.rho).abs().max()))
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    if base_err > CSR_ATOL or min(counts["consensus_fused_sparse"],
                                  counts["consensus_fused_masked_sparse"]) <= 0:
        raise AssertionError(f"3.csr: base err {base_err}, launches {counts}")
    phase("3.csr", window_max_abs_err=errs, base_max_abs_err=base_err, atol=CSR_ATOL,
          launches=counts)
    return counts


def run_ops(dev, session, prior):
    """Phase 3.ops: the public kernel API (``kernels.ops``) at full width,
    counters around it: ``consensus_posterior`` for each of the synchronous
    slice's agents on its posterior pytree, ``sample_and_kl`` on each agent's
    pytree against its pre-round posterior, ``attention`` at the two head
    shapes."""
    import numpy as np
    import torch

    from repro_torch.core import flat
    from repro_torch.core.posterior import GaussianPosterior, kl_gaussian
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gauss_vi

    post = session.posterior()
    layout = post.layout
    n = post.mean.shape[0]
    W = torch.as_tensor(np.asarray(fig4_spec().topology.w_schedule()(session.round_idx)),
                        dtype=torch.float32, device=dev)
    want = flat.consensus_flat(post, W)  # the network kernel, before the counters
    stacked = GaussianPosterior(layout.unflatten(post.mean), layout.unflatten(post.rho))
    agents = [GaussianPosterior(layout.unflatten(post.mean[i]), layout.unflatten(post.rho[i]))
              for i in range(n)]
    priors = [GaussianPosterior(layout.unflatten(prior.mean[i]), layout.unflatten(prior.rho[i]))
              for i in range(n)]
    att = {name: attention_inputs(name, dev) for name in ATTN_SHAPES}
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    rows = [ops.consensus_posterior(stacked, W[i]) for i in range(n)]
    draws = [ops.sample_and_kl(agents[i], priors[i], torch.Generator(device=dev).manual_seed(i))
             for i in range(n)]
    outs = {name: ops.attention(q, k, v, causal=True, window=window)
            for name, (q, k, v, window) in att.items()}
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    row_err = 0.0
    for i, out in enumerate(rows):
        for got, ref in ((layout.flatten(out.mean), want.mean[i]),
                         (layout.flatten(out.rho), want.rho[i])):
            err = (got - ref).abs()
            if not bool(torch.all(err <= F32_TOL + F32_TOL * ref.abs())):
                raise AssertionError(f"3.ops consensus_posterior agent {i}: max err "
                                     f"{float(err.max())} vs consensus_flat")
            row_err = max(row_err, float(err.max()))
    kl_errs, theta_err, kls = [], 0.0, []
    for i, (theta, kl) in enumerate(draws):
        kl_ref = float(kl_gaussian(agents[i], priors[i]))
        kl_errs.append(abs(float(kl) - kl_ref) / abs(kl_ref))
        kls.append(float(kl))
        eps = torch.randn(layout.n_params, generator=torch.Generator(device=dev).manual_seed(i),
                          device=dev)
        theta_plain, _ = gauss_vi.sample_and_kl_plain(post.mean[i], post.rho[i], eps,
                                                      prior.mean[i], prior.rho[i])
        theta_err = max(theta_err, float((layout.flatten(theta) - theta_plain).abs().max()))
        if not kl_ref > 0.0 or kl_errs[-1] > KL_RTOL:
            raise AssertionError(f"3.ops sample_and_kl agent {i}: KL {float(kl)} vs {kl_ref}")
    if theta_err > THETA_ATOL:
        raise AssertionError(f"3.ops sample_and_kl: theta max err {theta_err}")
    att_errs = {}
    for name, (q, k, v, window) in att.items():
        want_att = fa.flash_attention_plain(q, k, v, causal=True, window=window)
        att_errs[name] = attention_errors(f"3.ops attention {name}", outs[name], want_att,
                                          ATT_TOL["bf16"])
    expect = {"consensus_fused": n, "sample_and_kl_fused": n, "flash_attention": len(att)}
    if any(counts[name] < times for name, times in expect.items()):
        raise AssertionError(f"3.ops: a kernel of the path was launched too rarely: {counts}")
    phase("3.ops", agents=n, n_params=layout.n_params,
          consensus_posterior_max_abs_err=row_err, atol=F32_TOL, kl=kls,
          kl_max_rel_err=max(kl_errs), theta_max_abs_err=theta_err,
          attention={name: dict(shape=list(att[name][0].shape), window=att[name][3],
                                max_abs_err=att_errs[name]) for name in att},
          launches=counts, run_s=run_s)
    return counts


def ladders(dev):
    """Phase 4.ladder: bitwise rungs on the card — all-edges gossip ==
    synchronous, zero-fault quarantine == strict — after 2 rounds from the
    same injected draws."""
    import numpy as np
    import torch

    from repro_torch.api import build_session
    from repro_torch.gossip.clocks import _directed_edges

    edges = [[int(i), int(j)] for i, j in _directed_edges(fig4_spec().topology.w_schedule()(0))]
    all_edges = {"kind": "trace", "trace": [edges]}
    pairs = {
        "all_edges_gossip==synchronous": (gossip_spec("strict", False, all_edges), fig4_spec()),
        "zero_fault_quarantine==strict": (gossip_spec("quarantine", False),
                                          gossip_spec("strict", False)),
    }
    n, p = 9, P_SLICE
    u, b = FIG4["local_updates"], FIG4["batch_size"]
    for name, (spec_a, spec_b) in pairs.items():
        a, c = build_session(spec_a, device=dev), build_session(spec_b, device=dev)
        g = torch.Generator().manual_seed(7)
        for _ in range(2):
            idx = torch.randint(0, 150, (n, u * b), generator=g)
            eps = torch.randn((n, u, 1, p), generator=g)
            a.round(batch_idx=idx, eps=eps)
            c.round(batch_idx=idx, eps=eps)
        torch.cuda.synchronize()
        same = {f: bool(torch.equal(getattr(a.posterior(), f), getattr(c.posterior(), f)))
                for f in ("mean", "rho")}
        same["adam_nu_rho"] = bool(torch.equal(a.state.opt_state.nu.rho,
                                               c.state.opt_state.nu.rho))
        phase("4.ladder", rung=name, bitwise=same,
              engines=[a.engine.name, c.engine.name])
        if not all(same.values()) or not np.isfinite(a.posterior().mean.cpu().numpy()).all():
            raise AssertionError(f"4.ladder {name}: not bitwise: {same}")


def cuda_ms(fn, flush=None, reps=20):
    """Median device time of one call, from CUDA events around each call.

    The calls are queued behind a GPU spin (``torch.cuda._sleep``), so the
    host has enqueued all of them before the device reaches the first: the
    events then time the device alone, not the host's launch overhead.  If
    the spin ends before the host is done, the spin is doubled and the
    timing repeated.  ``reps`` stays small enough that every launch fits in
    the device's queue (about a thousand entries; a full queue stalls the
    host until the spin ends).  With ``flush`` the L2 is overwritten before each call
    (cold inputs); without, the inputs stay in L2 as on the main path, where
    the consensus reads the buffers the last local step just wrote."""
    import torch

    fn()
    for spin_cycles in (2 ** k * 200_000_000 for k in range(6)):  # ~0.1 s .. ~3 s
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles)
        events = []
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        queued_ahead = not events[0][0].query()
        torch.cuda.synchronize()
        if queued_ahead:
            ms = sorted(s.elapsed_time(e) for s, e in events)
            return ms[len(ms) // 2]
    raise RuntimeError("the host never queued the timed calls ahead of the GPU")


def timings(dev, counts, errs):
    """Phase 5: kernel, plain version and bound at the slice's shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import graphs
    from repro_torch.core.flat import neighbor_tables
    from repro_torch.kernels import consensus as k
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gauss_vi

    n, p = 9, P_SLICE
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)  # 128 MiB > L2
    W, mean, rho = eq6_inputs(n, p, seed=7, device=dev)
    win = gossip_windows(2)[1]  # a window with idle agents
    W_win = torch.as_tensor(win.w_eff, dtype=torch.float32, device=dev)
    act = torch.as_tensor(win.active, device=dev)
    nbr_b, wts_b = (torch.from_numpy(x).to(dev) for x in neighbor_tables(graphs.grid_w(3, 3)))
    nbr_w, wts_w = (torch.from_numpy(x).to(dev) for x in neighbor_tables(win.w_eff))
    d_b, d_w = nbr_b.shape[1], nbr_w.shape[1]
    # rows the masked CSR kernel reads: active agents' table rows, idle agents' own row
    nbr_np = nbr_w.cpu().numpy()
    rows_read = len({int(j) for i in range(n) for j in
                     (nbr_np[i] if win.active[i] else [i])})
    n_act = int(win.active.sum())
    gathered_ops = 10  # softplus, square, divide and two sums per gathered lane
    out_ops = 8  # divide, rsqrt, softplus^-1 per output lane
    eq6_bytes = 16 * n * p + 4 * n * n  # mean, rho in; mean, rho out; W
    eq6_ops = 4 * n * n * p + 20 * n * p  # two N x N contractions + per-lane math
    vi_args = (mean[0], rho[0], torch.randn(p, device=dev), mean[1], rho[1])  # mean[1]: 8B off
    validity = functools.partial(k.payload_validity_fused, mean, rho, bound=1e20)
    sample_kl = functools.partial(gauss_vi.sample_and_kl_fused, *vi_args)
    sample_kl_aligned = functools.partial(gauss_vi.sample_and_kl_fused,
                                          *(a.clone() for a in vi_args))
    launch_floor_ms = cuda_ms(lambda: torch.cuda._sleep(1))  # one launch, no work
    fp32 = FP32_FLOP_PER_S
    kernels = [  # name, source, replaces, kernel, plain, bytes, ops, peak, library, fields
        ("consensus_fused_network", "consensus_network.cu", REF + "195",
         lambda: k.consensus_fused_network(W, mean, rho),
         lambda: k.consensus_network_plain(W, mean, rho), eq6_bytes, eq6_ops, fp32, None, {}),
        ("payload_validity_fused", "payload_validity.cu", REF + "436", validity,
         lambda: k.payload_validity_plain(mean, rho, bound=1e20),
         8 * n * p + n, 20 * n * p, fp32, None,  # mean, rho in; [N] bool out
         {"device_kernels_per_call": len(captured_work(validity)),
          "variant": kernel_variant(validity), "launch_floor_ms": launch_floor_ms}),
        ("consensus_fused_masked", "consensus_network.cu", REF + "261",
         lambda: k.consensus_fused_masked(W_win, act, mean, rho),
         lambda: k.consensus_masked_plain(W_win, act, mean, rho),
         eq6_bytes + 4 * n, eq6_ops, fp32, None, {}),  # + the [N] mask
        ("consensus_fused_sparse", "consensus_sparse.cu", REF + "355",
         lambda: k.consensus_fused_sparse(nbr_b, wts_b, mean, rho),
         lambda: k.consensus_sparse_plain(nbr_b, wts_b, mean, rho),
         16 * n * p + 8 * n * d_b,  # every row read once; tables
         gathered_ops * n * d_b * p + out_ops * n * p, fp32, None, {"d": d_b}),
        ("consensus_fused_masked_sparse", "consensus_sparse.cu", REF + "529",
         lambda: k.consensus_fused_masked_sparse(nbr_w, wts_w, act, mean, rho),
         lambda: k.consensus_masked_sparse_plain(nbr_w, wts_w, act, mean, rho),
         8 * p * rows_read + 8 * n * p + 8 * n * d_w + 4 * n,  # rows read; out; tables; mask
         gathered_ops * n_act * d_w * p + out_ops * n_act * p, fp32, None,
         {"window": win.index, "n_active": n_act, "d": d_w, "rows_read": rows_read}),
        ("consensus_fused", "consensus_row.cu", REF + "131",  # one agent's row of W
         lambda: k.consensus_fused(W[0], mean, rho),
         lambda: k.consensus_row_plain(W[0], mean, rho),
         8 * n * p + 8 * p + 4 * n,  # mean, rho in; the agent's mean, rho out; w_row
         gathered_ops * n * p + out_ops * p, fp32, None, {}),
        ("sample_and_kl_fused", "gauss_vi.cu", "src/repro/kernels/gauss_vi.py:46", sample_kl,
         lambda: gauss_vi.sample_and_kl_plain(*vi_args),
         24 * p + 4,  # five [P] in, theta [P] and the KL out
         30 * p, fp32, None,  # two softplus, a log, two divisions, sample, sum per lane
         {"device_kernels_per_call": len(captured_work(sample_kl)),
          "variant": kernel_variant(sample_kl), "launch_floor_ms": launch_floor_ms,
          "aligned_variant": kernel_variant(sample_kl_aligned),
          "aligned_ms": cuda_ms(sample_kl_aligned),
          "aligned_cold_l2_ms": cuda_ms(sample_kl_aligned, flush)}),
    ]
    for shape in ATTN_SHAPES:  # the row is Qwen3-8B's; both shapes get a phase line
        q, kk, vv, window = attention_inputs(shape, dev)
        b, h, s, hd = q.shape
        mask = fa.attention_mask(s, s, True, window, dev)
        pairs = attention_pairs(s, s, True, window)
        sdpa = (functools.partial(F.scaled_dot_product_attention, q, kk, vv, attn_mask=mask)
                if window else
                functools.partial(F.scaled_dot_product_attention, q, kk, vv, is_causal=True))
        plain = functools.partial(fa.flash_attention_plain, q, kk, vv, causal=True, window=window)
        kern = functools.partial(fa.flash_attention, q, kk, vv, causal=True, window=window)
        max_ulps, n_differ = attention_ulps(kern(), plain())
        fields = {"shape": shape, "q": list(q.shape), "window": window, "pairs": pairs,
                  "kernel_device_names": device_kernels(kern, top=1),
                  "max_ulps": max_ulps, "n_differ": n_differ,
                  "library_kernels": device_kernels(sdpa),
                  "library_max_abs_err": attention_errors(f"sdpa {shape}", sdpa(), plain(),
                                                          ATT_TOL["bf16"])}
        if shape == "qwen3_8b":  # the f32 SIMT kernel, for the record
            q32, k32, v32 = q.float(), kk.float(), vv.float()
            simt = functools.partial(fa.flash_attention, q32, k32, v32, causal=True)
            fields["simt_f32_max_abs_err"] = attention_errors(
                "flash_attention f32 qwen3_8b", simt(),
                fa.flash_attention_plain(q32, k32, v32, causal=True), ATT_TOL["f32"])
            fields["simt_f32_ms"] = cuda_ms(simt)
        kernels.append((
            "flash_attention", "flash_attention_tc.cu", "src/repro/kernels/flash_attention.py:94",
            kern, plain,
            q.element_size() * 4 * b * h * s * hd,  # q, k, v in; out
            4 * hd * pairs * b * h, BF16_FLOP_PER_S, sdpa, fields))
    rows = []
    for name, src, replaces, fn, plain, nbytes, ops, peak, library, fields in kernels:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        row = {
            "name": name,
            "route": "cuda",
            "source": SRC + src,
            "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": errs[name],
            "ms": cuda_ms(fn),
            "plain_ms": cuda_ms(plain),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if library is None else cuda_ms(library),
        }
        attention = "shape" in fields
        if attention:
            fields = dict(fields, tflops=ops / row["ms"] / 1e9,
                          bound_share=row["bound_ms"] / row["ms"],
                          sdpa_over_kernel=row["library_ms"] / row["ms"])
        phase("5.timing", name=name, ms=row["ms"], plain_ms=row["plain_ms"],
              library_ms=row["library_ms"], cold_l2_ms=cuda_ms(fn, flush),
              cold_l2_plain_ms=cuda_ms(plain, flush), bound_ms=row["bound_ms"], bytes=nbytes,
              ops=ops, **fields, **({} if attention else {"n": n, "p": p}))
        if not attention or fields["shape"] == "qwen3_8b":
            rows.append(row)
    return rows


GRAPH_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
                    "event_record", "semaphore_signal", "semaphore_wait", "mem_alloc",
                    "mem_free", "batch_mem_op", "conditional")


def captured_work(fn):
    """The device work of one call of ``fn``, read without a profiler: the
    call is captured into a CUDA graph on a side stream (after one call on
    that stream, which makes the stream's arrival counter) and the graph's
    nodes are listed with the driver API.  One dict per node: its type and,
    for a kernel, its name with its template arguments and its grid."""
    import ctypes
    import re

    import torch

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUresult {err}")

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    work = []
    for node in nodes:
        node, kind = ctypes.c_void_p(node), ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        entry = {"type": (GRAPH_NODE_TYPES[kind.value] if kind.value < len(GRAPH_NODE_TYPES)
                          else str(kind.value))}
        if kind.value == 0:
            params, name = KernelNodeParams(), ctypes.c_char_p()
            check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
                  "cuGraphKernelNodeGetParams")
            if params.func:
                check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)),
                      "cuFuncGetName")
            else:
                check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)),
                      "cuKernelGetName")
            mangled = name.value.decode()
            # e.g. ..._payload_validity_cu_...23payload_validity_kernelILi0ELi4EEEvPKf...
            found = re.search(r"([A-Za-z_]+_kernel)I((?:L[a-z]+n?\d+E)+)E", mangled)
            if found:  # integer template arguments, mangled as L<type><value>E
                args = re.findall(r"L[a-z]+(n?\d+)E", found.group(2))
                mangled = f"{found.group(1)}<{', '.join(a.replace('n', '-') for a in args)}>"
            entry.update(
                name=mangled, grid=params.grid[0] * params.grid[1] * params.grid[2],
                block=params.block[0] * params.block[1] * params.block[2])
        work.append(entry)
    del graph
    return work


def device_kernels(fn, top=2):
    """The names of the device kernels that take most of one call's time
    (which backend ran), from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return [e.key[:90] for e in sorted(ks, key=lambda e: -e.self_device_time_total)[:top]]


def profile_round(tag, session, rounds=5):
    """Phase 6: the wall time of a warm round (or gossip window) of a slice
    and where its device time goes (torch.profiler, CUDA kernel events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.round()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[rounds // 2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        session.round()
        torch.cuda.synchronize()
    profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    ours = {e.key.split("::")[-1][:60]: (e.count, e.self_device_time_total / 1e3)
            for e in kernels if "repro_torch" in e.key}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    phase(tag, round_wall_ms=wall_ms, walls_ms=walls, device_ms=device_ms,
          device_busy_share=device_ms / wall_ms, profiled_wall_ms=profiled_wall_ms,
          device_launches=launches, repro_torch_kernels=ours,
          top=[(e.key[:70], e.count, e.self_device_time_total / 1e3) for e in top],
          top_host=[(e.key[:50], e.count, e.self_cpu_time_total / 1e3) for e in host])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import dispatch

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = smi_name_power()
    t0 = time.perf_counter()
    dispatch.library()
    phase("1.device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
          kind=torch.cuda.get_device_name(0), library_build_s=time.perf_counter() - t0,
          nvcc_s=dispatch.build_info.get("seconds"), library=dispatch.build_info.get("path"))
    for line in dispatch.build_info.get("ptxas", "").splitlines():
        if any(w in line for w in ("registers", "Compiling", "spill", "Performance Loss")):
            print("ptxas", line.strip())

    errs = check_kernels(dev)
    errs.update(check_ops_kernels(dev))
    session, counts, prior = run_slice(dev)
    gossip = run_gossip(dev)
    g_session, g_counts = gossip["3.gossip"]
    csr_counts = run_csr(dev, g_session)
    ops_counts = run_ops(dev, session, prior)
    card_vs_cpu("4.parity", session, fig4_spec())
    card_vs_cpu("4.gossip_parity", g_session, gossip_spec())
    ladders(dev)
    launches = {  # each kernel's launches on the path that runs it
        "consensus_fused_network": counts["consensus_fused_network"],
        "payload_validity_fused": g_counts["payload_validity_fused"],
        "consensus_fused_masked": g_counts["consensus_fused_masked"],
        "consensus_fused_sparse": csr_counts["consensus_fused_sparse"],
        "consensus_fused_masked_sparse": csr_counts["consensus_fused_masked_sparse"],
        "consensus_fused": ops_counts["consensus_fused"],
        "sample_and_kl_fused": ops_counts["sample_and_kl_fused"],
        "flash_attention": ops_counts["flash_attention"],
    }
    rows = timings(dev, launches, errs)
    profile_round("6.profile", session)
    profile_round("6.gossip_profile", g_session)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
