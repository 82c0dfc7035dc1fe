#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failed phase raises and the script exits non-zero):

1. device: the card's name and power limit, torch and CUDA versions, and the
   build of the kernel library from ``src/repro_torch/kernels/csrc/*.cu``;
2. every kernel against its plain PyTorch version on the card:
   ``consensus_fused_network`` at (N, P) = (9, 199210), (300, 4099), (1, 5)
   and wire f32/bf16/f16; ``payload_validity_fused`` bit-equal on buffers
   with NaN, +-inf, huge and f16-overflowing lanes planted in chosen agents;
3. the slice at full width: the paper's Fig. 4 setting (3x3 grid, 9 agents,
   ``mnist_like`` 784-dim 10-class data, grid partition, the 784-200-200-10
   Bayes-by-Backprop MLP, P = 199,210 per agent, batch 16, u = 4) through
   ``build_session -> run(3) -> evaluate() -> health()`` on the card, with
   the launch counters set to 0 just before and read just after;
4. card vs CPU: one more round from the same state with the same injected
   batches and noise, the card through the kernels, the CPU through the
   plain versions;
5. timings: each kernel's median time over warm launches (CUDA events), with
   its inputs in L2 and with L2 flushed, its plain version's, and its bound
   at the slice's shapes;
6. profile: the wall time of a warm round of the slice and its device time
   by kernel (torch.profiler).

The last lines are the card's ``nvidia-smi`` name and power limit, one JSON
line describing the kernels, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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

FIG4 = dict(
    dataset="mnist_like",
    dataset_params=dict(dim=784, n_classes=10),
    partition="grid",
    partition_params=dict(type1_labels=list(range(2, 10)), type2_labels=[0, 1],
                          type1_position=4),
    batch_size=16,
    local_updates=4,
)


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
        inference=InferenceSpec(hidden=200, depth=2),
        run=RunSpec(n_rounds=3, seed=0),
    )


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


def check_kernels(dev):
    """Phase 2: every kernel against its plain version on the card."""
    import torch

    from repro_torch.kernels import consensus as k

    worst = {}
    for (n, p) in [(9, 199_210), (300, 4_099), (1, 5)]:
        for wire in ("f32", "bf16", "f16"):
            W, mean, rho = eq6_inputs(n, p, seed=n + p, device=dev)
            got = k.consensus_fused_network(W, mean, rho, wire_dtype=wire)
            want = k.consensus_network_plain(W, mean, rho, wire)
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
                    raise AssertionError(
                        f"consensus_fused_network N={n} P={p} wire={wire}: "
                        f"max err {float(err.max())} beyond tolerance"
                    )
                errs.append(float(err.max()))
            phase("2.consensus", n=n, p=p, wire=wire, max_abs_err_mean=errs[0],
                  max_abs_err_rho=errs[1])
            if (n, p, wire) == (9, 199_210, "f32"):
                worst["consensus_fused_network"] = max(errs)
    expect = {"f32": [True, False, False, False, False, True, False, True, True],
              "bf16": [True, False, False, False, False, True, False, True, True],
              "f16": [True, False, False, False, False, False, False, True, True]}
    for wire in ("f32", "bf16", "f16"):
        mean, rho = poisoned(9, 199_210, seed=3, device=dev)
        got = k.payload_validity_fused(mean, rho, bound=1e20, wire_dtype=wire)
        want = k.payload_validity_plain(mean, rho, bound=1e20, wire_dtype=wire)
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want.cpu()) or got.cpu().tolist() != expect[wire]:
            raise AssertionError(f"payload_validity_fused wire={wire}: {got.tolist()} vs "
                                 f"plain {want.tolist()}, expected {expect[wire]}")
        phase("2.validity", wire=wire, ok=got.cpu().tolist(), bit_equal=True)
    worst["payload_validity_fused"] = 0.0
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
    if p != 199_210:
        raise AssertionError(f"P = {p}, expected 199210 for 784-200-200-10")
    if not np.all(np.isfinite(losses)) or not np.isfinite(session.posterior().mean.cpu()).all():
        raise AssertionError(f"non-finite losses or posterior: {losses}")
    if not health["all_ok"]:
        raise AssertionError(f"health(): {health}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {counts}")
    phase("3.slice", agents=session.data.n_agents, n_params=p, losses=losses,
          avg_acc=ev["avg_acc"], acc=ev["acc"], health=health["n_healthy"],
          launches=counts, setup_s=setup_s, run3_s=run_s)
    return session, counts


def parity(session):
    """Phase 4: one round on the card and on the CPU from the same state with
    the same injected draws."""
    import torch

    from repro_torch.api import build_session

    cpu = build_session(fig4_spec(), device="cpu")
    cpu.state = session.state.to("cpu")
    cpu.round_idx = session.round_idx
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
    W = torch.as_tensor(cpu.spec.topology.w_schedule()(0), dtype=torch.float32)
    exempt = ((W > 0).float() @ noise.float()) > 0  # lanes consensus mixes noise into
    errs, exempt_errs = {}, {}
    for name, x, y in [("mean", a.posterior.mean, c.posterior.mean),
                       ("rho", a.posterior.rho, c.posterior.rho),
                       ("adam_mu_mean", a.opt_state.mu.mean, c.opt_state.mu.mean),
                       ("adam_mu_rho", a.opt_state.mu.rho, c.opt_state.mu.rho)]:
        d = (x - y).abs()
        errs[name] = float(torch.where(exempt, 0.0, d).max())
        exempt_errs[name] = float(torch.where(exempt, d, 0.0).max())
    loss_rel = float(abs(rec_card["losses"] - rec_cpu["losses"]).max()
                     / abs(rec_cpu["losses"]).max())
    phase("4.parity", max_abs_err=errs, loss_max_rel_err=loss_rel, atol=PARITY_ATOL,
          rtol=PARITY_RTOL, noise_lanes=int(noise.sum()), exempt_lanes=int(exempt.sum()),
          lanes=n * p, exempt_max_abs_err=exempt_errs)
    if max(errs.values()) > PARITY_ATOL or loss_rel > PARITY_RTOL:
        raise AssertionError("card vs CPU round disagree beyond tolerance")


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

    from repro_torch.kernels import consensus as k

    n, p = 9, 199_210
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)  # 128 MiB > L2
    W, mean, rho = eq6_inputs(n, p, seed=7, device=dev)
    eq6_bytes = 16 * n * p + 4 * n * n  # mean, rho in; mean, rho out; W
    eq6_ops = 4 * n * n * p + 20 * n * p  # two N x N contractions + per-lane math
    val_bytes = 8 * n * p + n  # mean, rho in; [N] bool out
    val_ops = 20 * n * p
    rows = []
    for name, fn, plain, nbytes, ops in [
        ("consensus_fused_network",
         lambda: k.consensus_fused_network(W, mean, rho),
         lambda: k.consensus_network_plain(W, mean, rho), eq6_bytes, eq6_ops),
        ("payload_validity_fused",
         lambda: k.payload_validity_fused(mean, rho, bound=1e20),
         lambda: k.payload_validity_plain(mean, rho, bound=1e20), val_bytes, val_ops),
    ]:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        row = {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      + ("consensus_network.cu" if name.startswith("consensus")
                         else "payload_validity.cu"),
            "replaces": "src/repro/kernels/consensus.py:"
                        + ("195" if name.startswith("consensus") else "436"),
            "launches": counts[name],
            "max_abs_err": errs[name],
            "ms": cuda_ms(fn),
            "plain_ms": cuda_ms(plain),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
        phase("5.timing", name=name, n=n, p=p, ms=row["ms"], plain_ms=row["plain_ms"],
              cold_l2_ms=cuda_ms(fn, flush), cold_l2_plain_ms=cuda_ms(plain, flush),
              bound_ms=row["bound_ms"], bytes=nbytes, ops=ops)
        rows.append(row)
    return rows


def profile_round(session, rounds=5):
    """Phase 6: the wall time of a warm round of the slice and where its
    device time goes (torch.profiler, CUDA kernel events only)."""
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        session.round()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    consensus_ms = sum(e.self_device_time_total for e in kernels
                       if "consensus_network_kernel" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    phase("6.profile", round_wall_ms=wall_ms, device_ms=device_ms,
          device_busy_share=device_ms / wall_ms, device_launches=launches,
          consensus_ms=consensus_ms,
          top=[(e.key[:70], e.count, e.self_device_time_total / 1e3) for e in top])


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
        if "registers" in line or "Compiling" in line or "spill" in line:
            print("ptxas", line.strip())

    errs = check_kernels(dev)
    session, counts = run_slice(dev)
    parity(session)
    rows = timings(dev, counts, errs)
    profile_round(session)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
