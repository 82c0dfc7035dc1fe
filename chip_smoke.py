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
   buffers with NaN, +-inf, huge and f16-overflowing lanes planted;
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
   quarantined consensus, and ``consensus_flat_sparse`` on the base W;
4. card vs CPU: one more synchronous round and one more gossip window from
   the same state with the same injected batches and noise, the card through
   the kernels, the CPU through the plain versions; and the equivalence
   ladder on the card, bitwise: all-edges gossip == synchronous, zero-fault
   quarantine == strict;
5. timings: each kernel's median time over warm launches (CUDA events), with
   its inputs in L2 and with L2 flushed, its plain version's, and its bound
   at the slice's shapes;
6. profile: the wall time of a warm synchronous round and of a warm gossip
   window of the slice, and their device time by kernel (torch.profiler).

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
    return session, counts


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

    from repro_torch.core import graphs
    from repro_torch.core.flat import neighbor_tables
    from repro_torch.kernels import consensus as k

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
    kernels = [
        ("consensus_fused_network", "consensus_network.cu", "195",
         lambda: k.consensus_fused_network(W, mean, rho),
         lambda: k.consensus_network_plain(W, mean, rho), eq6_bytes, eq6_ops),
        ("payload_validity_fused", "payload_validity.cu", "436",
         lambda: k.payload_validity_fused(mean, rho, bound=1e20),
         lambda: k.payload_validity_plain(mean, rho, bound=1e20),
         8 * n * p + n, 20 * n * p),  # mean, rho in; [N] bool out
        ("consensus_fused_masked", "consensus_network.cu", "261",
         lambda: k.consensus_fused_masked(W_win, act, mean, rho),
         lambda: k.consensus_masked_plain(W_win, act, mean, rho),
         eq6_bytes + 4 * n, eq6_ops),  # + the [N] mask
        ("consensus_fused_sparse", "consensus_sparse.cu", "355",
         lambda: k.consensus_fused_sparse(nbr_b, wts_b, mean, rho),
         lambda: k.consensus_sparse_plain(nbr_b, wts_b, mean, rho),
         16 * n * p + 8 * n * d_b,  # every row read once; tables
         gathered_ops * n * d_b * p + out_ops * n * p),
        ("consensus_fused_masked_sparse", "consensus_sparse.cu", "529",
         lambda: k.consensus_fused_masked_sparse(nbr_w, wts_w, act, mean, rho),
         lambda: k.consensus_masked_sparse_plain(nbr_w, wts_w, act, mean, rho),
         8 * p * rows_read + 8 * n * p + 8 * n * d_w + 4 * n,  # rows read; out; tables; mask
         gathered_ops * n_act * d_w * p + out_ops * n_act * p),
    ]
    rows = []
    for name, src, line, fn, plain, nbytes, ops in kernels:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        row = {
            "name": name,
            "route": "cuda",
            "source": SRC + src,
            "replaces": REF + line,
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
              bound_ms=row["bound_ms"], bytes=nbytes, ops=ops,
              **({"d": d_b} if name == "consensus_fused_sparse" else {}),
              **({"window": win.index, "n_active": n_act, "d": d_w, "rows_read": rows_read}
                 if name == "consensus_fused_masked_sparse" else {}))
        rows.append(row)
    return rows


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
        if "registers" in line or "Compiling" in line or "spill" in line:
            print("ptxas", line.strip())

    errs = check_kernels(dev)
    session, counts = run_slice(dev)
    gossip = run_gossip(dev)
    g_session, g_counts = gossip["3.gossip"]
    csr_counts = run_csr(dev, g_session)
    card_vs_cpu("4.parity", session, fig4_spec())
    card_vs_cpu("4.gossip_parity", g_session, gossip_spec())
    ladders(dev)
    launches = {  # each kernel's launches on the path that runs it
        "consensus_fused_network": counts["consensus_fused_network"],
        "payload_validity_fused": g_counts["payload_validity_fused"],
        "consensus_fused_masked": g_counts["consensus_fused_masked"],
        "consensus_fused_sparse": csr_counts["consensus_fused_sparse"],
        "consensus_fused_masked_sparse": csr_counts["consensus_fused_masked_sparse"],
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
