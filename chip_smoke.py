#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --timings   # phases 1, 5 and 6 only, no checks

``--timings`` times the kernels and a synchronous round of the tree the
script sits in, so a copy of this script in another tree (an earlier
commit's ``git archive``) times that tree's kernels by the same clock.

Phases, one line each (a failed phase raises and the script exits non-zero):

1. device: the card's name and power limit, torch and CUDA versions, and the
   build of the kernel library from ``src/repro_torch/kernels/csrc/*.cu``;
2. every kernel against its plain PyTorch version on the card, at wire
   f32/bf16/f16: ``consensus_fused_network`` and ``consensus_fused_masked``
   at (N, P) = (9, 199210), (300, 4099), (1, 5), the masked kernel with
   masks all-true, all-false and mixed and its active rows bitwise the
   network kernel's; ``consensus_fused_sparse`` and
   ``consensus_fused_masked_sparse`` on the CSR tables of the 3x3 grid
   (D = 5) and of three gossip windows at P = 199210, of N = 300 ring and
   Watts-Strogatz graphs, and of a 70,000-agent ring at P = 3; the dense
   small-N path bitwise the generic one and the CSR staged path bitwise
   the gather one wherever both can run; every eq. (6) line names the
   kernel instance that ran; ``payload_validity_fused`` bit-equal on
   buffers with NaN, +-inf, huge and f16-overflowing lanes planted, aligned
   and as views 4 and 8 bytes off 16-byte alignment, and at N = 70,000,
   P = 3 (each line names the kernel instance that ran, read from a CUDA
   graph of one call); the kernels of
   ``kernels.ops``: ``consensus_fused`` at (N, P) = (9, 199210), (300,
   4099), (1, 5) with zero weights in the row, its planned instance bitwise
   its generic one at each, ``sample_and_kl_fused`` at
   P = 199210, 2049, 5 and on views 16, 8 and 4 bytes aligned (theta
   bitwise the plain version's, the KL bitwise the same twice and on an
   aligned copy), and
   ``flash_attention`` on tests/test_kernels.py's sweep at f32, bf16 and
   f16 (bf16/f16 on the tensor-core kernel, f32 on the SIMT kernel), at
   every head dim 32-256 on ragged tiles at bf16 and f16, on a case
   with Sk < S whose window leaves rows with no key (zeros) at each dtype,
   and at B = 70,000 or H = 70,000 (S = 64, hd = 32) at f32 and bf16;
   ``consensus_fused_segments`` at every wire dtype on the term lists the
   paths build: the delayed slice's window 4 (N = 9, P = 199,210, a K = 4
   ring at f32, bf16 and f16), the same with fill rows after the posterior
   (the corrupted senders' layout), an edge-native window of the N = 4,200
   clock below with fill rows at P = 1,024 and at the full P = 199,210
   that ``3.sparse`` runs, and one of the N = 10,000 cell (P = 90), two
   launches bitwise equal, bitwise PR 19's lane kernel and the tile kernel
   at one lane a thread, one device kernel a call;
3. the paths at full width, each with the launch counters set to 0 just
   before and read just after.  The synchronous slice: the paper's Fig. 4
   setting (3x3 grid, 9 agents, ``mnist_like`` 784-dim 10-class data, grid
   partition, the 784-200-200-10 Bayes-by-Backprop MLP, P = 199,210 per
   agent, batch 16, u = 4) through ``build_session -> run(3) -> evaluate()
   -> health()``.  ``3.launch``: the same spec on the production launch
   engine (``RunSpec(engine="launch")``, ``launch.steps``), 3 rounds,
   against the synchronous slice of the same seed (atol/rtol 1e-5,
   accuracies 1e-6; whether bitwise is printed), with the per-round wall
   time; ``3.launch_checkpoint``: that session saved and loaded on the card
   and the CPU (its leaves a ``BayesTrainState``'s, the 0-d int32 step),
   one more round bitwise.  ``3.serve``: f32 and bf16 snapshots of the
   slice (14,343,120 and 7,171,560 bytes, exactly ``launch.costmodel
   .serve_roofline``'s ``snapshot_hbm_bytes``; its modeled publish and
   apply µs printed beside the measured ones), a ragged request stream over the
   buckets (1, 2, 4, 8, 16, 32) at mc 8 and 0 across the agents through the
   ``PredictiveServer`` (one CUDA-graph capture per key; captures equal to
   the keys the stream touched, none added by a republish or a replay),
   the served probabilities against ``mc_predict`` and the point estimate
   on the same noise (1e-5), against the CPU's (1e-5) and, bf16-resident,
   against the f32 snapshot's (5e-2), the staleness SLO under the flag and
   strict policies, p50/p99 latency per call, publish ms, the device memory
   the graphs hold.  The gossip slice: the same data and model on
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
   hd = 256, window 2048, K/V repeated from 1 head).  The delayed slice
   (``3.delayed*``): the gossip slice behind geometric delivery latency
   (p = 0.5, at most 3 windows: a K = 4 slot history ring) under the chaos
   faults, quarantine, strict and quarantine with a bf16 ring, 4 windows
   each, the ring's bytes (exactly half at bf16), and both quarantined
   rings saved, loaded and resumed two windows, bitwise.  ``3.sparse``:
   edge-native windows at N = 4,200 (above SPARSE_DENSE_GUARD = 4096),
   Watts-Strogatz k = 6, beta = 0.1, Poisson rate 0.05, chaos faults,
   quarantine, ``mnist_like`` 784-dim data iid (16 rows an agent), the
   784-200-200-10 model: 3 windows and ``evaluate()``, every tensor shape of
   the third window recorded (none has two dimensions equal to N), the
   dense view refused, the peak device memory, and ``obs.network_stats``
   once on the N = 4,200 posterior after the timed windows (its ms, and
   its column chunks' extra device memory: at most 2 GiB).  ``3.obs``: the
   synchronous slice with ``ObsSpec(enabled=True)`` (spans, convergence, a
   JSONL sink), 3 rounds, a snapshot, an attached server's queries,
   ``evaluate()`` and ``dashboard()``: the eight session and serving spans
   present, the first round the compile bucket's (n = 1, warm n = 2), span
   and counter events in the JSONL file, the convergence report's theory
   rate the grid's ``consensus_contraction_rate``; the dashboard, the
   spans' p50s and the round p50 beside ``3.slice``'s round wall ms.
   ``3.obs_gossip``: the gossip slice with observability on, 4 windows:
   ``gossip.windows`` 4, the ``gossip.jit_traces`` gauge equal to the
   engine's ``n_traces`` (1), four ``gossip.window`` spans (masked), and
   the window p50's ``window_attainment`` against the cost model's
   ``window_masked`` roofline.  ``3.sparse_1e4``: the
   reference's ``engine_sparse`` cell (N = 10,000, P = 90), 3 windows,
   ``evaluate()``, save -> load -> one resumed window, bitwise;
4. card vs CPU: one more synchronous round and one more gossip window from
   the same state with the same injected batches and noise, the card through
   the kernels, the CPU through the plain versions, and likewise one more
   delayed window and one more edge-native window (the slice's data on a
   9-agent Watts-Strogatz graph), and the quarantined segments consensus
   alone on the post-local posterior of an iid 16-agent edge-native
   session (``4.sparse_iid_consensus``) and that session's whole window
   (``4.sparse_iid_parity``), and one more launch-engine round
   (``4.launch_parity``).  Each card-vs-CPU round exempts Adam's noise
   lanes (``adam_noise_lanes``: the two devices' moments apart by more than
   rounding of a well-set gradient explains) and the lanes consensus mixes
   them into from PARITY_ATOL on the posterior, holds them to the 2 u lr
   their Adam steps allow, and fails past EXEMPT_SHARE_MAX of the lanes
   exempt; and the equivalence ladder on the card,
   bitwise: all-edges gossip == synchronous, zero-fault quarantine ==
   strict (instant, delayed and edge-native windows), latency 0 == instant
   (no ring), one delayed window run twice from one state, and a round
   with a server attached (snapshots published, queries served) == the
   round without (``serve_attached==detached``, the generators too), and
   the synchronous and gossip slices with observability on against off
   (``obs_on==obs_off``: every state leaf, so every checkpoint leaf, and
   the generators);
   then the checkpoint, linreg and discrete paths (phase tags 3.*, each with
   the launch counters set to 0 around its run): ``3.checkpoint``, the
   synchronous slice saved after ``run(3)`` and ``Session.load``-ed on the
   card, every state leaf bitwise, one more round on both sessions bitwise
   (the generator's state rides in the file), and the file loaded on the CPU
   bitwise the card's, with the file's bytes and the save and load seconds;
   ``3.gossip_checkpoint``, the same for the chaos + quarantine gossip
   slice after ``run(4)``, two more windows on each; ``3.linreg``, paper
   Example 1 (``TopologySpec.complete(4)``, ``linreg`` batches of 10, the
   conjugate engine, 60 rounds, seed 0) to the noise floor, card against CPU
   on injected per-round seeds, and its ``FullCovGaussian`` state through
   save/load bitwise; ``3.discrete``, the finite-Theta rule
   (``core.discrete.run_social_learning``) at tests/test_discrete.py's
   rate setting with injected log-likelihoods, card against CPU, and the
   wrong belief's decay rate beside ``theory.rate_K``;
5. timings: each kernel's median time over warm launches (CUDA events), with
   its inputs in L2 and with L2 flushed (``Flush``: by overwriting a
   128 MiB buffer, which leaves L2 dirty, and by reading it, which leaves L2
   clean), less the launch floor, its plain version's, and its bound
   at the slice's shapes (``consensus_fused`` and ``sample_and_kl_fused`` at
   one agent's P = 199,210, ``flash_attention`` at both head shapes above,
   beside ``scaled_dot_product_attention``'s time and backend, with its
   TFLOP/s, share of the bound, ratio to SDPA and largest error in output
   ulps, and the f32 SIMT kernel's time at the Qwen3-8B heads); for
   ``consensus_fused_segments`` on the delayed slice's window 4, and on a
   line of its own at N = 4,200 and full width (phase 2's
   ``sparse_4200_full`` terms), each beside PR 19's lane kernel; for
   the single-kernel wrappers (the six eq. (6) kernels,
   ``payload_validity_fused``, ``sample_and_kl_fused``) also the device
   operations one call runs (which must be one) and its kernel instance
   (both read from a CUDA graph of one call, not from a profiler), the
   instance's registers and spills as ptxas reported them, and the launch
   floor (a one-cycle ``torch.cuda._sleep`` under the same timer), which
   every row's time less the floor and its share of the bound on that
   basis take out; rows ``consensus_fused_network`` and
   ``consensus_fused_masked`` also print ``costmodel_bound_ms``, the cost
   model's ``flat_fused`` roofline, which agrees with ``bound_ms`` within
   0.1% (the hand-written bound adds W's 4 N^2 bytes);
6. profile: the wall time of a warm synchronous round, of a warm gossip
   window, of a warm delayed window of the slice and of a warm edge-native
   window at N = 4,200 and of a warm launch-engine round, and their device
   time by kernel (torch.profiler).

The last lines are the card's ``nvidia-smi`` name and power limit, one JSON
line describing the kernels, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks: HBM and dense bf16 from the port's one home for
# them (launch/mesh.py, no torch import); 67 TFLOP/s fp32 outside the tensor cores
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_FLOP_PER_S  # noqa: E402

FP32_FLOP_PER_S = 67e12

# stated tolerances
F32_TOL = 1e-5            # kernel vs cuBLAS/plain, fp32 reduction order
WIRE_EPS = {"bf16": 2.0 ** -7, "f16": 2.0 ** -10}  # one wire ulp
PARITY_ATOL = 1e-4        # card vs CPU round: posterior and Adam first moment
PARITY_RTOL = 1e-4        # card vs CPU round: losses
# Adam's noise lanes (ROADMAP C.3).  Adam's step, -lr m^ / (sqrt(v^) + eps),
# does not depend on the gradient's scale: a gradient made of rounding noise
# (a ReLU unit no sample activates, a KL term at q == prior) takes a step as
# large as a real one, and its sign differs between two fp32 programs.  The
# card and the CPU start the round from one state and take its u steps on
# the same draws, so where a lane's gradients are set to fp32 accuracy its
# moments m, v agree to a few ulps (the gradient's condition number times
# 2^-24).  A lane is noise where they do not: |m_card - m_cpu| above
# ADAM_NOISE_GAP sqrt(v) or |v_card - v_cpu| above ADAM_NOISE_GAP v (v the
# larger of the two): a gradient that lost all but 10 of its 24 bits.  On
# any other lane the two devices' u Adam steps differ by about
# u lr ADAM_NOISE_GAP (Adam's step is about lr at most: |m^| <= sqrt(v^)
# while the gradient's size holds steady), 2e-5 at u = 4, lr = 5e-3: under
# PARITY_ATOL.
ADAM_NOISE_GAP = 1e-3
# The noise lanes and the lanes consensus mixes them into are exempt from
# PARITY_ATOL on the posterior (mean, rho), not unbounded: there the two
# devices differ by at most their u Adam steps of about lr each, in opposite
# directions, averaged by consensus with weights that sum to 1, so by at
# most 2 u lr (exempt_atol).  The Adam first moment, which consensus does
# not touch and whose noise is tiny in absolute terms, is held to
# PARITY_ATOL on every lane.  A phase fails if more than EXEMPT_SHARE_MAX of
# its lanes are exempt: a wrong gradient moves many lanes.
EXEMPT_SHARE_MAX = 0.01

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
# the gossip slice's clock behind geometric delivery latency (K = 4 ring slots)
DELAYED_CLOCK = {"kind": "delayed", "inner": GOSSIP_CLOCK,
                 "latency": {"kind": "geometric", "p": 0.5, "max": 3}}
SPARSE_N = 4_200  # agents: above SPARSE_DENSE_GUARD = 4096, so no dense view can hide
SPARSE_CLOCK = {"kind": "poisson", "rate": 0.05, "seed": 3}
SEG_SMALL_P = 1_024  # phase 2's N = 4,200 case
STATS_EXTRA_MAX = 2 << 30  # network_stats' temporaries at N = 4,200, full width
COSTMODEL_RTOL = 1e-3  # phase 5 rows 1, 3: the hand bound adds W's 4 N^2 (+ N) bytes
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
LINREG_ROUNDS = 60  # tests/test_api.py:262
LINREG_MEAN_TOL = (1e-5, 1e-6)  # (rtol, atol): tests/test_torch_linreg.py
LINREG_PREC_TOL = 1e-6  # of sqrt(prec_ii * prec_jj): tests/test_torch_linreg.py
DISCRETE_TOL = (1e-6, 1e-5)  # (rtol, atol) on log-beliefs: tests/test_torch_discrete.py
LAUNCH_TOL = (1e-5, 1e-5)  # (rtol, atol) launch vs simulated posterior: tests/test_api.py:46
LAUNCH_ACC_ATOL = 1e-6  # launch vs simulated accuracies: tests/test_api.py:76
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)  # serve.DEFAULT_BUCKETS
SERVE_SIZES = [1, 3, 7, 12, 20, 33, 64, 5, 2, 17, 9, 30]  # a ragged stream's request rows
SERVE_ATOL = 1e-5  # served vs mc_predict, card vs CPU: fp32 sums in another order
SERVE_BF16_ATOL = 5e-2  # bf16- vs f32-resident snapshot's probabilities: tests/test_serve.py:172
SNAPSHOT_F32_BYTES = 2 * 9 * P_SLICE * 4  # mean and rho of 9 agents: 14,343,120
WIRES = ("f32", "bf16", "f16")
N_BEYOND_GRID = 70_000  # agents (or attention heads) past a grid dimension's 65,535
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


def launch_spec():
    """The synchronous slice on the production launch engine."""
    spec = fig4_spec()
    return dataclasses.replace(spec, run=dataclasses.replace(spec.run, engine="launch"))


def gossip_spec(policy="quarantine", faults=True, clock=None, **inf):
    from repro_torch.api import DataSpec, ExperimentSpec, InferenceSpec, RunSpec, TopologySpec

    clock = dict(clock or GOSSIP_CLOCK, **({"faults": CHAOS} if faults else {}))
    return ExperimentSpec(
        topology=TopologySpec.gossip("grid", {"rows": 3, "cols": 3}, clock=clock),
        data=DataSpec(**FIG4),
        inference=InferenceSpec(hidden=HIDDEN, depth=2, fault_policy=policy, **inf),
        run=RunSpec(n_rounds=4, seed=0),
    )


def sparse_spec(n=SPARSE_N, policy="quarantine", faults=True):
    """The edge-native path at full width: a Watts-Strogatz graph (k = 6,
    beta = 0.1) under a thinned-Poisson edge clock, ``mnist_like`` 784-dim
    10-class data split iid with at least 16 rows an agent, the
    784-200-200-10 model, batch 16, u = 4."""
    from repro_torch.api import DataSpec, ExperimentSpec, InferenceSpec, RunSpec, TopologySpec

    clock = dict(SPARSE_CLOCK, **({"faults": CHAOS} if faults else {}))
    return ExperimentSpec(
        topology=TopologySpec.sparse("watts_strogatz", n=n, k=6, beta=0.1, seed=1, clock=clock),
        data=DataSpec(dataset="mnist_like",
                      dataset_params=dict(dim=784, n_classes=10,
                                          n_train_per_class=max(600, -(-16 * n // 10))),
                      partition="iid", partition_params=dict(n_agents=n), batch_size=16,
                      local_updates=4),
        inference=InferenceSpec(hidden=HIDDEN, depth=2, fault_policy=policy),
        run=RunSpec(n_rounds=3, seed=0),
    )


def sparse_slice_spec(policy="quarantine", faults=True):
    """The gossip slice's data and model on an edge-native topology: a
    9-agent Watts-Strogatz graph (k = 4, beta = 0.1) under a Poisson edge
    clock (rate 0.8), the card-vs-CPU check's and the ladder's sparse
    session."""
    from repro_torch.api import DataSpec, ExperimentSpec, InferenceSpec, RunSpec, TopologySpec

    clock = {"kind": "poisson", "rate": 0.8, "seed": 0, **({"faults": CHAOS} if faults else {})}
    return ExperimentSpec(
        topology=TopologySpec.sparse("watts_strogatz", n=9, k=4, beta=0.1, seed=1, clock=clock),
        data=DataSpec(**FIG4),
        inference=InferenceSpec(hidden=HIDDEN, depth=2, fault_policy=policy),
        run=RunSpec(n_rounds=4, seed=0),
    )


def sparse_1e4_spec():
    """The ``engine_sparse`` cell of BENCH_gossip.json
    (benchmarks/bench_gossip.py:591-618): N = 10,000, Watts-Strogatz k = 6,
    beta = 0.1, Poisson rate 0.05, e_max = 8192, the 8-8-2 model (P = 90)."""
    from repro_torch.api import DataSpec, ExperimentSpec, InferenceSpec, RunSpec, TopologySpec

    n = 10_000
    return ExperimentSpec(
        topology=TopologySpec.sparse("watts_strogatz", n=n, k=6, beta=0.1, seed=1,
                                     clock=dict(SPARSE_CLOCK, e_max=8192)),
        data=DataSpec(dataset_params=dict(n_classes=2, dim=8, n_train_per_class=n, seed=0),
                      partition="iid", partition_params=dict(n_agents=n), batch_size=2,
                      local_updates=1),
        inference=InferenceSpec(hidden=8, depth=1, lr=1e-2),
        run=RunSpec(n_rounds=3, seed=0),
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
    from repro_torch.kernels import launch_plan

    worst = {}
    for (n, p) in [(9, P_SLICE), (300, 4_099), (1, 5)]:
        for wire in WIRES:
            W, mean, rho = eq6_inputs(n, p, seed=n + p, device=dev)
            got = k.consensus_fused_network(W, mean, rho, wire_dtype=wire)
            want = k.consensus_network_plain(W, mean, rho, wire)
            errs = eq6_errors(f"consensus_fused_network N={n} P={p}", got, want, wire)
            generic = {}
            if launch_plan.dense_instance(n):  # both paths can run: the same bits
                generic = {"generic_bitwise": eq6_same_bits(
                    f"consensus_fused_network N={n} P={p} wire={wire} generic", got,
                    k._network_launch("consensus_fused_network", W, None, mean, rho, wire,
                                      instance=0))}
            phase("2.consensus", n=n, p=p, wire=wire, max_abs_err_mean=errs[0],
                  max_abs_err_rho=errs[1], **generic, variant=kernel_variant(
                      lambda: k.consensus_fused_network(W, mean, rho, wire_dtype=wire)))
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
                fields = {"variant": kernel_variant(
                    lambda: k.consensus_fused_masked(W, active, mean, rho, wire_dtype=wire))}
                if mask == "mixed" and launch_plan.dense_instance(n):
                    fields["generic_bitwise"] = eq6_same_bits(
                        f"consensus_fused_masked N={n} P={p} wire={wire} generic", got_m,
                        k._network_launch("consensus_fused_masked", W, active, mean, rho,
                                          wire, instance=0))
                phase("2.masked", n=n, p=p, wire=wire, mask=mask, max_abs_err_mean=errs[0],
                      max_abs_err_rho=errs[1], active_rows_bitwise_network=True, **fields)
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
            got_s = k.consensus_fused_sparse(nbr, wts, mean, rho, wire_dtype=wire)
            errs = eq6_errors(f"consensus_fused_sparse {name}", got_s,
                              k.consensus_sparse_plain(nbr, wts, mean, rho, wire), wire)
            got_m = k.consensus_fused_masked_sparse(nbr, wts, active, mean, rho, wire_dtype=wire)
            errs_m = eq6_errors(f"consensus_fused_masked_sparse {name}", got_m,
                                k.consensus_masked_sparse_plain(nbr, wts, active, mean, rho,
                                                                wire), wire)
            if not (torch.equal(got_m[0][~active], mean[~active])
                    and torch.equal(got_m[1][~active], rho[~active])):
                raise AssertionError(f"consensus_fused_masked_sparse {name}: inactive rows "
                                     "not passed through")
            fields = {"variant": kernel_variant(functools.partial(
                k.consensus_fused_sparse, nbr, wts, mean, rho, wire_dtype=wire)),
                "masked_variant": kernel_variant(functools.partial(
                    k.consensus_fused_masked_sparse, nbr, wts, active, mean, rho,
                    wire_dtype=wire))}
            if launch_plan.sparse_staged(n):  # both paths can run: the same bits
                for tag, act, out in (("sparse", None, got_s), ("masked", active, got_m)):
                    name_k = "consensus_fused_masked_sparse" if act is not None else \
                        "consensus_fused_sparse"
                    fields[f"{tag}_gather_bitwise"] = eq6_same_bits(
                        f"{name_k} {name} wire={wire} gather", out,
                        k._sparse_launch(name_k, nbr, wts, act, mean, rho, wire, staged=False))
            phase("2.sparse", tables=name, n=n, d=d, p=p, wire=wire,
                  n_active=int(active.sum()), max_abs_err=max(errs),
                  masked_max_abs_err=max(errs_m), **fields)
            if wire == "f32" and name == "grid_base":
                worst["consensus_fused_sparse"] = max(errs)
            if wire == "f32" and name == "window1":
                worst["consensus_fused_masked_sparse"] = max(errs_m)
    n, p = N_BEYOND_GRID, 3  # more agents than a grid dimension holds: the flat walk
    nbr, wts = (torch.from_numpy(x).to(dev)
                for x in graphs.bidirectional_ring_sparse(n).neighbor_tables())
    g = torch.Generator(device=dev).manual_seed(n)
    mean = torch.randn((n, p), generator=g, device=dev)
    rho = torch.rand((n, p), generator=g, device=dev) * 5.0 - 4.5
    active = torch.arange(n, device=dev) % 5 != 3
    for wire in WIRES:  # the plain versions build the dense 70,000^2 W (19.6 GB)
        errs = eq6_errors(f"consensus_fused_sparse N={n}",
                          k.consensus_fused_sparse(nbr, wts, mean, rho, wire_dtype=wire),
                          k.consensus_sparse_plain(nbr, wts, mean, rho, wire), wire)
        got_m = k.consensus_fused_masked_sparse(nbr, wts, active, mean, rho, wire_dtype=wire)
        errs_m = eq6_errors(f"consensus_fused_masked_sparse N={n}", got_m,
                            k.consensus_masked_sparse_plain(nbr, wts, active, mean, rho, wire),
                            wire)
        if not (torch.equal(got_m[0][~active], mean[~active])
                and torch.equal(got_m[1][~active], rho[~active])):
            raise AssertionError(f"consensus_fused_masked_sparse N={n}: inactive rows not "
                                 "passed through")
        phase("2.sparse", tables=f"ring{n}", n=n, d=nbr.shape[1], p=p, wire=wire,
              n_active=int(active.sum()), max_abs_err=max(errs), masked_max_abs_err=max(errs_m),
              variant=kernel_variant(functools.partial(
                  k.consensus_fused_sparse, nbr, wts, mean, rho, wire_dtype=wire)))
    del nbr, wts, mean, rho, active
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
        n, p = N_BEYOND_GRID, 3  # more agents than a grid dimension holds; chunks span many rows
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


def eq6_same_bits(what, got, other):
    """Raise unless two eq. (6) results are the same bits; returns True."""
    import torch

    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, other)):
        raise AssertionError(f"{what}: not bitwise the other path's result")
    return True


def kernel_variant(fn, work=None):
    """The template instance of the one device kernel ``fn`` launches (e.g.
    ``payload_validity_kernel<0, 4>``: wire code, lanes per load), read from
    the captured graph of one call (``captured_work``, or ``work`` if given)."""
    work = captured_work(fn) if work is None else work
    if len(work) != 1 or work[0]["type"] != "kernel" or "<" not in work[0]["name"]:
        raise AssertionError(f"expected one templated device kernel, got {work}")
    return work[0]["name"]


def ptxas_usage(variant):
    """Registers and spill bytes ptxas reported for a kernel instance, e.g.
    ``consensus_small_kernel<0, 9>``, from this run's build (empty when the
    library was already built)."""
    import re

    from repro_torch.kernels import dispatch

    name, args = variant.rstrip(">").split("<")
    mangled = "".join(f"Li{a.strip().replace('-', 'n')}E" for a in args.split(","))
    mangled = f"{name}I{mangled}E"  # e.g. consensus_small_kernelILi0ELi9EE
    lines = dispatch.build_info.get("ptxas", "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and mangled in line:
            block = " ".join(lines[i:i + 4])
            regs = re.search(r"Used (\d+) registers", block)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
            return {"ptxas_registers": int(regs.group(1)) if regs else None,
                    "ptxas_spill_bytes": [int(x) for x in spills.groups()] if spills else None}
    return {}


def launch_fields(fn, launch_floor_ms):
    """Phase 5's per-call fields of a single-kernel wrapper: device work a
    call, the kernel instance, the launch floor and ptxas's usage."""
    work = captured_work(fn)
    variant = kernel_variant(fn, work)
    return {"device_kernels_per_call": len(work), "variant": variant,
            "launch_floor_ms": launch_floor_ms, **ptxas_usage(variant)}


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
    from repro_torch.kernels import gauss_vi, launch_plan

    worst = {}
    for (n, p) in [(9, P_SLICE), (300, 4_099), (1, 5)]:
        for wire in WIRES:
            W, mean, rho = eq6_inputs(n, p, seed=n + p + 1, device=dev)
            w = W[n // 2].clone()
            if n > 2:  # zero weights in the row are computed, not skipped
                w[0] = w[-1] = 0.0
                w = w / w.sum()
            row = functools.partial(k.consensus_fused, w, mean, rho, wire_dtype=wire)
            generic = functools.partial(k._row_launch, w, mean, rho, wire, instance=0)
            got = row()
            errs = eq6_errors(f"consensus_fused N={n} P={p}", got,
                              k.consensus_row_plain(w, mean, rho, wire), wire)
            phase("2.consensus_row", n=n, p=p, wire=wire, zero_weights=int((w == 0).sum()),
                  max_abs_err_mean=errs[0], max_abs_err_rho=errs[1], variant=kernel_variant(row),
                  generic_variant=kernel_variant(generic), generic_bitwise=eq6_same_bits(
                      f"consensus_fused N={n} P={p} wire={wire} generic", got, generic()))
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
    for dt in ("f32", "bf16"):  # more heads than a grid dimension holds: the flat grid
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
        for shape in ((N_BEYOND_GRID, 1, 64, 32), (1, N_BEYOND_GRID, 64, 32)):
            g = torch.Generator(device=dev).manual_seed(sum(shape))
            q, kk, vv = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3))
            err = attention_errors(f"flash_attention {dt} {shape}",
                                   fa.flash_attention(q, kk, vv, causal=True),
                                   fa.flash_attention_plain(q, kk, vv, causal=True), ATT_TOL[dt])
            bq = launch_plan.ATTN_F32_BQ if dt == "f32" else fa.TC_TILES[32][0]
            phase("2.flash_attention", dtype=dt, shape=shape, sk=shape[2], causal=True, window=0,
                  max_abs_err=err,
                  grid_blocks=launch_plan.attention_blocks(shape[0] * shape[1], shape[2], bq))
            del q, kk, vv
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
    return session, counts, prior, run_s


def run_launch(dev, slice_session):
    """Phase 3.launch: the slice's spec on the launch engine, 3 rounds, held
    against the simulated slice session of the same seed (after its 3
    rounds); counters around the rounds."""
    import numpy as np
    import torch

    from repro_torch.api import build_session
    from repro_torch.kernels import dispatch
    from repro_torch.launch import BayesTrainState

    session = build_session(launch_spec(), device=dev)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    losses, walls = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(session.round()["loss"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    ev = session.evaluate()
    health = session.health()
    counts = dispatch.launch_counts()
    sim_ev = slice_session.evaluate()
    lp, sp = session.posterior(), slice_session.posterior()
    errs = {f: float((getattr(lp, f) - getattr(sp, f)).abs().max()) for f in ("mean", "rho")}
    close = all(torch.allclose(getattr(lp, f), getattr(sp, f), rtol=LAUNCH_TOL[0],
                               atol=LAUNCH_TOL[1]) for f in ("mean", "rho"))
    bitwise = all(torch.equal(getattr(lp, f), getattr(sp, f)) for f in ("mean", "rho"))
    acc_err = float(np.abs(np.asarray(ev["acc"]) - np.asarray(sim_ev["acc"])).max())
    phase("3.launch", losses=losses, avg_acc=ev["avg_acc"], acc=ev["acc"],
          health=health["n_healthy"], launches=counts, round_wall_ms=walls,
          state=type(session.state).__name__, step=int(session.state.step),
          vs_simulated_max_abs_err=errs, tol=LAUNCH_TOL, acc_max_abs_err=acc_err,
          acc_atol=LAUNCH_ACC_ATOL, bitwise_simulated=bitwise)
    if not isinstance(session.state, BayesTrainState) or int(session.state.step) != 3 * 4:
        raise AssertionError(f"3.launch: state {type(session.state).__name__}")
    if not np.all(np.isfinite(losses)) or not health["all_ok"]:
        raise AssertionError(f"3.launch: losses {losses}, health {health}")
    if counts["consensus_fused_network"] != 3 or counts["payload_validity_fused"] <= 0:
        raise AssertionError(f"3.launch: launches {counts}")
    if not close or acc_err > LAUNCH_ACC_ATOL:
        raise AssertionError(f"3.launch: against the simulated slice {errs}, acc {acc_err}")
    return session, counts


def run_launch_checkpoint(dev, smi, session):
    """Phase 3.launch_checkpoint: the launch session through save -> load
    (card and CPU, bitwise), its leaves a ``BayesTrainState``'s, then one
    more round on both card sessions, bitwise (counters around it)."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.launch import BayesTrainState

    loaded, fields = save_and_load("3.launch_checkpoint", session, dev, smi)
    step = loaded.state.step
    leaves_ok = (isinstance(loaded.state, BayesTrainState) and step.shape == ()
                 and step.dtype == torch.int32 and fields["leaves"] == 7)
    dispatch.reset_launch_counts()
    session.round()
    loaded.round()
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    same = states_bitwise(session.state, loaded.state)
    phase("3.launch_checkpoint", **fields, bayes_train_state_leaves=leaves_ok,
          resumed_round_bitwise=same, launches=counts)
    if not same or not leaves_ok or counts["consensus_fused_network"] != 2:
        raise AssertionError(f"3.launch_checkpoint: leaves {leaves_ok}, resumed bitwise "
                             f"{same}, launches {counts}")


def run_serve(dev, session, smi):
    """Phase 3.serve: snapshots of the slice session and a ragged request
    stream through the bucketed MC-predictive server (one CUDA-graph
    capture per key), checked against ``mc_predict``, the CPU and the f32
    snapshot, and the staleness SLO under both policies."""
    import numpy as np
    import torch

    from repro_torch.core.flat import FlatPosterior
    from repro_torch.launch.costmodel import serve_roofline
    from repro_torch.serve import PredictiveServer, SnapshotStore, StalenessSLOError
    from repro_torch.vi.bayes_by_backprop import mc_predict

    live = session.posterior()
    publish_ms = {}
    snaps = {}
    for dt in ("f32", "bf16"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snaps[dt] = session.snapshot(dtype=dt)
        publish_ms[dt] = (time.perf_counter() - t0) * 1e3
    nbytes = {dt: s.nbytes() for dt, s in snaps.items()}
    n_agents = session.data.n_agents
    modeled = {dt: serve_roofline(n_agents, session.posterior().n_params(), snapshot_dtype=dt)
               for dt in ("f32", "bf16")}
    shared = any(getattr(s.posterior, f).untyped_storage().data_ptr()
                 == getattr(live, f).untyped_storage().data_ptr()
                 for s in snaps.values() for f in ("mean", "rho"))
    failures = []
    if nbytes["f32"] != SNAPSHOT_F32_BYTES or 2 * nbytes["bf16"] != nbytes["f32"] or shared:
        failures.append(f"snapshot bytes {nbytes}, storage shared {shared}")
    if any(nbytes[dt] != modeled[dt]["snapshot_hbm_bytes"] for dt in nbytes):
        failures.append(f"snapshot bytes {nbytes} against serve_roofline "
                        f"{ {dt: m['snapshot_hbm_bytes'] for dt, m in modeled.items()} }")

    # the stream, on the server's own generator: captures, replays, latency
    x = session.data.x_test[:max(SERVE_SIZES)].cpu().numpy()
    session.snapshot(dtype="f32")
    server = session.attach_server(mc_samples=8, bucket_sizes=SERVE_BUCKETS)
    torch.cuda.synchronize()
    reserved0, allocated0 = torch.cuda.memory_reserved(dev), torch.cuda.memory_allocated(dev)
    keys = set()

    def stream(dtype, agent0=0):
        for mc in (8, 0):
            for i, n in enumerate(SERVE_SIZES):
                probs, _ = server.query(x[:n], agent=(agent0 + i) % n_agents, mc_samples=mc)
                if tuple(probs.shape) != (n, 10) or not torch.isfinite(probs).all():
                    failures.append(f"probs {tuple(probs.shape)} for {n} rows")
                keys.update((b, mc, dtype) for b in server._bucket_plan(n))

    stream("f32")
    captures = server.n_traces
    torch.cuda.synchronize()
    graph_reserved = torch.cuda.memory_reserved(dev) - reserved0
    graph_allocated = torch.cuda.memory_allocated(dev) - allocated0
    session.snapshot(dtype="f32")  # republish: no new capture
    n_cold = len(server._lat_us)
    stream("f32", agent0=4)
    warm_us = np.asarray(server._lat_us[n_cold:])
    replay_added = server.n_traces - captures
    session.snapshot(dtype="bf16")
    stream("bf16")
    bf16_captures = server.n_traces - captures
    stream("bf16", agent0=2)
    bf16_replay_added = server.n_traces - captures - bf16_captures
    if server.n_traces != len(keys) or replay_added or bf16_replay_added:
        failures.append(f"captures {server.n_traces} for {len(keys)} keys, replays added "
                        f"{replay_added} and {bf16_replay_added}")

    # correctness on recorded noise: against mc_predict, the CPU, the f32 snapshot
    def noise_fn(counter, mc, p):
        return torch.randn((mc, p), generator=torch.Generator().manual_seed(5000 + counter))

    cases = [(0, 7), (4, 32), (8, 1), (2, 20)]  # (agent, rows): one slab each
    errs = {"vs_mc_predict": 0.0, "point_vs_predictive": 0.0, "card_vs_cpu": 0.0,
            "bf16_vs_f32": 0.0}
    served = {}
    for dt in ("f32", "bf16"):
        snap = session.snapshot(dtype=dt)
        host = SnapshotStore()
        host.publish(FlatPosterior(snap.posterior.mean.float().cpu(),
                                   snap.posterior.rho.float().cpu(), snap.posterior.layout),
                     window=snap.window, dtype=dt)
        for mc in (8, 0):
            card = PredictiveServer(session.serve_store, session.model.logits_fn, mc_samples=mc,
                                    bucket_sizes=SERVE_BUCKETS, noise_fn=noise_fn)
            cpu = PredictiveServer(host, session.model.logits_fn, mc_samples=mc,
                                   bucket_sizes=SERVE_BUCKETS, noise_fn=noise_fn)
            for c, (agent, n) in enumerate(cases):
                got = card.query(x[:n], agent=agent)[0]
                want = cpu.query(x[:n], agent=agent)[0]
                errs["card_vs_cpu"] = max(errs["card_vs_cpu"],
                                          float((got.cpu() - want).abs().max()))
                served[dt, mc, c] = got
                if dt != "f32":
                    continue
                xt = torch.as_tensor(x[:n], device=dev)
                post = FlatPosterior(snap.posterior.mean[agent:agent + 1],
                                     snap.posterior.rho[agent:agent + 1], snap.posterior.layout)
                if mc:
                    ref = mc_predict(post, session.model.logits_fn, xt,
                                     eps=noise_fn(c, mc, post.n_params()).to(dev))[0]
                    errs["vs_mc_predict"] = max(errs["vs_mc_predict"],
                                                float((got - ref).abs().max()))
                else:
                    ref = session.predictive(agent, x[:n], n_mc=0)
                    errs["point_vs_predictive"] = max(errs["point_vs_predictive"],
                                                      float((got - ref).abs().max()))
    for (dt, mc, c), got in served.items():
        if dt == "bf16":
            errs["bf16_vs_f32"] = max(errs["bf16_vs_f32"],
                                      float((got - served["f32", mc, c]).abs().max()))
    if max(errs["vs_mc_predict"], errs["point_vs_predictive"], errs["card_vs_cpu"]) > SERVE_ATOL \
            or errs["bf16_vs_f32"] > SERVE_BF16_ATOL:
        failures.append(f"errors {errs}")

    # the staleness SLO on a store whose clock the phase sets
    now = [session.round_idx]
    store = SnapshotStore(clock=lambda: now[0])
    store.publish(live, window=session.round_idx, dtype="bf16")
    flag = PredictiveServer(store, session.model.logits_fn, mc_samples=2, max_staleness=1,
                            staleness_policy="flag", bucket_sizes=(8,))
    strict = PredictiveServer(store, session.model.logits_fn, mc_samples=2, max_staleness=1,
                              staleness_policy="strict", bucket_sizes=(8,))
    slo = {"fresh": strict.query(x[:3])[1]["slo_ok"]}
    now[0] += 1
    slo["age1_strict"] = strict.query(x[:3])[1]["slo_ok"]
    now[0] += 1
    slo["age2_flag"] = flag.query(x[:3])[1]["slo_ok"]
    try:
        strict.query(x[:3])
        slo["age2_strict_refused"] = False
    except StalenessSLOError:
        slo["age2_strict_refused"] = True
    slo["breaches"] = [flag.n_slo_breaches, strict.n_slo_breaches]
    if slo != {"fresh": True, "age1_strict": True, "age2_flag": False,
               "age2_strict_refused": True, "breaches": [1, 1]}:
        failures.append(f"SLO {slo}")
    tel = server.telemetry()
    p = session.posterior().n_params()
    modeled_us = {  # the cost model's roofline at the card's HBM rate
        "publish": {dt: m["roofline_seconds"]["publish"] * 1e6 for dt, m in modeled.items()},
        "apply_per_slab_mc8": {b: serve_roofline(n_agents, p, mc_samples=8, batch=b, dim=784,
                                                 n_classes=10)["roofline_seconds"]
                               ["apply_per_batch"] * 1e6 for b in SERVE_BUCKETS},
    }
    phase("3.serve", snapshot_bytes=nbytes,
          modeled_snapshot_bytes={dt: m["snapshot_hbm_bytes"] for dt, m in modeled.items()},
          modeled_us=modeled_us, publish_ms=publish_ms, captures=server.n_traces,
          keys=len(keys), f32_captures=captures, bf16_captures=bf16_captures,
          replay_added=[replay_added, bf16_replay_added], requests=tel["requests"],
          rows=tel["rows"], slabs=tel["batches"], padded_rows=tel["padded_rows"],
          latency_warm_us={"p50": float(np.percentile(warm_us, 50)),
                           "p99": float(np.percentile(warm_us, 99)), "n": int(warm_us.size)},
          latency_all_us=tel["latency"], graph_reserved_bytes=graph_reserved,
          graph_allocated_bytes=graph_allocated, max_abs_err=errs, atol=SERVE_ATOL,
          bf16_atol=SERVE_BF16_ATOL, slo=slo, nvidia_smi=smi, failures=failures)
    if failures:
        raise AssertionError(f"3.serve: {'; '.join(failures)}")


OBS_SPANS = {"session.run", "session.round", "session.w_build", "session.batches",
             "obs.convergence", "serve.publish", "serve.request", "session.evaluate"}


def with_obs(spec, jsonl_path=None):
    """``spec`` with observability on: spans, convergence, a JSONL sink."""
    from repro_torch.api import ObsSpec

    return dataclasses.replace(spec, obs=ObsSpec(enabled=True, trace=True, convergence=True,
                                                 jsonl_path=jsonl_path))


def span_p50s(obs):
    """{span name: {mode: (n, p50 us)}} of a session's tracer."""
    return {name: {mode: (v["n"], v["p50_us"]) for mode, v in modes.items()}
            for name, modes in obs.tracer.summary().items()}


def span_cost_us(sync, reps=200):
    """Median µs of one empty span: live with ``sync`` (the card idle),
    live without, and a disabled tracer's."""
    from repro_torch.obs import Tracer

    out = {}
    for name, tracer in [("live_sync", Tracer(sync=sync)), ("live", Tracer()),
                         ("disabled", Tracer(enabled=False))]:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            with tracer.span("probe", round=0):
                pass
            times.append((time.perf_counter() - t0) * 1e6)
        out[name] = sorted(times)[reps // 2]
    return out


def run_obs(dev, smi, slice_wall_ms):
    """Phase 3.obs: the synchronous slice with observability on (spans,
    convergence, a JSONL sink), 3 rounds (``run(2)``, then ``round()``,
    which builds its W from the schedule), then ``snapshot()``,
    ``attach_server()``, queries, ``evaluate()`` and ``dashboard()``;
    counters around the rounds."""
    import numpy as np

    from repro_torch.api import build_session
    from repro_torch.core.theory import consensus_contraction_rate
    from repro_torch.kernels import dispatch
    from repro_torch.obs import Observability

    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "obs.jsonl")
        session = build_session(with_obs(fig4_spec(), path), device=dev)
        dispatch.reset_launch_counts()
        hist = session.run(n_rounds=2, eval_every=1)
        hist.append(session.round())
        counts = dispatch.launch_counts()
        session.snapshot()
        server = session.attach_server(mc_samples=8, bucket_sizes=SERVE_BUCKETS)
        x = session.data.x_test[:max(SERVE_SIZES)].cpu().numpy()
        for i, n in enumerate(SERVE_SIZES[:6]):
            server.query(x[:n], agent=i % session.data.n_agents)
        ev = session.evaluate()
        dashboard = session.dashboard()
        events = [json.loads(line) for line in open(path)]
    obs = session.obs
    reg = obs.registry
    names = {sp.name for sp in obs.tracer.spans}
    summ = obs.tracer.summary()
    rounds = summ.get("session.round", {})
    kinds = {e["kind"] for e in events}
    rep = obs.convergence.report()
    theory = consensus_contraction_rate(fig4_spec().topology.w_schedule()(0))
    losses = [r["loss"] for r in hist]
    if not isinstance(obs, Observability) or obs.tracer.sync is None:
        failures.append(f"bundle {type(obs).__name__}, sync {obs.tracer.sync}")
    if reg.counter("session.rounds").value() != 3:
        failures.append(f"session.rounds {reg.counter('session.rounds').value()}")
    if not OBS_SPANS <= names:
        failures.append(f"spans missing: {sorted(OBS_SPANS - names)}")
    if rounds.get("compile", {}).get("n") != 1 or rounds.get("warm", {}).get("n") != 2:
        failures.append(f"session.round split {rounds}")
    if "span" not in kinds or not kinds & {"counter", "gauge"}:
        failures.append(f"JSONL event kinds {sorted(kinds)}")
    if rep["theory_rate"] != theory or rep["n_rounds"] != 3:
        failures.append(f"convergence report {rep['theory_rate']} vs {theory}")
    if counts["consensus_fused_network"] != 3 or not np.all(np.isfinite(losses)):
        failures.append(f"launches {counts}, losses {losses}")
    warm_round_p50_ms = rounds.get("warm", {}).get("p50_us", float("nan")) / 1e3
    phase("3.obs", rounds=int(reg.counter("session.rounds").value()), losses=losses,
          avg_acc=ev["avg_acc"], launches=counts, spans=span_p50s(obs),
          round_warm_p50_ms=warm_round_p50_ms, slice_round_wall_ms=slice_wall_ms,
          convergence={k: rep[k] for k in ("measured_rate", "theory_rate", "rate_attainment")},
          latest=rep["latest"], serve_requests=reg.counter("serve.requests").value(),
          jsonl_events=len(events), jsonl_kinds=sorted(kinds),
          span_cost_us=span_cost_us(obs.tracer.sync), nvidia_smi=smi, failures=failures)
    print(dashboard, flush=True)
    if failures:
        raise AssertionError(f"3.obs: {'; '.join(failures)}")
    return counts


def run_obs_gossip(dev, smi):
    """Phase 3.obs_gossip: the gossip slice (chaos faults, quarantine) with
    observability on, 4 windows; the window spans' p50 against the
    ``window_masked`` roofline of the cost model."""
    import numpy as np

    from repro_torch.api import build_session
    from repro_torch.kernels import dispatch
    from repro_torch.obs import window_attainment

    session = build_session(with_obs(gossip_spec()), device=dev)
    dispatch.reset_launch_counts()
    hist = session.run(n_rounds=4, eval_every=1)
    counts = dispatch.launch_counts()
    ev = session.evaluate()
    reg = session.obs.registry
    spans = [sp for sp in session.obs.tracer.spans if sp.name == "gossip.window"]
    clock = session.spec.topology.gossip_clock()
    wins = [clock.window(r) for r in range(4)]
    part = [int(w.participating().sum()) for w in wins]
    merging = [int(w.active.sum()) for w in wins]
    window_us = sorted(sp.dur_us for sp in spans)
    p50_us = window_us[len(window_us) // 2]
    att = window_attainment(p50_us, n_agents=session.data.n_agents,
                            n_params=session.posterior().n_params(),
                            n_participating=int(np.median(part)),
                            n_merging=int(np.median(merging)))
    failures = []
    if reg.counter("gossip.windows").value() != 4:
        failures.append(f"gossip.windows {reg.counter('gossip.windows').value()}")
    if reg.gauge("gossip.jit_traces").value() != session.engine.n_traces or \
            session.engine.n_traces != 1:
        failures.append(f"jit_traces {reg.gauge('gossip.jit_traces').value()}, "
                        f"n_traces {session.engine.n_traces}")
    if [sp.attrs["impl"] for sp in spans] != ["masked"] * 4:
        failures.append(f"gossip.window spans {[sp.attrs for sp in spans]}")
    if counts["consensus_fused_masked"] != 4 or counts["payload_validity_fused"] <= 0:
        failures.append(f"launches {counts}")
    phase("3.obs_gossip", windows=int(reg.counter("gossip.windows").value()),
          jit_traces=reg.gauge("gossip.jit_traces").value(), n_traces=session.engine.n_traces,
          losses=[r["loss"] for r in hist], avg_acc=ev["avg_acc"], launches=counts,
          spans=span_p50s(session.obs), window_us=window_us, participating=part,
          merging=merging, window_attainment=att,
          quarantined=reg.gauge("engine.faults.quarantined.total").value(),
          nvidia_smi=smi, failures=failures)
    print(session.dashboard(), flush=True)
    if failures:
        raise AssertionError(f"3.obs_gossip: {'; '.join(failures)}")
    return counts


def obs_rung(dev):
    """4.ladder rung obs_on==obs_off: the synchronous and the gossip slice,
    each twice from one seed, one session with observability on (spans
    synchronising the card, convergence sampled every round, a JSONL sink);
    after the same rounds every state leaf (the posterior, the optimizer
    state, every leaf a checkpoint writes) and the generators are bitwise
    equal."""
    import torch

    from repro_torch.api import build_session

    for name, spec, n_rounds in [("synchronous", fig4_spec(), 3),
                                 ("gossip", gossip_spec(), 4)]:
        with tempfile.TemporaryDirectory() as tmp:
            on = build_session(with_obs(spec, os.path.join(tmp, "o.jsonl")), device=dev)
            off = build_session(spec, device=dev)
            on.run(n_rounds=n_rounds)
            off.run(n_rounds=n_rounds)
            on.snapshot()
            on.attach_server(mc_samples=8).query(on.data.x_test[:7].cpu().numpy())
            on.evaluate()
            on.dashboard()
            on.round()
            off.round()
            torch.cuda.synchronize()
        same = {"state": states_bitwise(on.state, off.state),
                "generator": bool(torch.equal(on.generator.get_state(),
                                              off.generator.get_state()))}
        walls = {"on": [], "off": []}  # warm rounds, in turns, after the check
        for _ in range(4):
            for key, sess in (("on", on), ("off", off)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sess.round()
                torch.cuda.synchronize()
                walls[key].append((time.perf_counter() - t0) * 1e3)
        p50 = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
        phase("4.ladder", rung=f"obs_on==obs_off({name})", bitwise=same,
              agents=on.data.n_agents, rounds=n_rounds + 1,
              spans=len(on.obs.tracer.spans), convergence_samples=len(on.obs.convergence.stats),
              warm_round_ms=walls, warm_round_p50_ms=p50,
              obs_overhead_ms=p50["on"] - p50["off"])
        if not all(same.values()):
            raise AssertionError(f"4.ladder obs_on==obs_off({name}): not bitwise: {same}")


def adam_noise_lanes(card, cpu):
    """``[N, P]`` bool: the lanes whose Adam step rounding decided in the
    compared round, from the two devices' states after it (``card``,
    ``cpu``, each with ``opt_state.mu``/``.nu`` of ``mean`` and ``rho``
    fields on the CPU): the moments disagree by more than ADAM_NOISE_GAP
    (relative to v, and to sqrt(v) for m) in either field."""
    import torch

    noise = None
    for field in ("mean", "rho"):
        m_a, m_c = (getattr(s.opt_state.mu, field) for s in (card, cpu))
        v_a, v_c = (getattr(s.opt_state.nu, field) for s in (card, cpu))
        v = torch.maximum(v_a, v_c)
        lane = (((m_a - m_c).abs() > ADAM_NOISE_GAP * torch.sqrt(v))
                | ((v_a - v_c).abs() > ADAM_NOISE_GAP * v))
        noise = lane if noise is None else noise | lane
    return noise


def parity_errors(tag, diffs, noise, W, exempt_atol):
    """Hold a card-vs-CPU round's ``[N, P]`` absolute differences ``diffs``
    (name -> tensor) to PARITY_ATOL, except the posterior fields (``mean``,
    ``rho``) on the lanes consensus (``W [N, N]``) mixes a noise lane into,
    which are held to ``exempt_atol``; it fails past EXEMPT_SHARE_MAX exempt
    lanes or either bound.  Returns the fields of the phase line, with what
    failed under ``failures``."""
    exempt = ((W > 0).float() @ noise.float()) > 0
    share = float(exempt.float().mean())
    errs, exempt_errs = {}, {}
    for name, d in diffs.items():
        if name in ("mean", "rho"):
            errs[name] = float(d.masked_fill(exempt, 0.0).max())
            exempt_errs[name] = float(d.masked_fill(~exempt, 0.0).max())
        else:
            errs[name] = float(d.max())
    failures = []
    if share > EXEMPT_SHARE_MAX:
        failures.append(f"{share:.4%} of the lanes exempt, more than {EXEMPT_SHARE_MAX:.2%}")
    if max(errs.values()) > PARITY_ATOL:
        failures.append(f"a lane beyond PARITY_ATOL: {errs}")
    if max(exempt_errs.values(), default=0.0) > exempt_atol:
        failures.append(f"an exempt lane beyond {exempt_atol}: {exempt_errs}")
    return dict(max_abs_err=errs, atol=PARITY_ATOL, noise_lanes=int(noise.sum()),
                exempt_lanes=int(exempt.sum()), lanes=exempt.numel(), exempt_share=share,
                exempt_share_max=EXEMPT_SHARE_MAX, exempt_max_abs_err=exempt_errs,
                exempt_atol=exempt_atol, failures=failures)


def card_vs_cpu(tag, session, spec):
    """One more round on the card and on the CPU from the same state with
    the same injected draws; the CPU runs the plain versions.  Adam's noise
    lanes are exempt, within bounds (``adam_noise_lanes``,
    ``parity_errors``)."""
    import numpy as np
    import torch

    from repro_torch.api import build_session

    cpu = build_session(spec, device="cpu")
    cpu.state = session.state.to("cpu")
    cpu.round_idx = session.round_idx
    W = spec.topology.w_schedule()(session.round_idx)
    W = getattr(W, "w_eff", W)  # a SparseWindow's dense view
    W = torch.as_tensor(np.asarray(W), dtype=torch.float32)
    n, p = session.posterior().mean.shape
    u, b = spec.data.local_updates, spec.data.batch_size
    g = torch.Generator().manual_seed(2024)
    idx = torch.randint(0, 150, (n, u * b), generator=g)  # every shard holds >= 150
    eps = torch.randn((n, u, 1, p), generator=g)
    rec_card = session.round(batch_idx=idx, eps=eps)
    rec_cpu = cpu.round(batch_idx=idx, eps=eps)
    a, c = session.state.to("cpu"), cpu.state
    lc, lp = rec_card["losses"], rec_cpu["losses"]
    if not np.array_equal(np.isnan(lc), np.isnan(lp)):
        raise AssertionError(f"{tag}: agents trained differ: {lc} vs {lp}")
    ok = ~np.isnan(lp)
    loss_rel = float(abs(lc[ok] - lp[ok]).max() / abs(lp[ok]).max())
    same_counters = all(torch.equal(getattr(a, f), getattr(c, f))
                        for f in ("step", "round", "last_merge", "n_merges", "n_quarantined")
                        if getattr(c, f, None) is not None)
    diffs = {"mean": (a.posterior.mean - c.posterior.mean).abs(),
             "rho": (a.posterior.rho - c.posterior.rho).abs(),
             "adam_mu_mean": (a.opt_state.mu.mean - c.opt_state.mu.mean).abs(),
             "adam_mu_rho": (a.opt_state.mu.rho - c.opt_state.mu.rho).abs()}
    fields = parity_errors(tag, diffs, adam_noise_lanes(a, c), W,
                           2 * u * spec.inference.lr)
    if loss_rel > PARITY_RTOL or not same_counters:
        fields["failures"].append(f"losses {loss_rel} apart, counters equal {same_counters}")
    phase(tag, **fields, loss_max_rel_err=loss_rel, rtol=PARITY_RTOL,
          counters_equal=same_counters, n_trained=rec_card["n_trained"])
    if fields["failures"]:
        raise AssertionError(f"{tag}: {'; '.join(fields['failures'])}")


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
    synchronous, zero-fault quarantine == strict (instant, delayed and
    segments windows), latency 0 == instant (no ring) — after 2 rounds from
    the same injected draws; and one delayed window run twice from the same
    state gives the same bits."""
    import numpy as np
    import torch

    from repro_torch.api import build_session
    from repro_torch.gossip.clocks import _directed_edges

    edges = [[int(i), int(j)] for i, j in _directed_edges(fig4_spec().topology.w_schedule()(0))]
    all_edges = {"kind": "trace", "trace": [edges]}
    latency0 = dict(DELAYED_CLOCK, latency={"kind": "constant", "delay": 0})
    pairs = {
        "all_edges_gossip==synchronous": (gossip_spec("strict", False, all_edges), fig4_spec()),
        "zero_fault_quarantine==strict": (gossip_spec("quarantine", False),
                                          gossip_spec("strict", False)),
        "latency0==instant": (gossip_spec("strict", False, latency0),
                              gossip_spec("strict", False)),
        "zero_fault_quarantine==strict(delayed)": (
            gossip_spec("quarantine", False, DELAYED_CLOCK),
            gossip_spec("strict", False, DELAYED_CLOCK)),
        "zero_fault_quarantine==strict(segments)": (
            sparse_slice_spec("quarantine", False), sparse_slice_spec("strict", False)),
    }
    p = P_SLICE
    u, b = FIG4["local_updates"], FIG4["batch_size"]
    for name, (spec_a, spec_b) in pairs.items():
        a, c = build_session(spec_a, device=dev), build_session(spec_b, device=dev)
        n = a.data.n_agents
        g = torch.Generator().manual_seed(7)
        for _ in range(2):
            idx = torch.randint(0, 150, (n, u * b), generator=g)  # every shard holds >= 150
            eps = torch.randn((n, u, 1, p), generator=g)
            a.round(batch_idx=idx, eps=eps)
            c.round(batch_idx=idx, eps=eps)
        torch.cuda.synchronize()
        same = {f: bool(torch.equal(getattr(a.posterior(), f), getattr(c.posterior(), f)))
                for f in ("mean", "rho")}
        same["adam_nu_rho"] = bool(torch.equal(a.state.opt_state.nu.rho,
                                               c.state.opt_state.nu.rho))
        fields = {}
        if name == "latency0==instant":  # no ring: the instant engine's leaves
            same["no_ring"] = a.engine.hist_slots == 0 and a.state.hist_mean is None
            fields["hist_slots"] = a.engine.hist_slots
        phase("4.ladder", rung=name, bitwise=same, agents=n,
              engines=[a.engine.name, c.engine.name],
              impls=[("delayed" if getattr(e.engine, "hist_slots", 0) else
                      getattr(e.engine, "consensus_impl", "synchronous")) for e in (a, c)],
              **fields)
        if not all(same.values()) or not np.isfinite(a.posterior().mean.cpu().numpy()).all():
            raise AssertionError(f"4.ladder {name}: not bitwise: {same}")
    session = build_session(gossip_spec("quarantine", True, DELAYED_CLOCK), device=dev)
    session.run(n_rounds=2)
    g = torch.Generator().manual_seed(11)
    r, n = session.round_idx, session.data.n_agents
    batches = session.data.sampler(session.generator, r,
                                   idx=torch.randint(0, 150, (n, u * b), generator=g))
    eps = torch.randn((n, u, 1, p), generator=g).to(dev)
    W = session.spec.topology.w_schedule()(r)
    first, second = (session.engine.run_round(session.state, batches, W, eps=eps)[0]
                     for _ in range(2))
    same = states_bitwise(first, second)
    phase("4.ladder", rung="delayed_window_twice==same_bits", bitwise=same, window=r)
    if not same:
        raise AssertionError("4.ladder: one delayed window run twice gave other bits")
    serve_rung(dev)
    obs_rung(dev)


def serve_rung(dev):
    """4.ladder rung serve_attached==detached: two slice sessions, one with
    snapshots published and queries served around its rounds; after one
    more round the states and the generators are bitwise equal."""
    import torch

    from repro_torch.api import build_session

    p = P_SLICE
    u, b = FIG4["local_updates"], FIG4["batch_size"]
    a, c = build_session(fig4_spec(), device=dev), build_session(fig4_spec(), device=dev)
    n = a.data.n_agents
    x = a.data.x_test[:12].cpu().numpy()
    g = torch.Generator().manual_seed(13)
    server = None
    for r in range(2):
        idx = torch.randint(0, 150, (n, u * b), generator=g)  # every shard holds >= 150
        eps = torch.randn((n, u, 1, p), generator=g)
        a.snapshot(dtype="bf16" if r else "f32")
        server = server or a.attach_server(mc_samples=8, bucket_sizes=SERVE_BUCKETS)
        server.query(x, agent=r)
        a.round(batch_idx=idx, eps=eps)
        c.round(batch_idx=idx, eps=eps)
    a.round()
    c.round()
    torch.cuda.synchronize()
    same = {"state": states_bitwise(a.state, c.state),
            "generator": bool(torch.equal(a.generator.get_state(), c.generator.get_state()))}
    phase("4.ladder", rung="serve_attached==detached", bitwise=same, agents=n,
          captures=server.n_traces, published=a.serve_store.n_published)
    if not all(same.values()):
        raise AssertionError(f"4.ladder serve_attached==detached: not bitwise: {same}")


def states_bitwise(a, b) -> bool:
    """Every state leaf of ``a`` equals ``b``'s: dtype, shape and bits (NaN
    lanes too), on whichever devices they live."""
    import torch

    from repro_torch.core.tree import tree_leaves

    def bits(x):
        x = x.detach().cpu().reshape(-1)
        return x.view(torch.uint8) if x.is_floating_point() else x

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(bits(x), bits(y))
        for x, y in zip(la, lb))


def save_and_load(tag, session, dev, smi):
    """Save ``session``, load the file on the card and on the CPU; assert the
    state leaves bitwise across all three.  -> (card session, fields)."""
    import torch

    from repro_torch.api import Session
    from repro_torch.checkpoint import io as checkpoint_io
    from repro_torch.core.tree import tree_leaves

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session.ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.save(path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        checkpoint_io.restore_session(path)
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = Session.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        on_cpu = Session.load(path, device="cpu")
    if loaded.device.type != session.device.type or loaded.round_idx != session.round_idx:
        raise AssertionError(f"{tag}: loaded on {loaded.device}, round {loaded.round_idx}")
    for other, where in ((loaded, "card"), (on_cpu, "CPU")):
        if not states_bitwise(session.state, other.state):
            raise AssertionError(f"{tag}: the state loaded on the {where} is not bitwise the saved")
    n_leaves = len(tree_leaves(session.state))
    raw = sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(session.state))
    return loaded, dict(file_bytes=nbytes, leaf_bytes=raw, leaves=n_leaves,
                        compression="zstd" if checkpoint_io.zstandard else "zlib",
                        save_s=save_s, read_s=read_s, load_s=load_s, nvidia_smi=smi)


def run_checkpoint(dev, smi):
    """Phase 3.checkpoint: the synchronous slice after ``run(3)`` through
    save -> load (card and CPU), bitwise, then one more round on both
    sessions, bitwise (counters around the resumed rounds)."""
    import torch

    from repro_torch.api import build_session
    from repro_torch.kernels import dispatch

    session = build_session(fig4_spec(), device=dev)
    session.run(n_rounds=3)
    loaded, fields = save_and_load("3.checkpoint", session, dev, smi)
    dispatch.reset_launch_counts()
    session.round()
    loaded.round()
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    same = states_bitwise(session.state, loaded.state)
    phase("3.checkpoint", **fields, resumed_round_bitwise=same, launches=counts)
    if not same or counts["consensus_fused_network"] != 2:
        raise AssertionError(f"3.checkpoint: resumed round bitwise {same}, launches {counts}")
    return counts


def run_gossip_checkpoint(dev, smi):
    """Phase 3.gossip_checkpoint: the chaos + quarantine gossip slice after
    ``run(4)`` through save -> load, then two more windows on each session,
    bitwise (tests/test_gossip.py:350); counters around those windows."""
    import torch

    from repro_torch.api import build_session
    from repro_torch.kernels import dispatch

    session = build_session(gossip_spec(), device=dev)
    session.run(n_rounds=4)
    loaded, fields = save_and_load("3.gossip_checkpoint", session, dev, smi)
    dispatch.reset_launch_counts()
    health = loaded.health()
    session.run(n_rounds=2)
    loaded.run(n_rounds=2)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    same = {f: states_bitwise(getattr(session.state, f), getattr(loaded.state, f))
            for f in ("posterior", "last_merge", "n_merges", "n_quarantined")}
    same["all_leaves"] = states_bitwise(session.state, loaded.state)
    tel = loaded.engine.telemetry(loaded.state)
    phase("3.gossip_checkpoint", **fields, resumed_windows_bitwise=same,
          health_after_load=health["n_healthy"], quarantined=tel["faults"]["quarantined"],
          launches=counts)
    if not all(same.values()) or not health["all_ok"] or min(
            counts["consensus_fused_masked"], counts["payload_validity_fused"]) <= 0:
        raise AssertionError(f"3.gossip_checkpoint: bitwise {same}, health {health}, "
                             f"launches {counts}")
    return counts


def linreg_spec():
    from repro_torch.api import DataSpec, ExperimentSpec, InferenceSpec, RunSpec, TopologySpec

    return ExperimentSpec(
        topology=TopologySpec.complete(4),
        data=DataSpec(dataset="linreg", batch_size=10),
        inference=InferenceSpec(method="conjugate_linreg"),
        run=RunSpec(n_rounds=LINREG_ROUNDS, seed=0),
    )


def run_linreg(dev, smi):
    """Phase 3.linreg: paper Example 1 on the card: to the noise floor on
    the card's own draws, card against CPU on injected per-round seeds, and
    the ``FullCovGaussian`` state through save/load bitwise."""
    import numpy as np
    import torch

    from repro_torch.api import build_session

    session = build_session(linreg_spec(), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ev = session.evaluate()
    floor = float(session.data.dataset.noise_std) ** 2
    loaded, fields = save_and_load("3.linreg", session, dev, smi)
    session.round()
    loaded.round()
    resumed = states_bitwise(session.state, loaded.state)

    card = build_session(linreg_spec(), device=dev)
    cpu = build_session(linreg_spec(), device="cpu")
    seeds = np.random.default_rng(2024).integers(0, np.iinfo(np.int32).max, LINREG_ROUNDS)
    rtol, atol = LINREG_MEAN_TOL
    mean_ratio = prec_ratio = prec_elementwise = 0.0
    for seed in seeds:
        card.round(batch_seed=int(seed))
        cpu.round(batch_seed=int(seed))
        got, want = card.state, cpu.state
        dm = (got.mean.cpu() - want.mean).abs()
        mean_ratio = max(mean_ratio, float((dm / (atol + rtol * want.mean.abs())).max()))
        diag = torch.diagonal(want.prec, dim1=-2, dim2=-1).sqrt()
        scale = diag[..., :, None] * diag[..., None, :]
        dp = (got.prec.cpu() - want.prec).abs()
        prec_ratio = max(prec_ratio, float((dp / (LINREG_PREC_TOL * scale)).max()))
        # at the spec's gaussian consensus the CPU test also holds prec elementwise
        prec_elementwise = max(prec_elementwise,
                               float((dp / (atol + rtol * want.prec.abs())).max()))
    phase("3.linreg", rounds=LINREG_ROUNDS, avg_mse=ev["avg_mse"], mse=ev["mse"],
          noise_floor=floor, bound=1.2 * floor, run_s=run_s, **fields,
          resumed_round_bitwise=resumed, card_vs_cpu_mean_tol_share=mean_ratio,
          card_vs_cpu_prec_tol_share=prec_ratio,
          card_vs_cpu_prec_elementwise_tol_share=prec_elementwise, mean_tol=LINREG_MEAN_TOL,
          prec_tol=LINREG_PREC_TOL, health=session.health()["n_healthy"])
    shares = (mean_ratio, prec_ratio, prec_elementwise)
    if not ev["avg_mse"] < 1.2 * floor or not resumed or max(shares) > 1:
        raise AssertionError(f"3.linreg: avg_mse {ev['avg_mse']} (bound {1.2 * floor}), "
                             f"resumed {resumed}, tolerance shares {shares}")


def run_discrete(dev):
    """Phase 3.discrete: ``run_social_learning`` at tests/test_discrete.py's
    rate setting (complete W over 4 agents, 3 thetas, 150 rounds) with
    injected log-likelihoods, card against CPU; the wrong belief's decay
    rate beside ``theory.rate_K``."""
    import numpy as np
    import torch

    from repro_torch.core import discrete, theory
    from repro_torch.core.graphs import complete_w

    n, t, rounds, batch = 4, 3, 150, 4
    means = np.random.default_rng(0).normal(0, 1.0, (n, t)).astype(np.float32)
    means[:, 0] = 0.0
    W = complete_w(n)
    m = torch.from_numpy(means)
    g = torch.Generator().manual_seed(1)
    logliks = torch.stack([
        -0.5 * torch.sum((m[:, 0:1, None] + torch.randn((n, batch, 1), generator=g)
                          - m[:, None, :]) ** 2, dim=1)
        for _ in range(rounds)])
    t0 = time.perf_counter()
    card = discrete.run_social_learning(None, W, None, rounds, t, device=dev, logliks=logliks)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    cpu = discrete.run_social_learning(None, W, None, rounds, t, device="cpu", logliks=logliks)
    rtol, atol = DISCRETE_TOL
    d = (card.cpu() - cpu).abs()
    share = float((d / (atol + rtol * cpu.abs())).max())
    wrong = discrete.wrong_belief_trajectory(card, np.arange(1, t)).cpu().numpy()
    tail = np.arange(rounds // 3, rounds)
    valid = wrong[tail] > 1e-30
    slope = float(-np.polyfit(tail[valid], np.log(wrong[tail][valid]), 1)[0])
    I = np.zeros((n, 1, t - 1))
    for j in range(n):
        for k in range(1, t):
            I[j, 0, k - 1] = batch * float((means[j, 0] - means[j, k]) ** 2) / 2.0
    K = theory.rate_K(theory.stationary_distribution(W), I)
    phase("3.discrete", agents=n, thetas=t, rounds=rounds, device=str(card.device),
          max_abs_err=float(d.max()), tol_share=share, tol=DISCRETE_TOL,
          decay_rate=slope, rate_K=K, run_s=run_s)
    if share > 1 or card.device.type != torch.device(dev).type or not slope > 0.5 * K:
        raise AssertionError(f"3.discrete: tolerance share {share}, slope {slope}, K {K}")


def seg_inputs(n, p, seed, device):
    """[n, P] float32 mean and rho (sigma ~1e-2..1: f16-safe), made on the host."""
    import torch

    g = torch.Generator().manual_seed(seed)
    mean = torch.randn((n, p), generator=g)
    rho = torch.rand((n, p), generator=g) * 5.0 - 4.5
    return mean.to(device), rho.to(device)


def delayed_terms(win, r, k, corrupt=None):
    """The term list ``core.flat.consensus_flat_delayed`` builds for
    ``EventWindow`` ``win`` at round ``r`` with a ring of ``k`` slots: each
    active row's self term (row i of x, weight W[i, i]), then its events
    (ring row (r - lag) mod k, source), the pads one zero-weight term.
    With ``corrupt`` ([N] bool) as ``consensus_flat_delayed_corrupted``
    lays it out: events from the j-th corrupted agent read x row N + j (its
    fill row, after the posterior)."""
    import numpy as np

    from repro_torch.kernels.launch_plan import ragged_terms

    n = win.n_agents
    ar = np.arange(n)
    src = win.edges[:, 1]
    n_x = n if corrupt is None else n + int(corrupt.sum())
    ring = n_x + ((r - np.asarray(win.delays, np.int64)) % k) * n + src
    if corrupt is not None:
        fill = np.full(n, -1)
        fill[corrupt] = n + np.arange(int(corrupt.sum()))
        ring = np.where(corrupt[src], fill[src], ring)
    return ragged_terms(
        n, np.concatenate([ar, win.edges[:, 0]]), np.concatenate([ar, ring]),
        np.concatenate([np.diagonal(win.w_eff).astype(np.float32), win.weights]), win.active)


def segment_terms(win, corrupt):
    """The term list ``core.flat.consensus_flat_segments_quarantined``
    builds for ``SparseWindow`` ``win`` when the agents ``corrupt`` ([N]
    bool) send fill rows and every payload is valid: fired edges, then self
    loops, the j-th corrupted agent's edges and self loop reading h row j;
    an idle corrupted agent passes its fill row through."""
    import numpy as np

    from repro_torch.kernels.launch_plan import ragged_terms

    n = win.n_agents
    ar = np.arange(n)
    tx = ar.copy()
    tx[corrupt] = n + np.arange(int(corrupt.sum()))
    return ragged_terms(
        n, np.concatenate([win.dst, ar]), np.concatenate([tx[win.src], tx]),
        np.concatenate([win.weights, win.self_weight.astype(np.float32)]), win.active,
        pass_src=tx)


def segment_cases():
    """Phase 2's cases: (name, terms, N, rows of x, P, rows of h, h dtypes,
    wp_first).  The delayed slice's window 4 over its K = 4 ring, without
    and with fill rows after the posterior (every third agent corrupted);
    edge-native windows of the N = 4,200 clock at a small P and at the
    full width 3.sparse runs, and of the N = 10,000 cell, every twentieth
    agent sending a fill row."""
    import numpy as np

    win = gossip_spec(clock=DELAYED_CLOCK).topology.gossip_clock().window(4)
    w4200 = sparse_spec().topology.gossip_clock().window(1)
    w1e4 = sparse_1e4_spec().topology.gossip_clock().window(1)
    c9, c4200, c1e4 = (np.arange(n) % m == 0 for n, m in ((9, 3), (SPARSE_N, 20),
                                                          (10_000, 20)))
    rings, f32 = ("f32", "bf16", "f16"), ("f32",)
    t4200 = segment_terms(w4200, c4200)
    return [("delayed_slice", delayed_terms(win, 4, 4), 9, 9, P_SLICE, 36, rings, True),
            ("delayed_fills", delayed_terms(win, 4, 4, c9), 9, 9 + int(c9.sum()), P_SLICE, 36,
             rings, True),
            ("sparse_4200", t4200, SPARSE_N, SPARSE_N, SEG_SMALL_P, int(c4200.sum()), rings,
             False),
            ("sparse_4200_full", t4200, SPARSE_N, SPARSE_N, P_SLICE, int(c4200.sum()), f32,
             False),
            ("sparse_1e4", segment_terms(w1e4, c1e4), 10_000, 10_000, 90, int(c1e4.sum()),
             rings, False)]


def check_segments(dev):
    """Phase 2, ``consensus_fused_segments`` against its plain version on the
    card, per wire and ring dtype on ``segment_cases``: two launches on the
    same inputs bitwise equal, bitwise PR 19's lane kernel and the tile
    kernel at one lane a thread, one device kernel a call."""
    import torch

    from repro_torch.kernels import consensus as k

    worst = {}
    for name, terms, n, n_x, p, n_h, rings, wp_first in segment_cases():
        terms = terms.to(dev)  # resident on the card: a call is the kernel alone
        mean, rho = seg_inputs(n_x, p, seed=n + p, device=dev)
        h_mean, h_rho = seg_inputs(n_h, p, seed=n + p + 1, device=dev)
        for ring in rings:
            dt = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[ring]
            hm, hr = h_mean.to(dt), h_rho.to(dt)
            for wire in WIRES:
                fn = functools.partial(k.consensus_fused_segments, terms, mean, rho, hm, hr,
                                       wire_dtype=wire, wp_first=wp_first)
                got, again = fn(), fn()
                bitwise = eq6_same_bits(f"consensus_fused_segments {name} twice", got, again)
                del again
                what = f"consensus_fused_segments {name} ring={ring} wire={wire}"
                # PR 19's lane kernel, and the tile kernel at one lane a thread: the same bits
                for instance in (0, 1):
                    eq6_same_bits(f"{what} instance {instance}", got, k._segments_launch(
                        terms, mean, rho, hm, hr, wire, wp_first, instance))
                errs = eq6_errors(what, got, k.consensus_segments_plain(
                    terms, mean, rho, hm, hr, wire, wp_first), wire)
                del got
                fields = {}
                if ring == wire == "f32":
                    work = captured_work(fn)
                    fields = {"variant": kernel_variant(fn, work),
                              "device_kernels_per_call": len(work)}
                phase("2.segments", case=name, n=n, n_x=n_x, p=p, n_h=n_h,
                      terms=terms.n_terms, ring=ring,
                      wire=wire, wp_first=wp_first, max_abs_err_mean=errs[0],
                      max_abs_err_rho=errs[1], twice_bitwise=bitwise,
                      lane_kernel_bitwise=True, one_lane_tile_bitwise=True,
                      tolerance=(f"{F32_TOL} + {F32_TOL} |plain|" if wire == "f32" else
                                 f"{WIRE_EPS[wire]} (|plain| + max |plain|)"), **fields)
                if (name, ring, wire) == ("delayed_slice", "f32", "f32"):
                    worst["consensus_fused_segments"] = max(errs)
        del mean, rho, h_mean, h_rho
    return worst


def sparse_iid_consensus(dev):
    """Phase 4.sparse_iid_consensus: ``sparse_spec(16)`` (3.sparse's iid
    data on 16 agents), two windows on the card, then the next window's
    local phase on the card with injected batches and noise, and that
    window's quarantined segments consensus with its fault draws, card
    (kernel) against CPU (plain version) on the same post-local posterior,
    at F32_TOL.  ``4.sparse_iid_parity`` compares a whole window of the
    same session, from the same state on the same draws."""
    import numpy as np
    import torch

    from repro_torch.api import build_session
    from repro_torch.core import flat

    spec = sparse_spec(16)
    card = build_session(spec, device=dev)
    card.run(n_rounds=2)
    n, p = card.posterior().mean.shape
    r = card.round_idx
    win = spec.topology.w_schedule()(r)
    g = torch.Generator().manual_seed(2024)
    u, b = spec.data.local_updates, spec.data.batch_size
    idx = torch.randint(0, 150, (n, u * b), generator=g)
    eps = torch.randn((n, u, 1, p), generator=g)
    faults = card.engine._fault_draws(r)
    post, _, _, active, _ = card.engine.local_phase(
        card.state, card.data.sampler(card.generator, r, idx=idx),
        torch.as_tensor(win.active, device=dev), eps.to(dev), None,
        torch.as_tensor(faults["up"], device=dev))
    args = (win.dst, win.src, win.weights, win.self_weight.astype(np.float32))
    kw = dict(corrupt=faults["corrupt"], fill_mean=faults["fill_mean"],
              fill_rho=faults["fill_rho"])
    got, valid = flat.consensus_flat_segments_quarantined(post, *args, active=active, **kw)
    post_cpu = flat.FlatPosterior(post.mean.cpu(), post.rho.cpu(), post.layout)
    want, valid_cpu = flat.consensus_flat_segments_quarantined(post_cpu, *args,
                                                               active=active.cpu(), **kw)
    errs = eq6_errors("4.sparse_iid_consensus", (got.mean.cpu(), got.rho.cpu()),
                      (want.mean, want.rho), "f32")
    same_valid = valid.cpu().tolist() == valid_cpu.tolist()
    phase("4.sparse_iid_consensus", agents=n, n_params=p, window=r,
          n_corrupt=int(faults["corrupt"].sum()), n_active=int(active.sum()),
          edges_dropped=int((~valid_cpu).sum()), max_abs_err_mean=errs[0],
          max_abs_err_rho=errs[1], tolerance=f"{F32_TOL} + {F32_TOL} |cpu|",
          validity_equal=same_valid)
    if not same_valid:
        raise AssertionError("4.sparse_iid_consensus: the guard's validity differs")


def ring_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in (state.hist_mean, state.hist_rho))


def run_delayed(dev, smi):
    """Phase 3.delayed: the gossip slice behind geometric delivery latency
    (K = 4 ring slots) under chaos faults, at full width: quarantine, strict,
    and quarantine with a bf16-resident ring, 4 windows each; counters
    around each run; then save -> load -> two resumed windows, bitwise, for
    both quarantined rings."""
    import numpy as np
    import torch

    from repro_torch.api import build_session
    from repro_torch.kernels import dispatch

    out = {}
    for tag, policy, ring in [("3.delayed", "quarantine", None),
                              ("3.delayed_strict", "strict", None),
                              ("3.delayed_bf16", "quarantine", "bf16")]:
        session = build_session(gossip_spec(policy, True, DELAYED_CLOCK, history_dtype=ring),
                                device=dev)
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        hist = session.run(n_rounds=4, eval_every=1)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        ev = session.evaluate()
        health = session.health()
        tel = ev["engine"]
        losses = [r["loss"] for r in hist]
        fields = dict(ring_dtype=str(session.state.hist_mean.dtype).removeprefix("torch."),
                      ring_shape=list(session.state.hist_mean.shape),
                      ring_bytes=ring_bytes(session.state), hist_slots=session.engine.hist_slots)
        if counts["consensus_fused_segments"] != 4 or session.engine.hist_slots != 4:
            raise AssertionError(f"{tag}: launches {counts}, slots {session.engine.hist_slots}")
        if policy == "quarantine":
            finite = bool(torch.isfinite(session.posterior().mean).all())
            if (not health["all_ok"] or not finite or counts["payload_validity_fused"] <= 0
                    or any(x is None or not np.isfinite(x) for x in losses)):
                raise AssertionError(f"{tag}: health {health}, launches {counts}")
        phase(tag, **fields, n_params=session.posterior().n_params(), losses=losses,
              n_trained=[r["n_trained"] for r in hist],
              n_crashed=[r.get("n_crashed") for r in hist], avg_acc=ev["avg_acc"],
              engine=tel, health=health["n_healthy"], launches=counts, run_s=run_s,
              nvidia_smi=smi)
        out[tag] = (session, counts)
    b32, b16 = (ring_bytes(out[t][0].state) for t in ("3.delayed", "3.delayed_bf16"))
    if b32 != 2 * 4 * 9 * P_SLICE * 4 or 2 * b16 != b32:
        raise AssertionError(f"3.delayed: ring bytes {b32} (f32) and {b16} (bf16)")
    for tag in ("3.delayed", "3.delayed_bf16"):
        session = out[tag][0]
        loaded, fields = save_and_load(f"{tag}_checkpoint", session, dev, smi)
        dispatch.reset_launch_counts()
        session.run(n_rounds=2)
        loaded.run(n_rounds=2)
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
        same = states_bitwise(session.state, loaded.state)
        phase(f"{tag}_checkpoint", **fields, ring_dtype=str(loaded.state.hist_mean.dtype),
              resumed_windows_bitwise=same, launches=counts)
        if not same or counts["consensus_fused_segments"] != 4:
            raise AssertionError(f"{tag}_checkpoint: bitwise {same}, launches {counts}")
    return out["3.delayed"]


def shape_recorder():
    """A ``TorchDispatchMode`` that records the shape of every tensor an
    operation returns (its class is built here: the module imports no
    torch at import time)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class ShapeRecorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.shapes.add(tuple(t.shape))
            return out

    return ShapeRecorder()


def run_sparse(dev, smi):
    """Phase 3.sparse: the edge-native path at full width on N = 4,200
    agents (above SPARSE_DENSE_GUARD), chaos faults and quarantine, 3
    windows with every tensor shape of the third recorded, then
    ``evaluate()``; counters around the windows; peak device memory; then
    phase 6's profile of one more window.  The session is freed after."""
    import gc

    import numpy as np
    import torch

    from repro_torch.api import build_session
    from repro_torch.api.spec import SPARSE_DENSE_GUARD
    from repro_torch.kernels import dispatch
    from repro_torch.obs import network_stats
    from repro_torch.vi.bayes_by_backprop import agent_blocks

    gc.collect()
    torch.cuda.empty_cache()  # the window holds most of the card: no cached blocks in the way
    t0 = time.perf_counter()
    session = build_session(sparse_spec(), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = session.data.n_agents
    torch.cuda.reset_peak_memory_stats(dev)
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    hist = session.run(n_rounds=2, eval_every=1)
    rec = shape_recorder()
    with rec:
        hist.append(session.round())
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    # the convergence statistic once on the N = 4,200 posterior, after the
    # timed windows: its column chunks must add at most 2 GiB to the phase
    post = session.posterior()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    stats = network_stats(post.mean, post.rho)
    torch.cuda.synchronize()
    stats_ms = (time.perf_counter() - t0) * 1e3
    stats_extra = torch.cuda.max_memory_allocated(dev) - held
    stats_added_to_peak = max(0, held + stats_extra - peak)
    ev = session.evaluate()
    health = session.health()
    losses = [r["loss"] for r in hist]
    n_by_n = sorted(sh for sh in rec.shapes if sh.count(n) >= 2)
    try:
        session.spec.topology.w_schedule()(0).w_eff
        dense_view_refused = False
    except ValueError:
        dense_view_refused = True
    tel = ev["engine"]
    phase("3.sparse", agents=n, n_params=session.posterior().n_params(), losses=losses,
          n_trained=[r["n_trained"] for r in hist], n_crashed=[r.get("n_crashed") for r in hist],
          avg_acc=ev["avg_acc"], quarantined=tel["faults"]["quarantined"]["total"],
          health=health["n_healthy"], launches=counts, setup_s=setup_s, run3_s=run_s,
          max_memory_allocated=peak, max_memory_reserved=peak_reserved,
          card_memory=torch.cuda.get_device_properties(dev).total_memory,
          allocator_conf=os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
          local_step_blocks=len(agent_blocks(n, session.posterior().n_params())),
          shapes_recorded=len(rec.shapes), n_by_n_shapes=n_by_n,
          dense_view_refused=dense_view_refused, network_stats=stats,
          network_stats_ms=stats_ms, network_stats_extra_bytes=stats_extra,
          network_stats_added_to_peak_bytes=stats_added_to_peak, nvidia_smi=smi)
    if (n <= SPARSE_DENSE_GUARD or session.posterior().n_params() != P_SLICE or n_by_n
            or stats_extra > STATS_EXTRA_MAX or not all(np.isfinite(list(stats.values())))
            or not dense_view_refused or not health["all_ok"]
            or counts["consensus_fused_segments"] != 3 or counts["payload_validity_fused"] <= 0
            or any(x is None or not np.isfinite(x) for x in losses)):
        raise AssertionError(f"3.sparse: losses {losses}, health {health}, launches {counts}, "
                             f"[N, N] shapes {n_by_n}")
    profile_round("6.sparse_profile", session, rounds=2)
    del session, rec
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def run_sparse_1e4(dev, smi):
    """Phase 3.sparse_1e4: the reference's population cell (N = 10,000,
    P = 90), 3 windows and ``evaluate()``, counters around the windows; then
    save -> load -> one resumed window, bitwise."""
    import numpy as np
    import torch

    from repro_torch.api import build_session
    from repro_torch.kernels import dispatch

    session = build_session(sparse_1e4_spec(), device=dev)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    hist = session.run(n_rounds=3, eval_every=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    ev = session.evaluate()
    loaded, fields = save_and_load("3.sparse_1e4", session, dev, smi)
    session.round()
    loaded.round()
    torch.cuda.synchronize()
    same = states_bitwise(session.state, loaded.state)
    losses = [r["loss"] for r in hist]
    phase("3.sparse_1e4", agents=session.data.n_agents, n_params=session.posterior().n_params(),
          losses=losses, avg_acc=ev["avg_acc"], staleness=ev["engine"]["staleness"],
          merges=ev["engine"]["merges"], launches=counts, run3_s=run_s, **fields,
          resumed_window_bitwise=same)
    if (not same or counts["consensus_fused_segments"] != 3
            or any(x is None or not np.isfinite(x) for x in losses)):
        raise AssertionError(f"3.sparse_1e4: bitwise {same}, launches {counts}, losses {losses}")
    return counts


def cuda_ms(fn, flush=None, reps=20):
    """Median device time of one call, from CUDA events around each call.

    The calls are queued behind a GPU spin (``torch.cuda._sleep``), so the
    host has enqueued all of them before the device reaches the first: the
    events then time the device alone, not the host's launch overhead.  If
    the spin ends before the host is done, the spin is doubled and the
    timing repeated.  ``reps`` stays small enough that every launch fits in
    the device's queue (about a thousand entries; a full queue stalls the
    host until the spin ends).  ``flush``, a call queued before each timed
    call and outside its events, evicts the inputs from L2 (cold inputs;
    ``Flush.dirty`` or ``Flush.clean``); without, the inputs stay in L2 as
    on the main path, where the consensus reads the buffers the last local
    step just wrote."""
    import torch

    fn()
    for spin_cycles in (2 ** k * 200_000_000 for k in range(6)):  # ~0.1 s .. ~3 s
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles)
        events = []
        for _ in range(reps):
            if flush is not None:
                flush()
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


class Flush:
    """Two ways to evict L2 (50 MB) with a 128 MiB buffer before a timed call.

    ``dirty`` overwrites the buffer: L2 is left holding ~50 MB of modified
    lines, which the timed call's own traffic then writes back to HBM inside
    its window.  ``clean`` reads the buffer into a sum: L2 is left holding
    unmodified lines that the timed call drops for free, so its window holds
    its own reads and writes only."""

    def __init__(self, dev):
        import torch

        self.buf = torch.zeros(32 * 2 ** 20, dtype=torch.float32, device=dev)
        self.sink = torch.zeros((), dtype=torch.float32, device=dev)

    def dirty(self):
        self.buf.zero_()

    def clean(self):
        import torch

        torch.sum(self.buf, dim=0, out=self.sink)


def timings(dev, counts, errs):
    """Phase 5: kernel, plain version and bound at the slice's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core import graphs
    from repro_torch.core.flat import neighbor_tables
    from repro_torch.kernels import consensus as k
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gauss_vi
    from repro_torch.launch.costmodel import consensus_roofline

    n, p = 9, P_SLICE
    flush = Flush(dev)
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
    network = functools.partial(k.consensus_fused_network, W, mean, rho)
    masked = functools.partial(k.consensus_fused_masked, W_win, act, mean, rho)
    sparse = functools.partial(k.consensus_fused_sparse, nbr_b, wts_b, mean, rho)
    masked_sparse = functools.partial(k.consensus_fused_masked_sparse, nbr_w, wts_w, act, mean,
                                      rho)
    row = functools.partial(k.consensus_fused, W[0], mean, rho)
    # the delayed slice's window 4: 7 self terms, 10 events over the K = 4 ring, one pad term
    dwin = gossip_spec(clock=DELAYED_CLOCK).topology.gossip_clock().window(4)
    seg_terms = delayed_terms(dwin, 4, 4)
    seg_terms_dev = seg_terms.to(dev)  # resident on the card, as phase 2's
    h_mean, h_rho = seg_inputs(4 * n, p, seed=8, device=dev)
    segments = functools.partial(k.consensus_fused_segments, seg_terms_dev, mean, rho,
                                 h_mean, h_rho, wp_first=True)
    seg_lane = functools.partial(k._segments_launch, seg_terms_dev, mean, rho, h_mean, h_rho,
                                 None, True, 0)  # PR 19's lane kernel, the same bits
    seg_idle = seg_terms.row_ptr[1:] == seg_terms.row_ptr[:-1]
    seg_rows_read, seg_plan_bytes = segments_reads(seg_terms)
    read_bytes = {  # what each call reads of HBM when L2 is cold (the inputs, once)
        "consensus_fused_network": 8 * n * p + 4 * n * n,
        "payload_validity_fused": 8 * n * p,
        "consensus_fused_masked": 8 * n * p + 4 * n * n + n,
        "consensus_fused_sparse": 8 * n * p + 8 * n * d_b,
        "consensus_fused_masked_sparse": 8 * p * rows_read + 8 * n * d_w + n,
        "consensus_fused": 8 * n * p + 4 * n,
        "sample_and_kl_fused": 20 * p,
        "consensus_fused_segments": 8 * p * seg_rows_read + seg_plan_bytes,
    }
    kernels = [  # name, source, replaces, kernel, plain, bytes, ops, peak, library, fields
        ("consensus_fused_network", "consensus_network.cu", REF + "195", network,
         lambda: k.consensus_network_plain(W, mean, rho), eq6_bytes, eq6_ops, fp32, None,
         launch_fields(network, launch_floor_ms)),
        ("payload_validity_fused", "payload_validity.cu", REF + "436", validity,
         lambda: k.payload_validity_plain(mean, rho, bound=1e20),
         8 * n * p + n, 20 * n * p, fp32, None,  # mean, rho in; [N] bool out
         launch_fields(validity, launch_floor_ms)),
        ("consensus_fused_masked", "consensus_network.cu", REF + "261", masked,
         lambda: k.consensus_masked_plain(W_win, act, mean, rho),
         eq6_bytes + n, eq6_ops, fp32, None,  # + the [N] bool mask
         dict(launch_fields(masked, launch_floor_ms), window=win.index, n_active=n_act)),
        ("consensus_fused_sparse", "consensus_sparse.cu", REF + "355", sparse,
         lambda: k.consensus_sparse_plain(nbr_b, wts_b, mean, rho),
         16 * n * p + 8 * n * d_b,  # every row read once; tables
         gathered_ops * n * d_b * p + out_ops * n * p, fp32, None,
         dict(launch_fields(sparse, launch_floor_ms), d=d_b)),
        ("consensus_fused_masked_sparse", "consensus_sparse.cu", REF + "529", masked_sparse,
         lambda: k.consensus_masked_sparse_plain(nbr_w, wts_w, act, mean, rho),
         8 * p * rows_read + 8 * n * p + 8 * n * d_w + n,  # rows read; out; tables; mask
         gathered_ops * n_act * d_w * p + out_ops * n_act * p, fp32, None,
         dict(launch_fields(masked_sparse, launch_floor_ms), window=win.index, n_active=n_act,
              d=d_w, rows_read=rows_read)),
        ("consensus_fused", "consensus_row.cu", REF + "131", row,  # one agent's row of W
         lambda: k.consensus_row_plain(W[0], mean, rho),
         8 * n * p + 8 * p + 4 * n,  # mean, rho in; the agent's mean, rho out; w_row
         gathered_ops * n * p + out_ops * p, fp32, None, launch_fields(row, launch_floor_ms)),
        ("sample_and_kl_fused", "gauss_vi.cu", "src/repro/kernels/gauss_vi.py:46", sample_kl,
         lambda: gauss_vi.sample_and_kl_plain(*vi_args),
         24 * p + 4,  # five [P] in, theta [P] and the KL out
         30 * p, fp32, None,  # two softplus, a log, two divisions, sample, sum per lane
         {**launch_fields(sample_kl, launch_floor_ms),
          "aligned_variant": kernel_variant(sample_kl_aligned),
          "aligned_ms": cuda_ms(sample_kl_aligned),
          "aligned_cold_l2_ms": cuda_ms(sample_kl_aligned, flush.dirty),
          "aligned_cold_l2_clean_ms": cuda_ms(sample_kl_aligned, flush.clean)}),
        ("consensus_fused_segments", "consensus_segments.cu", "src/repro/core/flat.py:522",
         segments,  # no pallas_call: the reference's XLA scatter-add
         lambda: k.consensus_segments_plain(seg_terms_dev, mean, rho, h_mean, h_rho, None,
                                            True),
         8 * p * seg_rows_read + 8 * n * p + seg_plan_bytes,  # distinct rows read; out; plan
         gathered_ops * seg_terms.n_terms * p + out_ops * int((~seg_idle).sum()) * p, fp32, None,
         dict(launch_fields(segments, launch_floor_ms), window=dwin.index,
              n_active=int((~seg_idle).sum()), terms=seg_terms.n_terms, rows_read=seg_rows_read,
              term_bytes=8 * p * seg_terms.n_terms, **lane_kernel_fields(seg_lane, flush),
              plain_reps=5)),  # its plain version runs 78 ops a call: 20 calls overfill the queue
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
        fields["read_bytes"] = q.element_size() * 3 * b * h * s * hd  # q, k, v
        kernels.append((
            "flash_attention", "flash_attention_tc.cu", "src/repro/kernels/flash_attention.py:94",
            kern, plain,
            q.element_size() * 4 * b * h * s * hd,  # q, k, v in; out
            4 * hd * pairs * b * h, BF16_FLOP_PER_S, sdpa, fields))
    single = [(name, f["device_kernels_per_call"]) for name, *_, f in kernels
              if "device_kernels_per_call" in f]
    if any(count != 1 for _, count in single):
        raise AssertionError(f"5.timing: a wrapper ran more than one device kernel: {single}")
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
            "plain_ms": cuda_ms(plain, reps=fields.get("plain_reps", 20)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if library is None else cuda_ms(library),
        }
        attention = "shape" in fields
        if name in ("consensus_fused_network", "consensus_fused_masked"):
            modeled = consensus_roofline(n, p, 1)["roofline_seconds"]["flat_fused"] * 1e3
            fields = dict(fields, costmodel_bound_ms=modeled)
            if abs(modeled - row["bound_ms"]) > COSTMODEL_RTOL * row["bound_ms"]:
                raise AssertionError(f"5.timing {name}: bound {row['bound_ms']} ms, cost "
                                     f"model {modeled} ms")
        if attention:
            fields = dict(fields, tflops=ops / row["ms"] / 1e9,
                          bound_share=row["bound_ms"] / row["ms"],
                          sdpa_over_kernel=row["library_ms"] / row["ms"])
        else:
            fields = dict(fields, n=n, p=p, read_bytes=read_bytes[name])
        fields["launch_floor_ms"] = launch_floor_ms
        cold, clean = cuda_ms(fn, flush.dirty), cuda_ms(fn, flush.clean)
        less, clean_less = row["ms"] - launch_floor_ms, clean - launch_floor_ms
        phase("5.timing", name=name, ms=row["ms"], plain_ms=row["plain_ms"],
              library_ms=row["library_ms"], cold_l2_ms=cold, cold_l2_clean_ms=clean,
              cold_l2_plain_ms=cuda_ms(plain, flush.dirty, fields.get("plain_reps", 20)),
              bound_ms=row["bound_ms"],
              ms_less_floor=less, cold_l2_clean_ms_less_floor=clean_less,
              bound_share_less_floor=row["bound_ms"] / less,
              clean_cold_bound_share_less_floor=row["bound_ms"] / clean_less,
              dirty_minus_clean_ms=cold - clean,
              read_bytes_over_hbm_ms=fields["read_bytes"] / HBM_BYTES_PER_S * 1e3,
              bytes=nbytes, ops=ops, **fields)
        if not attention or fields["shape"] == "qwen3_8b":
            rows.append(row)
    time_segments_4200(dev, counts.get("consensus_fused_segments_4200"), launch_floor_ms, flush)
    return rows


def segments_reads(terms):
    """(distinct source rows, term list bytes) of one ``consensus_fused_
    segments`` call: the rows its terms read and its idle rows copy, each
    read once; the offsets, sources, weights and pass-through indices."""
    import numpy as np

    idle = terms.row_ptr[1:] == terms.row_ptr[:-1]
    passed = np.flatnonzero(idle) if terms.pass_src is None else terms.pass_src[idle]
    plan = 4 * (terms.n_rows + 1) + 8 * terms.n_terms  # offsets; int32 source, f32 weight
    if terms.pass_src is not None:
        plan += 4 * terms.n_rows
    return len(np.union1d(terms.src, passed)), plan


def lane_kernel_fields(lane, flush):
    """Phase 5's times of PR 19's lane kernel (``_segments_launch(...,
    instance=0)``) beside the tile kernel's, on the same inputs."""
    return {"lane_variant": kernel_variant(lane), "lane_kernel_ms": cuda_ms(lane),
            "lane_kernel_cold_l2_clean_ms": cuda_ms(lane, flush.clean)}


def event_ms(fn, reps=3):
    """Median device time of a call that launches too many kernels to
    queue behind ``cuda_ms``'s spin: CUDA events around each call."""
    import torch

    fn()
    ms = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    return sorted(ms)[reps // 2]


def time_segments_4200(dev, launches, launch_floor_ms, flush):
    """Phase 5's line of ``consensus_fused_segments`` at N = 4,200 and full
    width on phase 2's ``sparse_4200_full`` term list (3.sparse's window 1,
    every twentieth agent sending a fill row): the tile kernel, PR 19's lane
    kernel and the plain version, beside the byte bound; the buffers are
    freed after."""
    import gc

    import torch

    from repro_torch.kernels import consensus as k

    _, terms, n, n_x, p, n_h, _, wp_first = next(c for c in segment_cases()
                                                 if c[0] == "sparse_4200_full")
    g = torch.Generator(dev).manual_seed(4200)  # made on the card: 7 GB of inputs
    mean, h_mean = (torch.randn((r, p), generator=g, device=dev) for r in (n_x, n_h))
    rho, h_rho = (torch.rand((r, p), generator=g, device=dev) * 5.0 - 4.5 for r in (n_x, n_h))
    terms_dev = terms.to(dev)
    fn = functools.partial(k.consensus_fused_segments, terms_dev, mean, rho, h_mean, h_rho,
                           wp_first=wp_first)
    lane = functools.partial(k._segments_launch, terms_dev, mean, rho, h_mean, h_rho, None,
                             wp_first, 0)
    rows_read, plan_bytes = segments_reads(terms)
    nbytes = 8 * p * rows_read + 8 * n * p + plan_bytes
    active = int((terms.row_ptr[1:] > terms.row_ptr[:-1]).sum())
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ms, clean = cuda_ms(fn), cuda_ms(fn, flush.clean)
    phase("5.timing", name="consensus_fused_segments", case="sparse_4200_full", n=n, p=p,
          n_h=n_h, terms=terms.n_terms, n_active=active, rows_read=rows_read,
          launches=launches, ms=ms, cold_l2_clean_ms=clean, bound_ms=bound_ms,
          bound_by="bytes", bytes=nbytes, ms_less_floor=ms - launch_floor_ms,
          bound_share_less_floor=bound_ms / (ms - launch_floor_ms),
          plain_ms=event_ms(lambda: k.consensus_segments_plain(terms_dev, mean, rho, h_mean,
                                                               h_rho, None, wp_first)),
          plain_timer="events around each call (its ~800 launches overfill the spin's queue)",
          plain_reps=3, **launch_fields(fn, launch_floor_ms),
          **lane_kernel_fields(lane, flush))
    del mean, rho, h_mean, h_rho, terms_dev, fn, lane
    gc.collect()
    torch.cuda.empty_cache()


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
    from repro_torch.api import build_session
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

    if "--timings" in sys.argv[1:]:  # phases 1, 5 and 6 only: to compare two trees
        rows = timings(dev, dict.fromkeys(dispatch.KERNELS), dict.fromkeys(dispatch.KERNELS))
        session = build_session(fig4_spec(), device=dev)
        session.run(n_rounds=1)
        profile_round("6.profile", session)
        print(smi)
        print(json.dumps({"kernels": rows}))
        return 0
    errs = check_kernels(dev)
    errs.update(check_ops_kernels(dev))
    errs.update(check_segments(dev))
    session, counts, prior, slice_run_s = run_slice(dev)
    l_session, l_counts = run_launch(dev, session)
    run_launch_checkpoint(dev, smi, l_session)
    gossip = run_gossip(dev)
    g_session, g_counts = gossip["3.gossip"]
    csr_counts = run_csr(dev, g_session)
    ops_counts = run_ops(dev, session, prior)
    d_session, d_counts = run_delayed(dev, smi)
    sp_counts = run_sparse(dev, smi)
    run_sparse_1e4(dev, smi)
    run_serve(dev, session, smi)  # after 3.sparse: its graphs stay out of that peak
    run_obs(dev, smi, slice_wall_ms=slice_run_s * 1e3 / 3)
    run_obs_gossip(dev, smi)
    card_vs_cpu("4.parity", session, fig4_spec())
    card_vs_cpu("4.launch_parity", l_session, launch_spec())
    card_vs_cpu("4.gossip_parity", g_session, gossip_spec())
    card_vs_cpu("4.delayed_parity", d_session, gossip_spec(clock=DELAYED_CLOCK))
    s_session = build_session(sparse_slice_spec(), device=dev)
    s_session.run(n_rounds=4)
    card_vs_cpu("4.sparse_parity", s_session, sparse_slice_spec())
    del s_session
    sparse_iid_consensus(dev)
    iid = build_session(sparse_spec(16), device=dev)  # the session ROADMAP C.3 failed on
    iid.run(n_rounds=2)
    card_vs_cpu("4.sparse_iid_parity", iid, sparse_spec(16))
    del iid
    ladders(dev)
    run_checkpoint(dev, smi)
    run_gossip_checkpoint(dev, smi)
    run_linreg(dev, smi)
    run_discrete(dev)
    launches = {  # each kernel's launches on the path that runs it
        "consensus_fused_network": counts["consensus_fused_network"],
        "payload_validity_fused": g_counts["payload_validity_fused"],
        "consensus_fused_masked": g_counts["consensus_fused_masked"],
        "consensus_fused_sparse": csr_counts["consensus_fused_sparse"],
        "consensus_fused_masked_sparse": csr_counts["consensus_fused_masked_sparse"],
        "consensus_fused": ops_counts["consensus_fused"],
        "sample_and_kl_fused": ops_counts["sample_and_kl_fused"],
        "flash_attention": ops_counts["flash_attention"],
        "consensus_fused_segments": d_counts["consensus_fused_segments"],
        "consensus_fused_segments_4200": sp_counts["consensus_fused_segments"],
    }
    rows = timings(dev, launches, errs)
    profile_round("6.profile", session)
    profile_round("6.gossip_profile", g_session)
    profile_round("6.delayed_profile", d_session)
    profile_round("6.launch_profile", l_session)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
