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
   f16 (bf16/f16 on the tensor-core kernel, f32 on the 3xTF32 kernel), at
   every head dim 32-256 on ragged tiles at each dtype, on a case
   with Sk < S whose window leaves rows with no key (zeros) at each dtype,
   and at B = 70,000 or H = 70,000 (S = 64, hd = 32) at f32 and bf16;
   ``consensus_fused_segments`` at every wire dtype on the term lists the
   paths build: the delayed slice's window 4 (N = 9, P = 199,210, a K = 4
   ring at f32, bf16 and f16), the same with fill rows after the posterior
   (the corrupted senders' layout), an edge-native window of the N = 4,200
   clock below with fill rows at P = 1,024 and at the full P = 199,210
   that ``3.sparse`` runs, and one of the N = 10,000 cell (P = 90), two
   launches bitwise equal, bitwise PR 19's lane kernel and the tile kernel
   at one lane a thread, one device kernel a call; ``2.shard``: the
   sharded windows' ``consensus_shard_encode`` and ``consensus_fused_shard``
   at N = 9, P = 199,210 over 3 and 9 shards at every wire dtype, against
   their plain versions, every reduced row bitwise the masked kernel's row
   (small and generic instance), on finite and on poisoned inputs;
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
   ``evaluate()``, save -> load -> one resumed window, bitwise.
   ``3.sharded`` (after ``3.gossip``): the gossip slice on
   ``consensus_impl="ppermute"``, 4 windows, over 3 virtual shards of the
   card at wire f32 and bf16, over 9 at f32, and over the real cards where
   more than one divides N = 9 (``3.sharded_cards`` says which): each
   window's wall ms, rotations and copied bytes beside the cost model's
   ``window_ppermute`` bytes (equal; bf16 half of f32), and its 4.ladder
   rungs right after (``sharded==masked`` at f32 against 3.gossip's state
   and at bf16, ``sharded_quarantine0==sharded_strict`` over 9 shards,
   ``obs_on==obs_off(sharded)``).  The model zoo's dense serving path
   (after ``3.obs_gossip``, once ``3.sparse`` has released its memory):
   ``3.lm_qwen3_8b``, Qwen3-8B at full width and depth for A = 2 agents
   and B = 2 prompts each, bf16 weights from ``init_params`` (agent i
   from seed i): ``make_prefill_step`` of S = 4096 Zipf tokens into a
   4,128-slot cache (first and warm; ``flash_attention`` 36 times a
   prefill), 32 decode steps (tokens/s), the prefill of S + 1 against the
   first decode step (``LM_BF16_ATOL`` / ``LM_BF16_RMS`` on bf16 logits;
   a decode one position late must fail it), ``window_override`` 1024 on
   a 1024-slot ring (prefill, 8 steps, the same check), 8 steps on an
   int8 cache, agent 1's prefill against a forward of its weights alone
   (agent 0's weights must fail it), the peak memory, the prefill's FLOP
   bound and the decode step's byte bound, a profile of one prefill and
   one decode step, layer 0's attention on the prefill's own q/k/v
   through the kernel route against the plain version (``ATT_BF16_REL``
   of |plain| plus of its row's rms; the plain version that drops up to
   64 keys must fail it), and ``flash_attention`` at that shape ([4, 32,
   4096, 128], causal and window 1024) beside SDPA; ``3.lm_repro100m``,
   repro-100m (P = 163,597,056 an agent), A = 2: ``init_train_state``,
   one ``make_consensus_step`` over ``LM_ZOO_W`` (``consensus_fused_network``
   at N = 2, held against its plain version, timed against 16 N P bytes),
   ``serve_params`` and prefill (S = 512) + 8 decode steps at bf16 (the
   tensor-core kernel) and f32 (the 3xTF32 kernel, 12 launches), each
   against the same steps on the CPU (f32 1e-4, bf16 as above) and each
   agent's prefill against its weights alone (the other agent's must fail
   it).  The MoE and recurrent configs (``run_lm_new``): ``3.lm_olmoe``,
   ``3.lm_recurrentgemma`` and ``3.lm_xlstm`` at full width (and depth;
   the xLSTM at 24 of its 48 blocks, ``LM_NEW``), A =
   2 (seeds 0, 1), B = 2 prompts of S = 4096, bf16: prefill into a
   4,128-slot cache (first and warm, each into a fresh cache), 8 decode
   steps, the prefill's FLOP bound (bf16 GEMMs and the mLSTM's fp32 chunk
   products) and the step's byte bound, peak memory, profiles; read, not
   held, the whole model's decode after a prefill of S against the prefill
   of S + 1 (OLMoE at capacity_factor E / k, rows routed apart not read)
   and agent 1 stacked against alone; held, every layer on the same input
   (``layer_checks``): its decode against its no-cache run and agent 1's
   block alone against the stacked one (``LAYER_BF16_*``), with a decode
   after the other row's prompt as the control; the MoE's layer 0 twice,
   bit for bit; ``flash_attention`` (16 and 12 launches a prefill) at
   [4, 16, 4096, 128] causal and [4, 16, 4096, 256] window 2048 against
   its plain version (the 64-key drop as the control) and beside SDPA.
   ``3.lm_zoo_reduced``: the four MoE and recurrent configs, Whisper-tiny
   and Pixtral-12B at ``reduced()`` size (Phi-3.5-MoE runs only there),
   prefill and 4 decode steps, card against CPU at f32 (``ZOO_F32_ATOL``)
   and bf16 (an MoE config at capacity_factor E / k, the rows routed alike
   held), and the card's ``moe_ffn`` twice, bit for bit.  ``3.lm_train``: LM training at
   repro-100m's full width (A = 2 on complete_w(2), Adam, batch 8 of S =
   256 Zipf tokens an agent, u = 4, lr 1e-3 decaying 0.99 a round,
   kl_scale 1e-4, bf16 compute): ``launch.train``'s ``main`` for 3 rounds
   (``consensus_fused_network`` once a round, ``flash_attention`` never),
   3 round steps, one u = 4 round and a ``bayesian=False`` step (KL 0),
   each timed; profiles of a round and a local step; 10 round steps on one
   batch (the loss must fall); peak memory; the step against
   ``analytic_costs``' bound; and one u = 2 round of repro-100m, OLMoE,
   RecurrentGemma and xLSTM at ``reduced()`` size and f32, card against CPU
   (``train_parity``), each with a control (the agents' tokens swapped) that
   must fail.  The enc-dec and VLM configs (``run_lm_new``, after
   ``3.lm_train``): ``3.lm_whisper``, Whisper-tiny at full width and depth
   (4 + 4 layers), A = 2 (seeds 0, 1), 8 clips an agent of 1,500 frames
   (normal x 0.1) with prompts of 224 Zipf tokens into 256-slot caches, 32
   decode steps each re-running the encoder (the reference's contract):
   held with controls, the decode against the prefill of S + 1 (control: a
   decode after half the prompt; the other row's prompt is read, since the
   rows' inputs are alike at this init), agent 1 stacked against alone
   (control: agent 0's weights), every encoder layer stacked against alone
   (control: agent 0's block) and every decoder layer by ``layer_checks``
   with its cross-attention; ``flash_attention`` 12 times a prefill and 4
   a decode step, held against its plain version at the encoder's [16, 6,
   1500, 64] (non-causal), the cross-attention's [16, 6, 224, 64] over
   1,500 keys and the decoder's causal [16, 6, 224, 64], each beside SDPA;
   the decode bound with and without the encoder re-run, and the encoder's
   own time (``models.transformer.encode``) over the median decode step.
   ``3.lm_whisper_train``: one round step and one u = 4 round of
   Whisper-tiny at full width (A = 2 on complete_w(2), 8 clips of 1,500
   frames and 224 tokens an agent, Adam, bf16 compute): finite losses, the
   loss falling over 10 round steps on one batch, ``consensus_fused_network``
   once a consensus, ``flash_attention`` never, a profile, peak memory.
   ``3.lm_pixtral``: Pixtral-12B at full width and depth (40 layers, GQA
   32 / 8, hd 128), A = 2 x 2 prompts of 256 patches (normal x 0.1) and
   3,840 Zipf tokens (S = 4,096) into 4,128-slot caches, 32 decode steps,
   starting with next to nothing allocated (printed): the whole-model and
   per-layer checks with their controls, ``flash_attention`` 40 times a
   prefill at [4, 32, 4096, 128].  ``3.lm_train_pod``: the LM mesh's pod
   axis at repro-100m's full width, A = 2 on LM_ZOO_W, 3.lm_train's
   batch and optimiser, a flat and a pytree state (``init_train_state(flat=
   False)``) of one seed on a (2, 1, 1) ``("pod", "data", "model")`` mesh
   of virtual shards: ``consensus_ppermute_pod`` at the bf16 wire bitwise
   ``consensus_ppermute_ring_flat``, leaf by leaf (control: W's rows
   swapped), its rotated bytes 2 A P 2 B; one ppermute round step of each
   form from one ``eps``, the pytree's within 1e-4 (``train_parity``) of
   the flat one; 3 round steps of each form timed (device and wall ms,
   kernels a step, peak memory) beside the step's bound; the trained
   pytree posterior's prefill (S = 512, ``flash_attention`` once a layer)
   bitwise its flat form's; over two real cards where the host has them,
   the pod consensus bitwise the virtual run.  ``3.lm_spmd``: the
   sharded LM steps (``launch.spmd_steps`` through ``launch.steps`` on
   inputs placed by ``launch.spmd.device_put``) over a ``("pod", "data",
   "model")`` mesh of virtual shards, single controller: Qwen3-8B at full
   width and depth on (2, 2, 2) with 3.lm_qwen3_8b's weights and prompts,
   a prefill and SPMD_DECODE decode steps against the unsharded steps of
   the same call (``LM_BF16_*``; control: the agents swapped),
   ``flash_attention`` 288 times a prefill, the gathered and all-reduced
   bytes equal to ``spmd_steps.forward_gather_bytes``, each position's
   placed bytes equal to ``sharding_report``'s, ms beside the unsharded
   steps', peak memory, and ``flash_attention`` at a position's [1, 16,
   4096, 128]; repro-100m at full width and float32 compute, a pytree
   round step on (2, 2, 2) within ``train_parity`` of the unsharded one
   and a flat one on (2, 1, 1) bitwise, each with its network-kernel
   launches (one a (data, model) position), bytes, ms, kernels and peak,
   and ``consensus_fused_network`` at a position's block; over two real
   cards where the host has them, bitwise the virtual runs.
   ``3.lm_spmd_kinds``: the ``moe``, ``local_attn`` and ``rglru`` kinds and
   tied embeddings under data x model on the same (2, 2, 2) mesh:
   OLMoE-1B-7B (capacity factor E / k) and RecurrentGemma-9B at full width
   and depth with 3.lm_olmoe's and 3.lm_recurrentgemma's weights and
   prompts, a prefill and SPMD_DECODE decode steps against the unsharded
   steps of the same call (``SPMD_KINDS_BF16``; OLMoE on the rows routed
   alike; control: the agents swapped), ``flash_attention`` 128 and 96
   times a prefill, the moved bytes equal to the formula, placed bytes to
   ``sharding_report``'s, ms and peak memory, ``flash_attention`` at a
   position's [1, 8, 4096, 128] and [1, 8, 4096, 256] (window 2,048);
   reduced OLMoE and Phi-3.5-MoE at f32 and capacity factor 0.5, the
   placed steps' drops equal to the unsharded dispatch's; the pytree round
   of reduced OLMoE and RecurrentGemma on (2, 2, 2) within
   ``train_parity``; RecurrentGemma's placed bf16 parting read layer by
   layer on SPMD_LAYER_READ_S tokens (``placed_layers``); over two real
   cards where the host has them, bitwise the virtual run.
   ``3.lm_spmd_xlstm_whisper``: the ``mlstm`` / ``slstm`` and ``enc_attn``
   / ``dec_attn`` kinds under data x model on the same mesh: xLSTM-1.3B at
   full width and depth (SPMD_XLSTM_S-token prompts), every block held
   placed against unsharded on the same input (``LAYER_BF16_*``; control:
   the agents swapped), the whole model's logits read, the mLSTM's ``m``
   bitwise over ``model``; Whisper-tiny at full width and depth within
   ``LM_BF16_*`` of the unsharded steps (control: the agents swapped), 96
   ``flash_attention`` launches a prefill; for both the moved bytes equal
   to the formula, placed bytes to ``sharding_report``'s, ms and peak
   memory; ``flash_attention`` at a position's encoder [4, 3, 1500, 64]
   and cross-attention [4, 3, 224, 64] over 1,500 keys; the pytree round
   of reduced xLSTM and of Whisper-tiny at full width on (2, 2, 2), f32,
   within ``train_parity``; over two real cards where the host has them,
   bitwise the virtual run.  ``3.lm_spmd_consensus``: the placed train
   round's other routes at repro-100m's full width, f32, on (2, 2, 2), W
   ``SPMD_WIRE_W``: the flat state at the f32 and bf16 einsum and at
   ppermute, the pytree state at the bf16 einsum and at ppermute, each
   against the unsharded round of its route within ``train_parity`` (the
   priors' bf16 wire-boundary lanes held within a bf16 place), the
   ppermute prior bitwise the unplaced ring's, the flat rows bitwise alike
   over a pod's positions, the eq. (6) gathers, rotations and the flat
   rows' re-join equal to their formulas, ms and peak memory, and the
   network kernel at a position's block at the bf16 wire with W rounded
   (row ``consensus_fused_network_spmd_wire``).  ``3.moe_ep``: the
   expert-parallel MoE layer at full width (OLMoE-1B-7B over a (1, 8)
   ``("data", "model")`` mesh, Phi-3.5-MoE over (1, 4), 16,384 bf16
   tokens, ``moe_init`` weights at seed 0 in bf16): at capacity factor 16
   against ``moe_ffn`` (``LAYER_BF16_*``; control: top-(k - 1) routing),
   two calls the same bits, and at 1.25 the drop share, the all-to-all
   bytes a shard against (m - 1) cap D 2 B, and ms a call beside
   ``moe_ffn``'s; over real cards, where more than one, bitwise the virtual
   run;
4. card vs CPU: one more synchronous round and one more gossip window from
   the same state with the same injected batches and noise, the card through
   the kernels, the CPU through the plain versions, and likewise one more
   delayed window, one more sharded window (3 virtual shards on each
   device, ``4.sharded_parity``) and one more edge-native window (the slice's data on a
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
   ulps); ``flash_attention`` at f32 (the 3xTF32 kernel) at Qwen3-8B's and
   RecurrentGemma-9B's rows, Whisper-tiny's encoder and repro-100m's
   prefill (``ATTN_F32_SHAPES``), each a row beside SDPA on the same f32
   tensors, its bound 3 x 4 hd flops a pair at the TF32 rate; for
   ``consensus_fused_shard`` and ``consensus_shard_encode`` on one shard
   of 3 rows (3.sharded's first run; gossip window 1's W-tilde); for
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
line describing the kernels (``flash_attention_f32`` /
``flash_attention_f32_recurrentgemma`` / ``_whisper_enc`` / ``_repro100m``:
the f32 kernel's time at each shape of ``ATTN_F32_SHAPES``, with its
launches in 3.lm_repro100m's f32 prefill on the ``_repro100m`` row and 0 on
the others, whose shapes no path here runs; ``flash_attention_lm``: the kernel's
launches on the model zoo's path and its time at the Qwen3-8B prefill's
shape;
``consensus_fused_network_zoo``: eq. (6) on the zoo posterior;
``flash_attention_olmoe`` / ``flash_attention_recurrentgemma`` /
``flash_attention_whisper_enc`` / ``_xattn`` / ``_dec`` /
``flash_attention_pixtral``: its launches in those phases' first prefill
and its time at their prefills' shapes;
``consensus_fused_network_train``: eq. (6) on the trained posterior, its
launches in ``launch.train``'s 3 rounds; ``flash_attention_train_pod``:
its launches in 3.lm_train_pod's two prefills and its time at their
shape; ``flash_attention_spmd``: its launches in 3.lm_spmd's sharded
prefill and its time at a position's shape; ``consensus_fused_network_spmd``:
its launches in 3.lm_spmd's placed pytree round and its time at a
position's block; ``flash_attention_spmd_olmoe`` /
``flash_attention_spmd_recurrentgemma``: its launches in 3.lm_spmd_kinds'
first placed prefill of each and its time at a position's shape;
``flash_attention_spmd_whisper_enc`` / ``_cross``: its launches on the
encoder and the cross-attention in 3.lm_spmd_xlstm_whisper's placed
prefill and its time at a position's shapes), and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks, from the port's one home for them
# (launch/mesh.py, no torch import): HBM, dense bf16 and TF32 on the tensor
# cores, fp32 outside them
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_FLOP_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_FP32 as FP32_FLOP_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_TF32 as TF32_FLOP_PER_S  # noqa: E402

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
# the float32 kernel's rows (csrc/flash_attention.cu, 3xTF32), each
# (B, H, S, Sk, head dim, causal, window): Qwen3-8B's and RecurrentGemma-9B's
# local attention as above, Whisper-tiny's encoder (configs/whisper_tiny.py:
# 6 heads of 64, 1,500 frames, non-causal) at B = 16, and repro-100m's
# prefill as 3.lm_repro100m's f32 prefill runs it (B = agents x prompts,
# 12 heads of 64, S = 512)
ATTN_F32_SHAPES = {  # by the row's name in the kernels line
    "flash_attention_f32": (1, 32, 4096, 4096, 128, True, 0),
    "flash_attention_f32_recurrentgemma": (1, 16, 4096, 4096, 256, True, 2048),
    "flash_attention_f32_whisper_enc": (16, 6, 1500, 1500, 64, False, 0),
    "flash_attention_f32_repro100m": (4, 12, 512, 512, 64, True, 0),
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
# the model zoo's dense serving path (3.lm_qwen3_8b, 3.lm_repro100m)
LM_AGENTS, LM_BATCH = 2, 2  # agents, prompts an agent
LM_S, LM_CAP = 4_096, 4_128  # Qwen3-8B prompt; cache capacity (S + 32)
LM_DECODE, LM_WINDOW, LM_SHORT_DECODE = 32, 1_024, 8
LM_SMALL_S = 512  # repro-100m prompt
LM_ZOO_W = [[0.75, 0.25], [0.25, 0.75]]  # repro-100m's eq. (6): the merged agents differ
# bf16 logits: decode vs prefill, card vs CPU, agent-stacked vs one agent.
# Both sides round every matmul and attention output to bf16 (the
# tensor-core kernel's P split keeps ~16 bits of P, the plain versions
# fp32).  Held on the max abs difference and on its rms over the rms of
# the logits (~0.88): measured 0.040-0.063 and 0.010-0.014 on the H100,
# so about twice that.  The control, the other agent's weights, must fail
# it (measured 3.1-5.4 and 0.83-1.42).  A decode one position late moves
# the logits at this init no further than the noise (0.066, 0.016), so
# layer 0's decode attention is held on its own (LAYER0_DECODE_*).
LM_BF16_ATOL = 0.125
LM_BF16_RMS = 0.03
# the LM path's attention vs its plain version (layer 0's q/k/v, the
# prefill's shape): one bf16 place of |plain| plus one of the rms of its
# row over the head dim, so a row whose output is small (late in a long
# causal sequence, ~0.02 here) is held to its own scale
ATT_BF16_REL = 2.0 ** -7
ATT_CONTROL_DROP = 64  # the control drops up to this many of the earliest keys
# layer 0's attention block, decode of token S over the cache against the
# no-cache block over S + 1 tokens (the kernel), bf16, max abs and rms
# ratio: measured 0.0039 and 0.00094 on the H100; the control, the same
# decode one position late, 0.0156 and 0.0184
LAYER0_DECODE_ATOL, LAYER0_DECODE_RMS = 0.008, 0.005
LM_F32_ATOL = 1e-4  # f32 logits, card (TF32 off) vs CPU: fp32 sums in another order
# the MoE and recurrent configs at full width (3.lm_olmoe, 3.lm_recurrentgemma,
# 3.lm_xlstm), and the four new configs at reduced() size, card vs CPU
# (tag, config, whole-model checks held, depth or None for the config's): the
# xLSTM's checks are read, not held (run_lm_new); its depth is cut from 48 to 24
# blocks to keep the script inside its time (its sequential sLSTM steps take most
# of the phase; 3.lm_spmd_xlstm_whisper serves all 48 blocks)
LM_NEW = (("3.lm_olmoe", "olmoe-1b-7b", True, None),
          ("3.lm_recurrentgemma", "recurrentgemma-9b", True, None),
          ("3.lm_xlstm", "xlstm-1.3b", False, 24))
LM_REDUCED = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-9b", "xlstm-1.3b",
              "whisper-tiny", "pixtral-12b")
LM_REDUCED_S, LM_REDUCED_DECODE = 64, 4
ZOO_F32_ATOL = 1e-5  # reduced configs' f32 logits, card vs CPU
# OLMoE's and RecurrentGemma's whole model at full width, bf16: decode vs the
# prefill of S + 1 and agent 1 stacked vs alone, max abs and rms ratio as
# LM_BF16_*.  Measured on the H100: decode 0.031 / 0.0076 (OLMoE's rows
# routed alike) and 0.133-0.152 / 0.021 (RecurrentGemma, whose 2,048-slot
# ring and 26 recurrent layers keep more bf16 roundings than Qwen3-8B's
# cache), stacked vs alone bitwise; so about twice that.  The controls read
# 2.4-6.4 / 0.60-1.01 (a decode after the other row's prompt) and 6.0-8.4 /
# 1.41-1.42 (agent 0's weights).
WHOLE_BF16_ATOL, WHOLE_BF16_RMS = 0.3, 0.05
# one block on the card, decode vs the no-cache run and agent 1 alone vs
# stacked, on the same bf16 input (layer_checks), held on the block's own
# contribution (its output less its input, in fp32): max abs, and the
# difference's rms over that contribution's rms, so the residual stream
# (|x| up to 16-32 in deep layers) does not dilute it.  Measured on the H100
# over the three models' 102 layers: at most 0.125 (one bf16 place of the
# output at |x| in [16, 32)) and 0.0088, so about twice that; the controls
# (a decode after the other row's prompt, at each kind's first and last
# layer) read 0.27-3.3 and 0.17-0.93.
LAYER_BF16_ATOL, LAYER_BF16_RMS = 0.25, 0.02
# the enc-dec and VLM configs at full width (3.lm_whisper, 3.lm_pixtral):
# Whisper-tiny, A = 2 agents x 8 clips of 1,500 frames with prompts of 224
# Zipf tokens (half its 448-token text context) into 256-slot caches;
# Pixtral-12B, A = 2 x 2 prompts of 256 patches + 3,840 Zipf tokens (S =
# 4,096) into LM_CAP slots; 32 decode steps each; frames and patches
# normal x 0.1 from a seed
WHISPER_BATCH, WHISPER_TEXT, WHISPER_CAP = 8, 224, 256
# Whisper-tiny's whole model at full width, bf16, as WHOLE_BF16_*: the
# decode against the prefill of S + 1 and agent 1 stacked against alone
# read 0.0234 / 0.0042 and 0 on the H100, so about twice that (to the next
# bf16 place of |logits| < 4); the controls read 0.785 / 0.184 (half the
# prompt) and 5.34 / 1.42 (agent 0's weights), 12x or more beyond.
# Pixtral-12B keeps WHOLE_BF16_* (read 0.064 / 0.015; controls 4.84 / 1.16
# and 5.80 / 1.41).
ENCDEC_BF16_ATOL, ENCDEC_BF16_RMS = 0.0625, 0.01
# The enc-dec controls: Whisper's decoder input is its token embedding (std
# 0.02 at init) plus a sinusoid of amplitude 1, the same in every row, so
# two rows' prompts (and clips) give nearly the same decode at random init
# (measured on the CPU at full width: 0.036 / 0.0077 whole model, <= 0.014
# rms ratio a layer).  The other row's prompt is read there, and the decode
# after a prefill of only the prompt's first half (a cache that lost half
# its keys; 0.14-0.25 rms ratio a layer) is the control that must fail.
PIXTRAL_BATCH, PIXTRAL_TEXT = 2, 3_840
FRONT_DECODE = 32
FRONT_SCALE = 0.1
# LM training (3.lm_train): repro-100m at full width and launch/train.py's
# defaults: A = 2 agents on complete_w(2), Adam, batch 8 an agent of S = 256
# Zipf tokens, u = 4 local steps a round, lr 1e-3 decaying 0.99 a round,
# kl_scale 1e-4
TRAIN_ARCH = "repro-100m"
TRAIN_AGENTS, TRAIN_BATCH, TRAIN_S, TRAIN_U = 2, 8, 256, 4
TRAIN_LR, TRAIN_LR_DECAY, TRAIN_KL = 1e-3, 0.99, 1e-4
TRAIN_ROUNDS, TRAIN_ROUND_STEPS, TRAIN_FIXED_STEPS = 3, 3, 10
# one u > 1 round card against CPU at reduced() size, f32 (TF32 off), each
# config with a control (the agents' tokens swapped on the card)
TRAIN_REDUCED = ("repro-100m", "olmoe-1b-7b", "recurrentgemma-9b", "xlstm-1.3b")
TRAIN_REDUCED_B, TRAIN_REDUCED_S, TRAIN_REDUCED_U = 2, 32, 2
# the expert-parallel MoE layer (3.moe_ep): 3.lm_olmoe's 16,384 tokens, (config,
# expert-axis shards)
EP_TOKENS = (4, 4_096)
EP_CONFIGS = (("olmoe-1b-7b", 8), ("phi3.5-moe-42b-a6.6b", 4))
# the sharded LM steps (3.lm_spmd): decode steps after the sharded Qwen3-8B prefill
SPMD_DECODE = 8
# the moe, local_attn and rglru kinds under data x model (3.lm_spmd_kinds): the
# full-width configs served and the reduced ones trained; the reduced MoE configs
# whose drops are held, at a capacity factor where the unsharded dispatch drops,
# B = 4 rows an agent
SPMD_KINDS = ("olmoe-1b-7b", "recurrentgemma-9b")
# their placed logits against the unsharded steps', bf16, max abs and rms ratio:
# OLMoE's (on the rows routed alike) read 0.035-0.049 / 0.0096-0.0117 on the
# H100, within LM_BF16_*; RecurrentGemma's 0.164-0.195 / 0.0266-0.0291 (its 26
# recurrent layers keep more bf16 roundings, as 3.lm_recurrentgemma found for
# its decode against the prefill), so it keeps its whole model's WHOLE_BF16_*;
# the controls (agents swapped) read 5.52 / 1.41 and 9.16 / 1.41
SPMD_KINDS_BF16 = {"olmoe-1b-7b": (LM_BF16_ATOL, LM_BF16_RMS),
                   "recurrentgemma-9b": (WHOLE_BF16_ATOL, WHOLE_BF16_RMS)}
SPMD_DROP_CONFIGS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b")
SPMD_DROP_FACTOR, SPMD_DROP_BATCH = 0.5, 4
# RecurrentGemma's placed bf16 parting read layer by layer (placed_layers) on
# the first tokens of its prompt
SPMD_LAYER_READ_S = 1_024
# the mlstm / slstm and enc_attn / dec_attn kinds under data x model
# (3.lm_spmd_xlstm_whisper): the xLSTM's prompt, cut from 4,096, since its placed
# prefill runs the sLSTM's sequential steps once a (data, model) position; the
# decode steps of its two configs, cut from SPMD_DECODE to keep the script inside
# its time
SPMD_XLSTM_S = 1_024
SPMD_NEW_DECODE = 4
# the placed train round's other routes (3.lm_spmd_consensus): the W of the
# reference's own consensus tests, whose entries bf16 and f16 do not hold exactly
# (LM_ZOO_W's 0.75 / 0.25 they do), so a wire route that left W unrounded shows;
# the wire-boundary lanes (two priors at the bf16 wire rounding a statistic apart)
# at most SPMD_FLIP_SHARE of the lanes, each within one bf16 place (BF16_PLACE) of
# the value plus 1
SPMD_WIRE_W = [[0.6, 0.4], [0.25, 0.75]]
BF16_PLACE = 2.0 ** -8
SPMD_FLIP_SHARE = 1e-3
_START = time.perf_counter()


def phase(tag: str, **fields) -> None:
    """One phase's line; ``elapsed_s``: seconds since the script started."""
    fields = {"elapsed_s": time.perf_counter() - _START, **fields}
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


SHARD_COUNTS = (3, 9)  # virtual shards of the 9-agent slice


def same_bits(a, b) -> bool:
    """Equal bits, NaN lanes included (``torch.equal`` fails on NaN)."""
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def shard_stats(k, mean, rho, shards, wire):
    """Every shard's rows encoded into one [2, N, P] wire-dtype buffer (what
    a shard holds once every offset has rotated)."""
    import torch

    from repro_torch.core.numerics import canonical_wire_dtype

    n, p = mean.shape
    per = n // shards
    stats = torch.empty((2, n, p), dtype=canonical_wire_dtype(wire), device=mean.device)
    for s in range(shards):
        rows = slice(s * per, (s + 1) * per)
        k.consensus_shard_encode(mean[rows], rho[rows], stats[0], stats[1], row0=s * per)
    return stats


def check_shard(dev):
    """Phase 2.shard: ``consensus_shard_encode`` and ``consensus_fused_shard``
    at the slice's N = 9, P = 199,210 over 3 and 9 shards, at every wire
    dtype: the encode against its plain version, each shard's reduce against
    its plain version, and every reduced row bitwise the masked kernel's row
    (its small instance and its generic one), on finite inputs and on the
    poisoned buffers (NaN, +-inf, huge and f16-overflowing lanes)."""
    import torch

    from repro_torch.kernels import consensus as k

    worst = {"consensus_fused_shard": 0.0, "consensus_shard_encode": 0.0}
    n, p = 9, P_SLICE
    W, mean, rho = eq6_inputs(n, p, seed=91, device=dev)
    active = torch.arange(n, device=dev) % 3 != 1
    inputs = {"finite": (mean, rho), "poisoned": poisoned(n, p, seed=5, device=dev)}
    for case, (m, r) in inputs.items():
        for wire in WIRES:
            masked = [k.consensus_fused_masked(W, active, m, r, wire_dtype=wire),
                      k._network_launch("consensus_fused_masked", W, active, m, r, wire,
                                        instance=0)]
            plain_x = k.consensus_shard_encode_plain(m, r, n, 0, wire)
            for shards in SHARD_COUNTS:
                per = n // shards
                stats = shard_stats(k, m, r, shards, wire)
                fields = {}
                if case == "finite":
                    enc = eq6_errors(f"consensus_shard_encode S={shards}",
                                     [x.float() for x in stats], [x.float() for x in plain_x],
                                     wire)
                    fields["encode_max_abs_err"] = enc
                    if wire == "f32":
                        worst["consensus_shard_encode"] = max(worst["consensus_shard_encode"],
                                                              *enc)
                errs = []
                for sh in range(shards):
                    rows = slice(sh * per, (sh + 1) * per)
                    args = (W[rows], active[rows], stats[0], stats[1], m[rows], r[rows])
                    got = k.consensus_fused_shard(*args, row0=sh * per)
                    if case == "finite":
                        errs.append(max(eq6_errors(
                            f"consensus_fused_shard S={shards} shard {sh}", got,
                            k.consensus_shard_plain(W[rows], active[rows], *plain_x, m[rows],
                                                    r[rows], row0=sh * per), wire)))
                    torch.cuda.synchronize()
                    for inst, ref in zip(("small", "generic"), masked):
                        if not all(same_bits(g_, x[rows]) for g_, x in zip(got, ref)):
                            raise AssertionError(
                                f"2.shard {case} wire={wire} S={shards} shard {sh}: rows not "
                                f"bitwise the masked kernel's ({inst} instance)")
                if errs:
                    fields["max_abs_err"] = max(errs)
                    if wire == "f32":
                        worst["consensus_fused_shard"] = max(worst["consensus_fused_shard"],
                                                             max(errs))
                phase("2.shard", case=case, n=n, p=p, wire=wire, shards=shards,
                      rows_bitwise_masked=["small", "generic"], **fields,
                      variant=kernel_variant(functools.partial(
                          k.consensus_fused_shard, W[:per], active[:per], stats[0], stats[1],
                          m[:per], r[:per])),
                      encode_variant=kernel_variant(functools.partial(
                          k.consensus_shard_encode, m[:per], r[:per], stats[0], stats[1])))
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


def attention_f32_inputs(name, dev):
    """float32 q [B, H, S, hd], k, v [B, H, Sk, hd] of ``ATTN_F32_SHAPES[name]``
    from a seed, on the card; with (causal, window)."""
    import torch

    b, h, s, sk, hd, causal, window = ATTN_F32_SHAPES[name]
    g = torch.Generator(device=dev).manual_seed(b * h + hd)
    q = torch.randn((b, h, s, hd), generator=g, device=dev)
    k, v = (torch.randn((b, h, sk, hd), generator=g, device=dev) for _ in range(2))
    return q, k, v, causal, window


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


def attention_scaled(what, got, want, rel=ATT_BF16_REL):
    """An attention output ``[..., hd]`` against its plain version: (max
    abs err, max err over its row's rms, rms of the plain output, max err
    over the bound ``rel * |plain| + rel * rms(plain's row)``)."""
    import torch

    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if got.shape != want.shape or got.dtype != want.dtype or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
                             f"{tuple(want.shape)}, or not finite")
    err = (g - w).abs()
    row = w.pow(2).mean(-1, keepdim=True).sqrt()
    share = float((err / (rel * w.abs() + rel * row)).max())
    return float(err.max()), float((err / row).max()), float(w.pow(2).mean().sqrt()), share


def attention_scaled_errors(what, got, want, rel=ATT_BF16_REL):
    """``attention_scaled``; raises beyond its bound."""
    out = attention_scaled(what, got, want, rel)
    if out[3] > 1.0:
        raise AssertionError(f"{what}: max err {out[0]} ({out[1]} of its row's rms) beyond "
                             f"{rel} |plain| + {rel} rms(row)")
    return out


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
              for dt in WIRES for hd in fa.HEAD_DIMS
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
            bq = (fa.F32_TILES if dt == "f32" else fa.TC_TILES)[32][0]
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


def train_parity(got, want, noise, exempt_atol):
    """Hold a training round's state ``got`` against ``want`` (each with
    ``posterior`` and ``opt_state.mu`` / ``.nu``, all of ``mean`` and
    ``rho`` fields, on the CPU): Adam's moments within PARITY_ATOL on every
    lane; the posterior within PARITY_ATOL except on Adam's noise lanes
    ``noise`` (``adam_noise_lanes`` after each of the round's steps,
    or-ed), each held to ``exempt_atol``; at most EXEMPT_SHARE_MAX of the
    lanes beyond PARITY_ATOL.  Unlike ``parity_errors``, the share counts
    the lanes the exemption is used on: at q == prior the KL's gradient on
    an embedding row no token reached is rounding noise on both sides
    (3e-14 against 0), a noise lane by its moments that moves the posterior
    by ~1e-9.  A lane that is not finite on either side fails.  Returns the
    fields, with what failed under ``failures``."""
    import torch

    failures, errs, beyond = [], {}, torch.zeros_like(noise)
    for field in ("mean", "rho"):
        d = (getattr(got.posterior, field) - getattr(want.posterior, field)).abs()
        over = d > PARITY_ATOL
        errs[field] = float(d.masked_fill(noise, 0.0).max())
        errs[f"{field}_noise_lanes"] = float(d.masked_fill(~noise, 0.0).max())
        if bool((over & ~noise).any()):
            failures.append(f"{field}: {errs[field]} beyond PARITY_ATOL off the noise lanes")
        if errs[f"{field}_noise_lanes"] > exempt_atol:
            failures.append(f"{field}: a noise lane beyond {exempt_atol}")
        beyond |= over
    for m in ("mu", "nu"):
        for field in ("mean", "rho"):
            d = (getattr(getattr(got.opt_state, m), field)
                 - getattr(getattr(want.opt_state, m), field)).abs()
            errs[f"adam_{m}_{field}"] = float(d.max())
            if errs[f"adam_{m}_{field}"] > PARITY_ATOL:
                failures.append(f"adam {m}.{field}: {errs[f'adam_{m}_{field}']}")
    if not all(map(math.isfinite, errs.values())):
        failures.append(f"a lane is not finite: {errs}")
    share = float(beyond.float().mean())
    if share > EXEMPT_SHARE_MAX:
        failures.append(f"{share:.4%} of the lanes beyond PARITY_ATOL, more than "
                        f"{EXEMPT_SHARE_MAX:.2%}")
    return dict(max_abs_err=errs, atol=PARITY_ATOL, exempt_atol=exempt_atol,
                noise_lanes=int(noise.sum()), lanes_beyond=int(beyond.sum()),
                lanes=beyond.numel(), share_beyond=share, failures=failures)


def card_vs_cpu(tag, session, spec, cpu_devices=None):
    """One more round on the card and on the CPU from the same state with
    the same injected draws; the CPU runs the plain versions (over
    ``cpu_devices`` virtual shards on a sharded session).  Adam's noise
    lanes are exempt, within bounds (``adam_noise_lanes``,
    ``parity_errors``)."""
    import numpy as np
    import torch

    from repro_torch.api import build_session

    cpu = build_session(spec, device="cpu", devices=cpu_devices)
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


def sharded_windows(session, n_windows):
    """Run ``n_windows`` windows one at a time: each one's record, wall ms
    (synchronised) and the rotations and bytes its consensus copied."""
    import torch

    from repro_torch.launch import consensus_opt

    out = []
    for _ in range(n_windows):
        consensus_opt.reset_rotation_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = session.run(n_rounds=1, eval_every=1)[0]
        torch.cuda.synchronize()
        out.append((rec, (time.perf_counter() - t0) * 1e3, consensus_opt.rotation_counts()))
    return out


def run_sharded(dev, smi):
    """Phase 3.sharded: the gossip slice (chaos faults, quarantine) on the
    sharded execution, 4 windows, over 3 virtual shards at wire f32 and
    bf16 and over 9 at f32, on the card; then over the real cards where
    there are more than one (the largest count that divides N = 9).  Each
    window's wall ms, rotations and copied bytes, beside the cost model's
    ``window_ppermute`` bytes for its fired offsets (equal), the bf16
    window's bytes half the f32 window's; counters around each run.
    -> {(wire, shards, cards): (session, launch counts)}."""
    import numpy as np
    import torch

    from repro_torch.api import build_session
    from repro_torch.gossip.engine import _largest_divisor_leq
    from repro_torch.kernels import dispatch
    from repro_torch.launch.consensus_opt import window_shard_offsets
    from repro_torch.launch.costmodel import gossip_window_roofline
    from repro_torch.launch.mesh import local_devices

    n_win = 4
    clock = gossip_spec().topology.gossip_clock()
    wins = [clock.window(r) for r in range(n_win)]
    cards = torch.cuda.device_count()
    real = _largest_divisor_leq(9, cards)
    configs = [("f32", 3, [dev] * 3), ("bf16", 3, [dev] * 3), ("f32", 9, [dev] * 9)]
    if real > 1:
        configs.append(("f32", real, local_devices(dev)[:real]))
    phase("3.sharded_cards", cards=cards, real_card_shards=real,
          real_card_run=("over cuda:0..cuda:%d" % (real - 1)) if real > 1 else
          f"not possible: {cards} card(s), no count above 1 divides N = 9",
          nvidia_smi=smi)
    runs, moved = {}, {}
    for wire, shards, devices in configs:
        session = build_session(gossip_spec(consensus_impl="ppermute", wire_dtype=wire),
                                device=dev, devices=devices)
        n_cards = session.engine.mesh.n_cards
        dispatch.reset_launch_counts()
        done = sharded_windows(session, n_win)
        counts = dispatch.launch_counts()
        ev = session.evaluate()
        health = session.health()
        offsets = [window_shard_offsets(w, shards) for w in wins]
        modeled = [gossip_window_roofline(9, P_SLICE, int(w.participating().sum()),
                                          n_shards=shards, n_cross_offsets=len(o),
                                          wire_dtype=wire)["ici_bytes"]["window_ppermute"]
                   for w, o in zip(wins, offsets)]
        copied = [rot["bytes"] for _, _, rot in done]
        losses = [rec["loss"] for rec, _, _ in done]
        failures = []
        if copied != modeled or [rot["rotations"] for _, _, rot in done] != \
                [len(o) for o in offsets]:
            failures.append(f"copied {copied} vs modeled {modeled}")
        if any(x is None or not np.isfinite(x) for x in losses) or not health["all_ok"] or \
                not torch.isfinite(session.posterior().mean).all():
            failures.append(f"losses {losses}, health {health}")
        if min(counts["consensus_fused_shard"], counts["consensus_shard_encode"],
               counts["payload_validity_fused"]) <= 0 or counts["consensus_fused_masked"]:
            failures.append(f"launches {counts}")
        if ev["engine"]["consensus_shards"] != shards or session.engine.n_shards != shards:
            failures.append(f"shards {ev['engine']['consensus_shards']}")
        moved[wire, shards, n_cards] = copied
        phase("3.sharded", wire=wire, shards=shards, cards=n_cards, agents=9, n_params=P_SLICE,
              window_wall_ms=[ms for _, ms, _ in done], offsets=offsets,
              rotations=[rot["rotations"] for _, _, rot in done],
              block_copies=[rot["copies"] for _, _, rot in done], copied_bytes=copied,
              modeled_window_ppermute_bytes=modeled, losses=losses, avg_acc=ev["avg_acc"],
              quarantined=ev["engine"]["faults"]["quarantined"]["total"], launches=counts,
              health=health["n_healthy"], nvidia_smi=smi, failures=failures)
        if failures:
            raise AssertionError(f"3.sharded wire={wire} S={shards}: {'; '.join(failures)}")
        runs[wire, shards, n_cards] = (session, counts)
    half = [b * 2 for b in moved["bf16", 3, 1]]
    if half != moved["f32", 3, 1] or not any(half):
        raise AssertionError(f"3.sharded: bf16 bytes {moved['bf16', 3, 1]} are not half of "
                             f"f32's {moved['f32', 3, 1]}")
    return runs


def sharded_rungs(dev, runs, masked_state):
    """4.ladder rungs of the sharded execution, bitwise: ``sharded==masked``
    (each of 3.sharded's f32 runs against 3.gossip's state after the same
    4 windows, and the bf16 run against a masked bf16 run),
    ``sharded_quarantine0==sharded_strict`` (9 shards, zero faults, 2
    windows) and ``obs_on==obs_off(sharded)`` (3 shards, with the spans
    ``gossip.local_phase`` and ``gossip.consensus``)."""
    import torch

    from repro_torch.api import build_session

    def rung(name, a_state, b_state, **fields):
        same = states_bitwise(a_state, b_state)
        phase("4.ladder", rung=name, bitwise=same, **fields)
        if not same:
            raise AssertionError(f"4.ladder {name}: not bitwise")

    for (wire, shards, cards), (session, _) in runs.items():
        if wire == "f32":
            rung("sharded==masked", session.state, masked_state, wire=wire, shards=shards,
                 cards=cards, windows=4)
    masked = build_session(gossip_spec(wire_dtype="bf16"), device=dev)
    sharded_windows(masked, 4)
    rung("sharded==masked", runs["bf16", 3, 1][0].state, masked.state, wire="bf16", shards=3,
         cards=1, windows=4)
    del masked
    pair = [build_session(gossip_spec(policy, False, consensus_impl="ppermute"), device=dev,
                          devices=[dev] * 9) for policy in ("quarantine", "strict")]
    for sess in pair:
        sharded_windows(sess, 2)
    # the quarantined state also counts drops (n_quarantined): the rest is compared
    rung("sharded_quarantine0==sharded_strict",
         *[dataclasses.replace(x.state, n_quarantined=None) for x in pair], shards=9,
         windows=2, quarantined=int(pair[0].state.n_quarantined.sum()))
    del pair
    on = build_session(with_obs(gossip_spec(consensus_impl="ppermute")), device=dev,
                       devices=[dev] * 3)
    sharded_windows(on, 4)
    torch.cuda.synchronize()
    spans = sorted({(sp.name, sp.attrs.get("impl")) for sp in on.obs.tracer.spans
                    if sp.name in ("gossip.local_phase", "gossip.consensus")})
    if spans != [("gossip.consensus", "ppermute"), ("gossip.local_phase", "ppermute")]:
        raise AssertionError(f"4.ladder obs_on==obs_off(sharded): spans {spans}")
    rung("obs_on==obs_off(sharded)", on.state, runs["f32", 3, 1][0].state, shards=3, windows=4,
         spans=span_p50s(on.obs))


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
    # one shard of the 3.sharded slice: 3 shards of 3 rows, the window's W-tilde, f32 wire
    per = n // SHARD_COUNTS[0]
    stats = shard_stats(k, mean, rho, SHARD_COUNTS[0], "f32")
    shard = functools.partial(k.consensus_fused_shard, W_win[:per], act[:per], stats[0],
                              stats[1], mean[:per], rho[:per])
    shard_enc = functools.partial(k.consensus_shard_encode, mean[:per], rho[:per], stats[0],
                                  stats[1])
    shard_act = int(win.active[:per].sum())
    read_bytes = {  # what each call reads of HBM when L2 is cold (the inputs, once)
        "consensus_fused_network": 8 * n * p + 4 * n * n,
        "payload_validity_fused": 8 * n * p,
        "consensus_fused_masked": 8 * n * p + 4 * n * n + n,
        "consensus_fused_sparse": 8 * n * p + 8 * n * d_b,
        "consensus_fused_masked_sparse": 8 * p * rows_read + 8 * n * d_w + n,
        "consensus_fused": 8 * n * p + 4 * n,
        "sample_and_kl_fused": 20 * p,
        "consensus_fused_segments": 8 * p * seg_rows_read + seg_plan_bytes,
        "consensus_fused_shard": 4 * per * n + per + 8 * n * p + 8 * per * p,
        "consensus_shard_encode": 8 * per * p,
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
        ("consensus_fused_shard", "consensus_shard.cu", "src/repro/launch/consensus_opt.py:254",
         shard,  # no pallas_call: the reference's shard body is XLA; its contract is :261's
         lambda: k.consensus_shard_plain(W_win[:per], act[:per], stats[0], stats[1],
                                         mean[:per], rho[:per]),
         # W rows and mask; the two [N, P] planes; own rows in; rows out
         4 * per * n + per + 8 * n * p + 16 * per * p,
         4 * shard_act * n * p + out_ops * shard_act * p, fp32, None,
         dict(launch_fields(shard, launch_floor_ms), window=win.index, shards=SHARD_COUNTS[0],
              rows=per, n_active=shard_act)),
        ("consensus_shard_encode", "consensus_shard.cu", "src/repro/launch/consensus_opt.py:254",
         shard_enc,
         lambda: k.consensus_shard_encode_plain(mean[:per], rho[:per], n, 0, "f32"),
         16 * per * p,  # the rows' mean, rho in; prec_x, pm_x out (f32 wire)
         gathered_ops * per * p, fp32, None,
         dict(launch_fields(shard_enc, launch_floor_ms), shards=SHARD_COUNTS[0], rows=per)),
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
        fields["read_bytes"] = q.element_size() * 3 * b * h * s * hd  # q, k, v
        kernels.append((
            "flash_attention", "flash_attention_tc.cu", "src/repro/kernels/flash_attention.py:94",
            kern, plain,
            q.element_size() * 4 * b * h * s * hd,  # q, k, v in; out
            4 * hd * pairs * b * h, BF16_FLOP_PER_S, sdpa, fields))
    for name in ATTN_F32_SHAPES:  # the float32 kernel (3xTF32), a row a shape
        q, kk, vv, causal, window = attention_f32_inputs(name, dev)
        b, h, s, hd = q.shape
        sk = kk.shape[2]
        pairs = attention_pairs(s, sk, causal, window)
        sdpa = (functools.partial(F.scaled_dot_product_attention, q, kk, vv,
                                  attn_mask=fa.attention_mask(s, sk, causal, window, dev))
                if window else
                functools.partial(F.scaled_dot_product_attention, q, kk, vv, is_causal=causal))
        plain = functools.partial(fa.flash_attention_plain, q, kk, vv, causal=causal,
                                  window=window)
        kern = functools.partial(fa.flash_attention, q, kk, vv, causal=causal, window=window,
                                 block_q=s, block_k=sk)  # one block: S = 1,500 is ragged
        want = plain()
        fields = {"shape": name, "q": list(q.shape), "sk": sk, "causal": causal,
                  "window": window, "pairs": pairs,
                  "max_abs_err": attention_errors(f"{name} {list(q.shape)}", kern(), want,
                                                  ATT_TOL["f32"]),
                  **launch_fields(kern, launch_floor_ms),
                  "kernel_device_names": device_kernels(kern, top=1),
                  "library_kernels": device_kernels(sdpa, top=1),
                  "library_max_abs_err": float((sdpa() - want).abs().max()),
                  "useful_flops": 4 * hd * pairs * b * h,  # one fp32 product a product
                  "read_bytes": 4 * b * h * (s + 2 * sk) * hd}  # q, k, v
        del want
        kernels.append((
            name, "flash_attention.cu", "src/repro/kernels/flash_attention.py:94", kern, plain,
            4 * b * h * (2 * s + 2 * sk) * hd,  # q, k, v in; out
            3 * 4 * hd * pairs * b * h, TF32_FLOP_PER_S, sdpa, fields))  # 3xTF32
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
            "launches": counts[fields.get("counter", name)],
            "max_abs_err": fields["max_abs_err"] if "max_abs_err" in fields else errs[name],
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
        if not attention or fields["shape"] == "qwen3_8b" or name in ATTN_F32_SHAPES:
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


def lm_profile(fn, top=6):
    """One call of ``fn`` under torch.profiler: wall ms, device ms summed
    over its kernels, their number, and the ``top`` kernels by device time
    (empty where the profiler sees no device event)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_kernels": sum(e.count for e in kernels),
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]]}


def lm_params(cfg, dev, n_agents, dtype):
    """The serving weights of ``n_agents`` agents, agent ``i`` drawn by
    ``init_params`` from seed ``i`` in ``dtype`` (one f32 leaf at a time),
    stacked on a leading agent axis leaf by leaf: each agent's leaf is
    freed as its stack is made, so no third copy of the model exists."""
    import torch

    from repro_torch.models import init_params

    drawn = [init_params(cfg, torch.Generator(device=dev).manual_seed(i), device=dev,
                         dtype=dtype) for i in range(n_agents)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {key: stack([t.pop(key) for t in trees]) for key in list(trees[0])}
        if isinstance(trees[0], list):  # RecurrentGemma's tail: element by element
            out = [stack([t[i] for t in trees]) for i in range(len(trees[0]))]
            for t in trees:
                t.clear()
            return out
        out = torch.stack(trees)
        trees.clear()
        return out

    return stack(drawn)


def lm_tokens(cfg, n, dev, seed=0, b=LM_BATCH):
    """``[A, B, n]`` Zipf tokens from the port's sampler (``n - 1`` tokens
    and their shift, rejoined)."""
    import torch

    from repro_torch.data.pipeline import make_lm_batch_sampler

    batch = make_lm_batch_sampler(cfg.vocab_size, b, n - 1, n_agents=LM_AGENTS,
                                  device=dev)(torch.Generator(device=dev).manual_seed(seed), 0)
    return torch.cat([batch["tokens"], batch["targets"][..., -1:]], dim=-1)


def lm_front(cfg, b, dev, seed=3, a=LM_AGENTS):
    """An enc-dec or VLM config's stub inputs for ``a`` agents x ``b`` rows,
    normal x FRONT_SCALE from a seed, fp32: ``{"frames": [A, B, F, D]}``
    or ``{"patches": [A, B, P, D]}`` (``{}`` for a text-only config)."""
    import torch

    n = (cfg.encoder_seq if cfg.is_encdec else
         cfg.n_patches if cfg.frontend == "vision_stub" else 0)
    if not n:
        return {}
    x = torch.randn((a, b, n, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(
        seed), device=dev) * FRONT_SCALE
    return {"frames" if cfg.is_encdec else "patches": x}


def lm_input(cfg, params, tokens, front):
    """The first block's input ``[A, B, S, D]`` (bf16) as ``forward`` builds
    it: the projected patches before the token embeddings, and for an
    enc-dec config the sinusoid at positions 0..S-1."""
    import torch

    from repro_torch.models import transformer as tr
    from repro_torch.models.modules import embed, matmul

    bf16 = torch.bfloat16
    x = embed(params["embed"], tokens, bf16)
    if "patches" in front:
        x = torch.cat([matmul(front["patches"].to(bf16), params["patch_proj"]["w"].to(bf16)), x],
                      dim=-2)
    if cfg.is_encdec:
        x = x + tr._sinusoidal(torch.arange(x.shape[-2], device=x.device), cfg.d_model).to(bf16)
    return x


def timed(fn):
    """(result, device ms) of one call, from CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def lm_decode(step, params, token, start, n, cache, tokens=None):
    """``n`` decode steps from ``token [A, B, 1]`` at position ``start``,
    greedy unless ``tokens [A, B, n]`` forces each step's input after the
    first: (each step's logits, its inputs, each step's device ms from
    CUDA events, the wall seconds of all, the cache)."""
    import torch

    logits, inputs, events = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        inputs.append(token)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        lg, cache = step(params, token, start + i, cache)
        e.record()
        events.append((s, e))
        logits.append(lg)
        token = (lg.argmax(-1) if tokens is None or i + 1 >= n
                 else tokens[..., i + 1:i + 2].to(lg.device))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return logits, inputs, [s.elapsed_time(e) for s, e in events], wall, cache


def lm_diff(what, got, want):
    """(max abs difference, its rms over the rms of ``want``) of two logits
    tensors; raises on a shape mismatch or a non-finite value."""
    import torch

    g, w = got.float().cpu(), want.float().cpu()
    if g.shape != w.shape or not bool(torch.isfinite(g).all() and torch.isfinite(w).all()):
        raise AssertionError(f"{what}: shapes {tuple(g.shape)} / {tuple(w.shape)}, or not finite")
    d = g - w
    return float(d.abs().max()), float(d.pow(2).mean().sqrt() / w.pow(2).mean().sqrt())


def lm_check(what, got, want, atol, rms_tol=None):
    """``lm_diff``; raises past ``atol`` on the max or ``rms_tol`` on the
    relative rms."""
    err, rms = lm_diff(what, got, want)
    if err > atol or (rms_tol is not None and rms > rms_tol):
        raise AssertionError(f"{what}: max abs err {err}, relative rms {rms}; "
                             f"bounds {atol}, {rms_tol}")
    return err, rms


def lm_control(what, wrong, want, atol, rms_tol):
    """A deliberately wrong result against the right one: ``lm_diff``;
    raises unless ``lm_check`` at these bounds would refuse it."""
    err, rms = lm_diff(what, wrong, want)
    if err <= atol and rms <= rms_tol:
        raise AssertionError(f"{what}: max abs {err}, relative rms {rms} within the bounds "
                             f"{atol}, {rms_tol}: the check would not see this fault")
    return err, rms


def flash_names(fn):
    """The flash-attention device kernels one call of ``fn`` runs (from a
    CUDA graph of the call)."""
    names = [w["name"] for w in captured_work(fn) if w["type"] == "kernel"]
    return sorted({"flash_attention_tc_kernel" if "flash_attention_tc_kernel" in n
                   else "flash_attention_kernel" for n in names if "flash_attention" in n})


def tree_bytes(tree):
    from repro_torch.core.tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def encoder_flops(cfg, a, b):
    """bf16 GEMM operations of an enc-dec config's encoder over ``a`` agents
    x ``b`` clips of ``encoder_seq`` frames (every layer's projections and
    MLP for every frame, non-causal attention over F^2 pairs), and of each
    ``dec_attn`` layer's cross K/V projections of its output: the work a
    prefill does once and the reference's decode step redoes every step."""
    d, hd, h, kv, f = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.encoder_seq
    if not cfg.is_encdec:
        return 0
    proj = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
    layer = a * b * f * (proj + 3 * 2 * d * cfg.d_ff) + 4 * hd * h * a * b * f * f
    n_dec = (cfg.pattern * cfg.n_periods + cfg.tail).count("dec_attn")
    return cfg.encoder_layers * layer + n_dec * a * b * f * 2 * d * 2 * kv * hd


def prefill_flops(cfg, a, b, s, window=0):
    """Operations of one prefill of ``a`` agents x ``b`` prompts of ``s``
    positions (a VLM's patches included): (bf16 GEMM operations, fp32
    operations).  bf16: every layer's projections for every position (for
    ``moe`` the router, and every expert over its ``cap`` slots, as the
    dispatch computes them), attention over the pairs the mask leaves (4 hd
    a pair and head), for ``dec_attn`` also the cross-attention (its q and
    output projections, and S x F pairs), the encoder (``encoder_flops``),
    the patch projection, the last position's logits.  fp32: the mLSTM's
    chunk products (the causal half of each chunk's pairs, and the two
    [c, hd] x [hd, hd] products a chunk and head) and the sLSTM's recurrent
    products; the gates' elementwise work is not counted."""
    from repro_torch.models.moe import _capacity

    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
    mlp = 3 * 2 * d * cfg.d_ff
    n_tok = a * b * s
    bf16 = f32 = 0
    for kind in cfg.pattern * cfg.n_periods + cfg.tail:
        if kind in ("attn", "local_attn", "moe", "dec_attn"):
            w = cfg.sliding_window if kind == "local_attn" else window
            bf16 += n_tok * proj + 4 * hd * h * a * b * attention_pairs(s, s, True, w)
            if kind == "moe":
                cap = _capacity(b * s, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
                bf16 += n_tok * 2 * d * cfg.n_experts + a * 3 * 2 * d * cfg.d_ff * \
                    cfg.n_experts * cap
            else:
                bf16 += n_tok * mlp
            if kind == "dec_attn":
                bf16 += n_tok * 2 * 2 * d * h * hd + 4 * hd * h * a * b * s * cfg.encoder_seq
        elif kind == "rglru":
            bf16 += n_tok * (5 * 2 * d * d + mlp)
        elif kind == "mlstm":
            p, mh = 2 * d, cfg.n_heads
            mhd = p // mh
            bf16 += n_tok * (2 * 2 * d * p + 3 * 2 * p * p + 2 * 2 * p * mh + 2 * p * d)
            c = min(256, s)
            chunks = -(-s // c)
            pairs = c * (c + 1) // 2
            f32 += a * b * chunks * mh * (3 * 2 * pairs * mhd + 2 * 2 * c * mhd * mhd)
        elif kind == "slstm":
            bf16 += n_tok * 5 * 2 * d * d
            f32 += n_tok * 2 * 4 * d * (d // cfg.n_heads)
    if cfg.frontend == "vision_stub":
        bf16 += a * b * cfg.n_patches * 2 * d * d
    return bf16 + encoder_flops(cfg, a, b) + a * b * 2 * d * cfg.padded_vocab, f32


def serving_reading(cfg, a, b, s, sizes, warm_ms, dec_ms, dec_wall, cap=LM_CAP,
                    encoder_bytes=0):
    """A served phase's prefill and decode times against their bounds.
    ``sizes``: (weight, embedding, KV cache, recurrent state) bytes.  The
    prefill: its operations (``prefill_flops``, bf16 at the bf16 peak, fp32
    at the fp32 peak) or its weights read once, whichever takes longer.  A
    decode step reads every weight once (every expert's: the dispatch
    multiplies all E blocks), the embedding only where it is tied (as the
    unembedding), the KV slots the median step finds filled (a local
    attention ring: all of it), and reads and writes every recurrent
    state.  An enc-dec config's step re-runs the encoder over the frames
    (the reference's contract): the bound with the re-run adds the frames'
    bytes and takes the longer of those bytes and ``encoder_flops`` at the
    bf16 peak; the bound without it (were the cross K/V cached) reads
    neither the encoder's weights nor the cross K/V projections
    (``encoder_bytes``) but each ``dec_attn`` layer's cached cross K/V."""
    import statistics

    weights, emb, kv, states = sizes
    n_dec = len(dec_ms)
    step_ms = statistics.median(dec_ms)
    bf16_ops, f32_ops = prefill_flops(cfg, a, b, s)
    t_bf16, t_f32 = bf16_ops / BF16_FLOP_PER_S * 1e3, f32_ops / FP32_FLOP_PER_S * 1e3
    t_w = weights / HBM_BYTES_PER_S * 1e3
    prefill_bound = max(t_bf16, t_f32, t_w)
    kv_read = kv if "local_attn" in cfg.pattern else \
        (kv // cap) * min(cap, s + n_dec // 2 + 1)
    decode_bytes = weights - (0 if cfg.tie_embeddings else emb) + kv_read + 2 * states + \
        a * b * cfg.d_model * 2
    out = {}
    if cfg.is_encdec:
        n_x = (cfg.pattern * cfg.n_periods + cfg.tail).count("dec_attn")
        cross_kv = n_x * a * b * cfg.encoder_seq * 2 * cfg.n_kv_heads * cfg.hd * 2
        no_rerun = decode_bytes - encoder_bytes + cross_kv
        decode_bytes += a * b * cfg.encoder_seq * cfg.d_model * 4  # the fp32 frames
        rerun_ops = encoder_flops(cfg, a, b)
        out = {"decode_bytes_without_rerun": no_rerun,
               "decode_bound_ms_without_rerun": no_rerun / HBM_BYTES_PER_S * 1e3,
               "decode_rerun_flop": rerun_ops}
    decode_bound = decode_bytes / HBM_BYTES_PER_S * 1e3
    if cfg.is_encdec:
        decode_bound = max(decode_bound, out["decode_rerun_flop"] / BF16_FLOP_PER_S * 1e3)
        out["decode_bound_share_without_rerun"] = out["decode_bound_ms_without_rerun"] / step_ms
    return dict(prefill_warm_ms=warm_ms, prefill_bf16_flop=bf16_ops, prefill_f32_flop=f32_ops,
                prefill_bound_ms=prefill_bound,
                prefill_bound_by=("bf16 operations" if prefill_bound == t_bf16 else
                                  "f32 operations" if prefill_bound == t_f32 else "bytes"),
                prefill_bound_terms_ms={"bf16": t_bf16, "f32": t_f32, "weights": t_w},
                prefill_bound_share=prefill_bound / warm_ms, decode_steps=n_dec,
                decode_ms=dec_ms, decode_ms_median=step_ms, decode_ms_min=min(dec_ms),
                decode_ms_max=max(dec_ms), decode_wall_ms_per_step=dec_wall * 1e3 / n_dec,
                tokens_per_s=a * b / step_ms * 1e3, decode_bytes=decode_bytes,
                decode_bound_ms=decode_bound, decode_bound_share=decode_bound / step_ms, **out)


def attention_kernel_row(tag, name, cfg, q, k, v, window, launches, causal=True):
    """The model's attention route on a prefill's own q/k/v (``[A, B, S,
    H, hd]`` and ``[A, B, Sk, H, hd]``, bf16, K/V repeated to every head):
    causal with ``window`` (``kernel_attention``), or non-causal over Sk
    keys (``kernel_attention_full``: an encoder, a cross-attention).  It
    must run the tensor-core kernel, and its output is held against the
    plain version a row at a time (``ATT_BF16_REL``); the control, the plain
    version dropping ``ATT_CONTROL_DROP`` of the earliest keys, must fail
    that bound.  Then ``flash_attention`` on the same input in its own
    layout, timed beside the plain version and SDPA (with the mask under a
    window), and its bound: 4 hd operations an unmasked pair and head at
    the bf16 peak, or q, k, v read and the output written.  Returns (the
    phase's reading, the kernel line's row named ``name``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as att

    a, b, s, h, hd = q.shape
    sk = k.shape[2]
    route = (functools.partial(att.kernel_attention, q, k, v, causal=True, window=window)
             if causal else functools.partial(att.kernel_attention_full, q, k, v))
    route_kernels = flash_names(route)
    if route_kernels != ["flash_attention_tc_kernel"]:
        raise AssertionError(f"{tag}: bf16 attention ran {route_kernels}")

    def heads_first(t):  # [A, B, S, H, hd] -> [A B, H, S, hd]: the kernel's own layout
        return t.reshape(a * b, t.shape[2], h, hd).transpose(1, 2).contiguous()

    got = heads_first(route())
    qh, kh, vh = (heads_first(t) for t in (q, k, v))

    def plain():  # a row at a time: one row's fp32 scores
        return torch.cat([fa.flash_attention_plain(qh[i:i + 1], kh[i:i + 1], vh[i:i + 1],
                                                   causal=causal, window=window)
                          for i in range(a * b)])

    want = plain()
    err = attention_scaled_errors(f"{tag} attention, window {window}", got, want)
    if causal:
        dropped = fa.flash_attention_plain(qh[:1], kh[:1], vh[:1], causal=True,
                                           window=(window or s) - ATT_CONTROL_DROP)
    else:
        drop = min(ATT_CONTROL_DROP, sk // 2)
        dropped = fa.flash_attention_plain(qh[:1], kh[:1, :, drop:], vh[:1, :, drop:],
                                           causal=False)
    ctrl = attention_scaled("control", dropped, want[:1])
    if ctrl[3] <= 1.0:
        raise AssertionError(f"{tag}: the attention bound passes a plain version that drops "
                             f"{ATT_CONTROL_DROP} keys: {ctrl}")
    del got, want, dropped
    kern = functools.partial(fa.flash_attention, qh, kh, vh, causal=causal, window=window,
                             block_q=s, block_k=sk)
    mask = fa.attention_mask(s, sk, True, window, q.device) if window else None
    sdpa = functools.partial(F.scaled_dot_product_attention, qh, kh, vh, attn_mask=mask,
                             is_causal=causal and not window)
    ops = 4 * hd * attention_pairs(s, sk, causal, window) * a * b * h
    nbytes = qh.element_size() * 2 * (qh.numel() + kh.numel())  # q, k, v in; out
    t_ops, t_bytes = ops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    reading = {"shape": list(qh.shape), "sk": sk, "causal": causal, "window": window,
               "route_kernels": route_kernels,
               **dict(zip(("max_abs_err", "max_err_over_row_rms", "plain_rms",
                           "share_of_bound"), err)),
               "drop_control_share_of_bound": ctrl[3], "ms": cuda_ms(kern),
               "plain_ms": event_ms(plain), "library_ms": cuda_ms(sdpa),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes", "ops": ops,
               "bytes": nbytes}
    row = {"name": name, "route": "cuda", "source": SRC + "flash_attention_tc.cu",
           "replaces": "src/repro/kernels/flash_attention.py:94", "launches": launches,
           **{key: reading[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}}
    return reading, row


def layer0_decode(cfg, params, layer0, toks, s, dev):
    """Layer 0's attention block on the card: token ``s`` decoded over a
    cache that a prefill of ``s`` tokens filled, against the last row of
    the no-cache block over ``s + 1`` tokens (the kernel route, padded);
    and the control, the same decode one position late.  Returns both
    ``lm_diff`` readings; raises past ``LAYER0_DECODE_*``."""
    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.models import attention as att
    from repro_torch.models.modules import embed, rmsnorm

    a, b = toks.shape[:2]
    h = rmsnorm(layer0["norm1"], embed(params["embed"], toks[..., :s + 1], torch.bfloat16),
                cfg.norm_eps)
    block = functools.partial(att.attention_block, layer0["attn"], cfg=cfg, causal=True)
    want = block(h, positions=torch.arange(s + 1, device=dev))[0][..., s:, :]
    cache = att.init_kv_cache(cfg, b, s + 2, device=dev, lead=(a,))
    block(h[..., :s, :], positions=torch.arange(s, device=dev), cache=cache)
    late = tree_map(torch.clone, cache)
    got = block(h[..., s:, :], positions=torch.tensor([s], device=dev), cache=cache)[0]
    wrong = block(h[..., s:, :], positions=torch.tensor([s + 1], device=dev), cache=late)[0]
    return (lm_check("3.lm_qwen3_8b layer 0 decode vs no-cache S+1", got, want,
                     LAYER0_DECODE_ATOL, LAYER0_DECODE_RMS),
            lm_control("3.lm_qwen3_8b layer 0 decode at S+1 (control)", wrong, want,
                       LAYER0_DECODE_ATOL, LAYER0_DECODE_RMS))


def run_lm_qwen3(dev, smi):
    """Phase 3.lm_qwen3_8b: Qwen3-8B at full width and depth served for
    A = 2 agents, B = 2 prompts each, bf16 weights (seed 0): prefill of
    S = 4096 Zipf tokens into a cache of 4,128 slots (first and warm), 32
    decode steps (the first on the real next token, then greedy), the
    prefill of S + 1 against the first decode step; the same weights with
    ``window_override`` 1024 on a ring cache of 1024 slots (prefill, 8
    decode steps, the S + 1 check); 8 decode steps on an int8 cache.  The
    agents carry different weights (seeds 0 and 1): agent 1's prefill is
    held against a forward of its own weights alone, and the control
    (agent 0's weights on agent 1's prompts) must fail that check.  Then
    layer 0's decode attention (``layer0_decode``), and its attention on
    the prefill's own q/k/v, causal and window 1024, after the model is
    freed (``attention_kernel_row``).  Returns the kernel line's
    ``flash_attention_lm`` row, with the first prefill's launches."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import dispatch
    from repro_torch.launch import steps
    from repro_torch.models import attention as att
    from repro_torch.models import forward
    from repro_torch.models.modules import embed, rmsnorm

    cfg = get_config("qwen3-8b")
    a, b, s = LM_AGENTS, LM_BATCH, LM_S
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_params(cfg, dev, a, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = tree_bytes(params)
    emb_bytes = tree_bytes(params["embed"])
    toks = lm_tokens(cfg, s + 1 + LM_DECODE, dev)  # [A, B, S + 33]
    prompt = {"tokens": toks[..., :s]}
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    cache = steps.make_agent_cache(cfg, a, b, LM_CAP, device=dev)
    kv_bytes = tree_bytes(cache)
    torch.cuda.synchronize()

    dispatch.reset_launch_counts()
    (logits, cache), first_ms = timed(lambda: prefill(params, prompt, cache))
    first_counts = dispatch.launch_counts()
    (logits_warm, cache), warm_ms = timed(lambda: prefill(params, prompt, cache))
    dec, _, dec_ms, dec_wall, cache = lm_decode(decode, params, toks[..., s:s + 1], s,
                                                LM_DECODE, cache)
    full_cache = steps.make_agent_cache(cfg, a, b, LM_CAP, device=dev)
    full, _ = prefill(params, {"tokens": toks[..., :s + 1]}, full_cache)  # S + 1: the pad
    del full_cache
    cont_err = lm_check("3.lm_qwen3_8b decode vs prefill S+1", dec[0], full, LM_BF16_ATOL,
                        LM_BF16_RMS)

    prefill_w = steps.make_prefill_step(cfg, LM_WINDOW)
    decode_w = steps.make_decode_step(cfg, LM_WINDOW)
    ring = steps.make_agent_cache(cfg, a, b, LM_WINDOW, device=dev)
    (logits_w, ring), window_ms = timed(lambda: prefill_w(params, prompt, ring))
    dec_w, _, dec_w_ms, _, ring = lm_decode(decode_w, params, toks[..., s:s + 1], s,
                                            LM_SHORT_DECODE, ring)
    ring2 = steps.make_agent_cache(cfg, a, b, LM_WINDOW, device=dev)
    full_w, _ = prefill_w(params, {"tokens": toks[..., :s + 1]}, ring2)
    del ring, ring2
    cont_w_err = lm_check("3.lm_qwen3_8b windowed decode vs prefill S+1", dec_w[0], full_w,
                          LM_BF16_ATOL, LM_BF16_RMS)

    q8 = steps.make_agent_cache(cfg, a, b, LM_CAP, dtype=torch.int8, device=dev)
    int8_bytes = tree_bytes(q8)
    (logits_8, q8), int8_prefill_ms = timed(lambda: prefill(params, prompt, q8))
    dec_8, _, dec_8_ms, _, q8 = lm_decode(decode, params, toks[..., s:s + 1], s,
                                          LM_SHORT_DECODE, q8)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    del q8
    peak = torch.cuda.max_memory_allocated(dev)
    n_prefills = 6
    if first_counts["flash_attention"] != cfg.n_layers or \
            counts["flash_attention"] != n_prefills * cfg.n_layers:
        raise AssertionError(f"3.lm_qwen3_8b: flash_attention launched {first_counts} in the "
                             f"first prefill, {counts} in all; expected {cfg.n_layers} a prefill")
    for name, out in [("prefill", logits), ("prefill_warm", logits_warm), ("window", logits_w),
                      ("int8_prefill", logits_8)] + [("decode", x) for x in dec + dec_w + dec_8]:
        if not bool(torch.isfinite(out).all()) or out.shape != (a, b, 1, cfg.padded_vocab):
            raise AssertionError(f"3.lm_qwen3_8b {name}: {tuple(out.shape)} or not finite")
    int8_gap = lm_diff("3.lm_qwen3_8b int8 vs bf16 cache", dec_8[0], dec[0])
    # the agent axis: agent 1's prefill against its own weights alone, and
    # (the control) agent 0's weights on agent 1's prompts
    solo = [forward(tree_map(lambda x: x[i], params), cfg, prompt["tokens"][1],
                    logits_tail=1)[0] for i in (1, 0)]
    agent_err = lm_check("3.lm_qwen3_8b agent 1 stacked vs alone", logits_warm[1], solo[0],
                         LM_BF16_ATOL, LM_BF16_RMS)
    agent_ctrl = lm_control("3.lm_qwen3_8b agent 1 vs agent 0's weights (control)",
                            solo[1], logits_warm[1], LM_BF16_ATOL, LM_BF16_RMS)
    del solo
    profiles = {"prefill": lm_profile(lambda: prefill(params, prompt, cache)),
                "decode": lm_profile(lambda: decode(params, dec[-1].argmax(-1), s, cache))}

    # layer 0's attention on the prefill's own q/k/v: the kernel route vs
    # plain, timed beside SDPA (causal, and window 1024) after the model is freed
    layer0 = tree_map(lambda x: x[:, 0, 0], params["stacks"]["attn"])
    decode0, decode0_ctrl = layer0_decode(cfg, params, layer0, toks, s, dev)
    h = rmsnorm(layer0["norm1"], embed(params["embed"], prompt["tokens"], torch.bfloat16),
                cfg.norm_eps)
    q, k, v = att.attention_qkv(layer0["attn"], h, cfg, torch.arange(s, device=dev))
    k, v = att._repeat_kv(k, cfg.n_heads), att._repeat_kv(v, cfg.n_heads)
    del params, h, layer0, cache
    torch.cuda.empty_cache()
    attention, rows = {}, {}
    for window in (0, LM_WINDOW):  # [4, 32, 4096, 128]
        attention[window], rows[window] = attention_kernel_row(
            "3.lm_qwen3_8b", "flash_attention_lm", cfg, q, k, v, window,
            first_counts["flash_attention"])
    del q, k, v
    torch.cuda.empty_cache()  # the plain versions' 2.1 GB score matrices

    phase("3.lm_qwen3_8b", nvidia_smi=smi, agents=a, batch_per_agent=b, prompt=s,
          capacity=LM_CAP, n_params_per_agent=weight_bytes // (2 * a),
          weight_bytes=weight_bytes, kv_cache_bytes=kv_bytes, int8_cache_bytes=int8_bytes,
          init_s=init_s, prefill_first_ms=first_ms,
          **serving_reading(cfg, a, b, s, (weight_bytes, emb_bytes, kv_bytes, 0), warm_ms,
                            dec_ms, dec_wall),
          logits_rms=float(full.float().pow(2).mean().sqrt()),
          atol=LM_BF16_ATOL, rms_tol=LM_BF16_RMS,
          continuation_max_abs_err_rel_rms=cont_err,
          layer0_decode_max_abs_err_rel_rms=decode0, layer0_late_decode_control=decode0_ctrl,
          layer0_decode_bounds=(LAYER0_DECODE_ATOL, LAYER0_DECODE_RMS),
          agent1_stacked_vs_alone=agent_err, agent0_weights_control=agent_ctrl,
          window=LM_WINDOW, window_prefill_ms=window_ms,
          window_decode_ms_median=statistics.median(dec_w_ms),
          window_continuation_max_abs_err_rel_rms=cont_w_err,
          int8_prefill_ms=int8_prefill_ms, int8_decode_ms_median=statistics.median(dec_8_ms),
          int8_vs_bf16_first_decode_max_abs_rel_rms=int8_gap,
          flash_attention_per_prefill=first_counts["flash_attention"],
          layer0_attention=attention, max_memory_allocated=peak, launches=counts,
          profiles=profiles)
    return rows[0]


def run_lm_repro100m(dev, smi):
    """Phase 3.lm_repro100m: repro-100m at full width (P = 163,597,056 an
    agent), A = 2: ``init_train_state`` -> a ``FlatPosterior [2, P]``
    (agent 1's mean moved by seeded noise, as a local step would), one
    ``make_consensus_step`` over ``LM_ZOO_W`` on the network kernel (held
    against its plain version, timed against its 16 N P byte bound), so the
    two agents' merged means differ; ``serve_params`` at bf16 and f32, and
    at each a prefill of S = 512 and 8 decode steps for B = 2 prompts an
    agent (bf16 on the tensor-core kernel, f32 on the 3xTF32 kernel), each
    held against the same steps on the CPU, and each agent's prefill
    against a forward of its own weights alone on the card (the other
    agent's weights, the control, must fail that check).  Returns the
    ``consensus_fused_network_zoo`` row."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import consensus as kc
    from repro_torch.kernels import dispatch
    from repro_torch.launch import steps
    from repro_torch.models import attention as att
    from repro_torch.models import forward
    from repro_torch.optim import adam

    base = get_config("repro-100m")
    a, b, s, n_dec = LM_AGENTS, LM_BATCH, LM_SMALL_S, LM_SHORT_DECODE
    cpu = torch.device("cpu")
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    state = steps.init_train_state(base, a, adam(), torch.Generator(device=dev).manual_seed(0),
                                   device=dev)
    post = state.posterior
    p = post.n_params()
    post.mean[1] += 1e-2 * torch.randn(p, generator=torch.Generator(device=dev).manual_seed(1),
                                       device=dev)
    W = torch.as_tensor(LM_ZOO_W, dtype=torch.float32, device=dev)
    merged = steps.make_consensus_step(base, W)(post)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = lm_tokens(base, s + n_dec, dev, seed=1)
    runs, route_kernels, served = {}, {}, {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        cfg = dataclasses.replace(base, dtype=str(dt).removeprefix("torch."))
        params = steps.serve_params(merged, dt)
        out = {}
        for on_card, device in ((True, dev), (False, cpu)):
            pr = params if on_card else tree_map(lambda x: x.to(cpu), params)
            tk = toks.to(device)
            cache = steps.make_agent_cache(cfg, a, b, s + n_dec, dtype=dt, device=device)
            if on_card:
                (lg, cache), ms = timed(lambda: steps.make_prefill_step(cfg)(
                    pr, {"tokens": tk[..., :s]}, cache))
                dec, inputs, dec_ms, _, _ = lm_decode(steps.make_decode_step(cfg), pr,
                                                      tk[..., s:s + 1], s, n_dec, cache)
                forced = torch.cat(inputs, dim=-1).cpu()
                out["card"] = (lg, dec, ms, dec_ms)
            else:  # the card's greedy tokens, forced
                lg, cache = steps.make_prefill_step(cfg)(pr, {"tokens": tk[..., :s]}, cache)
                dec = []
                for i in range(n_dec):
                    step_lg, cache = steps.make_decode_step(cfg)(pr, forced[..., i:i + 1], s + i,
                                                                 cache)
                    dec.append(step_lg)
                out["cpu"] = (lg, dec)
        atol, rms_tol = (LM_F32_ATOL, None) if name == "f32" else (LM_BF16_ATOL, LM_BF16_RMS)
        (lg, dec, ms, dec_ms), (lg_cpu, dec_cpu) = out["card"], out["cpu"]
        errs = [lm_check(f"3.lm_repro100m {name} prefill, card vs CPU", lg, lg_cpu, atol,
                         rms_tol)] + [
            lm_check(f"3.lm_repro100m {name} decode {i}, card vs CPU", x, y, atol, rms_tol)
            for i, (x, y) in enumerate(zip(dec, dec_cpu))]
        runs[name] = {"prefill_ms": ms, "decode_ms": dec_ms,
                      "max_abs_err": max(e[0] for e in errs),
                      "max_rel_rms": max(e[1] for e in errs), "atol": atol, "rms_tol": rms_tol}
        served[name] = (cfg, params, lg)
        del params
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    for name, (cfg, params, lg) in served.items():
        atol, rms_tol = runs[name]["atol"], runs[name]["rms_tol"]
        solo, ctrl = [], []
        for i in range(a):  # agent i's prefill vs its own weights alone; the other's
            alone = [forward(tree_map(lambda x: x[j], params), cfg, toks[i, :, :s],
                             logits_tail=1)[0] for j in (i, a - 1 - i)]
            solo.append(lm_check(f"3.lm_repro100m {name} agent {i} stacked vs alone", lg[i],
                                 alone[0], atol, rms_tol))
            ctrl.append(lm_control(f"3.lm_repro100m {name} agent {i} vs the other's weights "
                                   "(control)", alone[1], lg[i], atol,
                                   math.inf if rms_tol is None else rms_tol))
        runs[name].update(agents_stacked_vs_alone=solo, other_agent_control=ctrl)
    del served
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q = torch.randn((a, b, s, base.n_heads, base.hd), device=dev).to(dt)
        route_kernels[name] = flash_names(functools.partial(att.kernel_attention, q, q, q,
                                                            causal=True))
    expect = {"bf16": ["flash_attention_tc_kernel"], "f32": ["flash_attention_kernel"]}
    if route_kernels != expect:
        raise AssertionError(f"3.lm_repro100m: attention ran {route_kernels}, expected {expect}")
    if (counts["consensus_fused_network"] != 1 or counts["flash_attention"] != 2 * base.n_layers
            or counts["flash_attention_f32"] != base.n_layers):  # the f32 prefill's
        raise AssertionError(f"3.lm_repro100m: launches {counts}")

    # the network kernel on the zoo posterior, against its plain version
    network = functools.partial(kc.consensus_fused_network, W, post.mean, post.rho)
    plain = functools.partial(kc.consensus_network_plain, W, post.mean, post.rho)
    got, want = network(), plain()
    eq6_err = 0.0
    for g, w in zip(got, want):
        err = (g - w).abs()
        if not bool(torch.all(err <= F32_TOL + F32_TOL * w.abs())):
            raise AssertionError(f"3.lm_repro100m consensus: max err {float(err.max())}")
        eq6_err = max(eq6_err, float(err.max()))
    for g, w in zip((merged.mean, merged.rho), got):
        if not torch.equal(g, w):
            raise AssertionError("3.lm_repro100m: make_consensus_step is not the kernel's output")
    del got, want
    nbytes, ops = 16 * a * p + 4 * a * a, 4 * a * a * p + 20 * a * p
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    row = {"name": "consensus_fused_network_zoo", "route": "cuda",
           "source": SRC + "consensus_network.cu", "replaces": REF + "195",
           "launches": counts["consensus_fused_network"], "max_abs_err": eq6_err,
           "ms": cuda_ms(network), "plain_ms": event_ms(plain),  # ~15 passes over 1.3 GB
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}
    phase("3.lm_repro100m", nvidia_smi=smi, agents=a, n_params=p, init_s=init_s,
          consensus_ms=row["ms"], consensus_bound_ms=row["bound_ms"],
          consensus_bound_share=row["bound_ms"] / row["ms"], consensus_max_abs_err=eq6_err,
          batch_per_agent=b, prompt=s, decode_steps=n_dec, runs=runs,
          route_kernels=route_kernels, max_memory_allocated=torch.cuda.max_memory_allocated(dev),
          launches=counts, flash_attention_f32_launches=counts["flash_attention_f32"])
    return row, counts["flash_attention_f32"]


class RoutingRecord:
    """While active, the chosen experts (``[A, T, k]``) of every
    ``models.moe.route_topk`` call, in call order (a layer a call)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._route = [], moe.route_topk

        def route(logits, k):
            out = self._route(logits, k)
            self.calls.append(out[1])
            return out

        moe.route_topk = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route_topk = self._route


def rows_routed_alike(calls, other, b, n=None):
    """``[A, B]`` bool on the host: every token of the row took the same
    experts in both records at every layer.  With ``n``, ``other`` is a
    prefill of ``n`` tokens and only its last token is held against
    ``calls``' one token (a decode step)."""
    agree = None
    for x, y in zip(calls, other):
        a, k = x.shape[0], x.shape[-1]
        x, y = x.reshape(a, b, -1, k).cpu(), y.reshape(a, b, -1, k).cpu()
        if n is not None:
            y = y[:, :, n - 1:n]
        same = (x.sort(-1).values == y.sort(-1).values).all(-1).all(-1)
        agree = same if agree is None else agree & same
    if len(calls) != len(other) or agree is None:
        raise AssertionError(f"routing records of {len(calls)} and {len(other)} layers")
    return agree


def held_rows(what, got, want, agree):
    """The logits of the (agent, row) pairs routed alike (``agree [A, B]``),
    got's and want's, and their number; raises when none is.  An MoE token
    whose router sits at a near-tie takes another expert on a one-ulp
    change upstream (module docstring of tests/test_torch_zoo_models.py),
    so only rows routed alike are compared."""
    held = int(agree.sum())
    if held == 0:
        raise AssertionError(f"{what}: no (agent, row) routed alike")
    mask = agree.to(got.device)
    return got[mask], want.to(got.device)[mask], held


def cache_bytes_split(cfg, cache):
    """(KV cache bytes, recurrent state bytes) of a model cache."""
    parts = list(cache["stacks"].items()) + list(zip(cfg.tail, cache.get("tail", [])))
    kv = sum(tree_bytes(c) for kind, c in parts
             if kind in ("attn", "local_attn", "moe", "dec_attn"))
    return kv, tree_bytes(cache) - kv


def model_layers(cfg, params):
    """(layer index, kind, its params' views) for every layer in order:
    the periods' blocks, then the tail."""
    from repro_torch.core.tree import tree_map

    out, lead = [], params["embed"]["emb"].ndim - 2
    for p in range(cfg.n_periods):
        offsets: dict[str, int] = {}
        for kind in cfg.pattern:
            o = offsets.get(kind, 0)
            offsets[kind] = o + 1
            out.append((len(out), kind, tree_map(
                lambda t: t[(slice(None),) * lead + (p, o)], params["stacks"][kind])))
    for kind, tail in zip(cfg.tail, params.get("tail", [])):
        out.append((len(out), kind, tail))
    return out


def layer_checks(tag, cfg, chk, params, x, s, dev, enc_out=None):
    """Every layer's block on the card, each on the same input: the
    no-cache stacked run over S + 1 positions layer by layer from ``x [A,
    B, S + 1, D]`` (``lm_input``: a teacher-forced stream, so no layer's
    difference reaches the next).  At each layer: the decode of position S
    after a prefill of S into the block's own cache against the no-cache
    run's row S (an ``moe`` layer at ``chk``'s capacity factor, nothing
    dropped, its rows routed apart not held; a ``dec_attn`` layer
    cross-attends ``enc_out [A, B, F, D]`` in both, so its contribution
    includes the cross-attention), and agent 1's block alone on agent 1's
    input against the stacked run; both on the block's contribution
    (``LAYER_BF16_*``).  The control, at the first and the last layer of
    each kind: the decode after a prefill of the other row's prompt, which
    must fail the decode check (``dec_attn``: after a prefill of the first
    half of the prompt, the other row's read: the enc-dec controls' comment).
    Returns the largest readings and the controls."""
    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.models import transformer as tr

    def check(what, got, want, x, agree=None):  # on got - x and want - x, in fp32
        g, w = got.float() - x.float(), want.float() - x.float()
        if agree is not None:
            g, w = held_rows(what, g, w, agree)[:2]
        return lm_check(what, g, w, LAYER_BF16_ATOL, LAYER_BF16_RMS)

    a, b = x.shape[:2]
    pos = torch.arange(s + 1, device=dev)
    worst = {"decode": (0.0, 0.0), "alone": (0.0, 0.0)}
    controls, readings, rows_apart = {}, {}, 0
    layers = model_layers(cfg, params)
    first, last = {}, {}
    for layer, kind, _ in layers:
        first.setdefault(kind, layer)
        last[kind] = layer
    for layer, kind, lp in layers:
        c = chk if kind == "moe" else cfg
        with RoutingRecord() as r_full:
            full = tr.block_apply(kind, lp, x, c, positions=pos, enc_out=enc_out)[0]

        def decode_after(prompt_rows):  # (the decode's output, its routing)
            cache = tr.block_cache_init(kind, c, b, s + 2, torch.bfloat16, dev, lead=(a,))
            tr.block_apply(kind, lp, prompt_rows, c, positions=pos[:prompt_rows.shape[-2]],
                           cache=cache, enc_out=enc_out)
            with RoutingRecord() as routes:
                out = tr.block_apply(kind, lp, x[..., s:, :], c, positions=pos[s:],
                                     cache=cache, enc_out=enc_out)[0]
            return out, routes.calls

        got, r_dec = decode_after(x[..., :s, :])
        agree = (rows_routed_alike(r_dec, r_full.calls, b, s + 1) if kind == "moe"
                 else torch.ones((a, b), dtype=torch.bool))
        rows_apart += a * b - int(agree.sum())
        want, x_s = full[..., s:, :], x[..., s:, :]
        dec = check(f"{tag} layer {layer} ({kind}) decode vs no-cache S+1", got, want, x_s,
                    agree)
        alone = tr.block_apply(kind, tree_map(lambda t: t[1], lp), x[1], c, positions=pos,
                               enc_out=None if enc_out is None else enc_out[1])[0]
        one = check(f"{tag} layer {layer} ({kind}) agent 1 alone vs stacked", alone, full[1],
                    x[1])
        if layer in (first[kind], last[kind]):
            wrong = decode_after(x[..., :s, :].flip(-3))[0]  # the other row's prompt
            what = f"{tag} layer {layer} ({kind}) decode after the other row's prompt (control)"
            if kind == "dec_attn":  # read: the rows' inputs are alike (the enc-dec controls)
                readings[f"{kind} layer {layer}, the other row's prompt"] = lm_diff(
                    what, wrong.float() - x_s.float(), want.float() - x_s.float())
                wrong = decode_after(x[..., :s // 2, :])[0]
                what = f"{tag} layer {layer} ({kind}) decode after half the prompt (control)"
            controls[f"{kind} layer {layer}"] = lm_control(
                what, wrong.float() - x_s.float(), want.float() - x_s.float(),
                LAYER_BF16_ATOL, LAYER_BF16_RMS)
        worst = {"decode": tuple(map(max, worst["decode"], dec)),
                 "alone": tuple(map(max, worst["alone"], one))}
        x = full
        del got, want, alone, full
    return {"layers": len(layers), "bounds": (LAYER_BF16_ATOL, LAYER_BF16_RMS),
            "decode_max_abs_err_rel_rms": worst["decode"],
            "agent1_alone_max_abs_err_rel_rms": worst["alone"],
            "moe_rows_routed_apart": rows_apart, "controls": controls,
            "controls_read": readings}


def encoder_checks(tag, cfg, params, frames, dev):
    """An enc-dec config's encoder on the card, layer by layer from the
    stacked input ``frames + sinusoid`` (bf16): agent 1's block alone on
    agent 1's input against the stacked run, on the block's contribution
    (``LAYER_BF16_*``); the control, at the first and the last layer, agent
    0's block on agent 1's input, must fail it.  Returns (the stacked
    encoder's output after ``enc_norm``, its input and the readings)."""
    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.models import transformer as tr
    from repro_torch.models.modules import rmsnorm

    fpos = torch.arange(frames.shape[-2], device=dev)
    ex0 = ex = frames.to(torch.bfloat16) + \
        tr._sinusoidal(fpos, cfg.d_model).to(torch.bfloat16)
    worst, controls = (0.0, 0.0), {}
    for layer in range(cfg.encoder_layers):
        lp = tree_map(lambda t: t[:, layer, 0], params["enc_stack"])
        full = tr.block_apply("enc_attn", lp, ex, cfg, positions=fpos)[0]
        alone = tr.block_apply("enc_attn", tree_map(lambda t: t[1], lp), ex[1], cfg,
                               positions=fpos)[0]
        one = lm_check(f"{tag} encoder layer {layer} agent 1 alone vs stacked",
                       alone.float() - ex[1].float(), full[1].float() - ex[1].float(),
                       LAYER_BF16_ATOL, LAYER_BF16_RMS)
        worst = tuple(map(max, worst, one))
        if layer in (0, cfg.encoder_layers - 1):
            wrong = tr.block_apply("enc_attn", tree_map(lambda t: t[0], lp), ex[1], cfg,
                                   positions=fpos)[0]
            controls[f"encoder layer {layer}"] = lm_control(
                f"{tag} encoder layer {layer}, agent 0's block on agent 1's input (control)",
                wrong.float() - ex[1].float(), full[1].float() - ex[1].float(),
                LAYER_BF16_ATOL, LAYER_BF16_RMS)
        ex = full
        del alone, full
    enc_out = rmsnorm(params["enc_norm"], ex, cfg.norm_eps)
    return enc_out, ex0, {"layers": cfg.encoder_layers,
                          "agent1_alone_max_abs_err_rel_rms": worst, "controls": controls}


def run_lm_new(dev, smi, tag, arch, held, b=LM_BATCH, n_text=LM_S, cap=LM_CAP,
               n_dec=LM_SHORT_DECODE, n_layers=None):
    """Phases 3.lm_olmoe, 3.lm_recurrentgemma, 3.lm_xlstm, 3.lm_whisper and
    3.lm_pixtral: ``arch`` at full width and depth (``n_layers``, where
    given, its cut depth) for A = 2 agents (agent
    i from seed i), ``b`` prompts of ``n_text`` Zipf tokens each (S
    positions: a VLM's patches first), bf16 weights; an enc-dec config's
    frames and a VLM's patches from ``lm_front``, carried per agent: a
    prefill into a ``cap``-slot cache (first, and warm; each into a fresh
    cache, since a recurrent cache holds the initial state), ``n_dec``
    decode steps (Whisper's re-run its encoder over the frames), a profile
    of a step (and of a prefill, with attention).  The whole model: the
    decode of position S after a prefill of S against the prefill of S + 1
    (an MoE config at capacity_factor E / k, so cap = T and nothing drops;
    the (agent, row) pairs whose last token took other experts are not
    compared), and agent 1's prefill against its own weights alone.  With
    ``held``, both within ``WHOLE_BF16_*`` (an enc-dec config:
    ``ENCDEC_BF16_*``), and the controls must fail
    them: the decode after a prefill of the other row's prompt, and agent
    0's weights on agent 1's prompt.  Without (the xLSTM), both are read:
    at random init one bf16 rounding taken the other way grows through its
    layers to O(1) in the logits (3.6 stacked against alone at 48, measured
    on the H100).  Every model is held layer by layer (``layer_checks``; an
    enc-dec config's encoder by ``encoder_checks`` first, whose output the
    decoder layers cross-attend).  The MoE's layer 0 twice on the prompt,
    bit for bit; the peak memory, the prefill's and the decode step's
    bounds (``serving_reading``).  With attention layers: ``flash_attention``
    launched once a layer a prefill (three times a Whisper layer pair: the
    encoder's, the decoder's and the cross-attention), and the first
    attention layer's q/k/v through ``attention_kernel_row`` (Whisper: its
    encoder, cross and decoder attention).  Returns those kernel line rows,
    each with its launches in the first prefill."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import dispatch, ops
    from repro_torch.launch import steps
    from repro_torch.models import attention as att
    from repro_torch.models import forward
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tr
    from repro_torch.models.modules import embed, rmsnorm

    cfg = get_config(arch)
    if n_layers is not None:  # a cut depth (LM_NEW)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    a = LM_AGENTS
    kinds = cfg.pattern * cfg.n_periods + cfg.tail
    n_attn = sum(kind in ("attn", "local_attn", "moe", "dec_attn") for kind in kinds) + \
        kinds.count("dec_attn") + cfg.encoder_layers
    is_moe = "moe" in cfg.pattern
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = lm_params(cfg, dev, a, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes, emb_bytes = tree_bytes(params), tree_bytes(params["embed"])
    encoder_bytes = tree_bytes([params.get("enc_stack"), params.get("enc_norm")] + [
        params["stacks"]["dec_attn"]["xattn"][w] for w in ("wk", "wv")
        if "dec_attn" in params["stacks"]])
    toks = lm_tokens(cfg, n_text + 1 + n_dec, dev, b=b)  # [A, B, n_text + 1 + n_dec]
    front = lm_front(cfg, b, dev)
    frames = front.get("frames")
    s = n_text + (cfg.n_patches if "patches" in front else 0)  # the prompt's positions
    prompt = {"tokens": toks[..., :n_text], **front}
    prefill = steps.make_prefill_step(cfg)
    decode = functools.partial(steps.make_decode_step(cfg), frames=frames)

    def fresh(c=cfg):
        return steps.make_agent_cache(c, a, b, cap, device=dev)

    cache, warm_cache = fresh(), fresh()
    kv_bytes, state_bytes = cache_bytes_split(cfg, cache)
    torch.cuda.synchronize()

    calls = []  # (causal, q shape, k shape) of each ops.attention call in the first prefill
    attention_op = ops.attention

    def recorded(q, k, v, **kw):
        calls.append((kw.get("causal", True), tuple(q.shape), tuple(k.shape)))
        return attention_op(q, k, v, **kw)

    ops.attention = recorded
    dispatch.reset_launch_counts()
    try:
        (logits, cache), first_ms = timed(lambda: prefill(params, prompt, cache))
        first_counts = dispatch.launch_counts()
    finally:
        ops.attention = attention_op
    (logits_warm, warm_cache), warm_ms = timed(lambda: prefill(params, prompt, warm_cache))
    del cache
    dec, _, dec_ms, dec_wall, warm_cache = lm_decode(decode, params,
                                                     toks[..., n_text:n_text + 1], s, n_dec,
                                                     warm_cache)
    profiles = {"decode": lm_profile(lambda: decode(params, dec[-1].argmax(-1), s + n_dec,
                                                    warm_cache))}
    del warm_cache

    # the whole model: decode of position S after a prefill of S against the
    # prefill of S + 1, and agent 1's prefill against its own weights alone
    chk = (dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k) if is_moe
           else cfg)
    prefill_c, decode_c = steps.make_prefill_step(chk), steps.make_decode_step(chk)

    def decode_after(rows, fr=front):  # position S's logits after a prefill of ``rows``
        c = fresh(chk)
        prefill_c(params, {"tokens": rows, **fr}, c)
        with RoutingRecord() as routes:
            out = decode_c(params, toks[..., n_text:n_text + 1], s, c, fr.get("frames"))[0]
        return out, routes.calls

    def agent(i, j):  # agent i's weights on agent j's prompt, alone
        return forward(tree_map(lambda x: x[i], params), cfg, prompt["tokens"][j],
                       logits_tail=1, **{k: v[j] for k, v in front.items()})[0]

    with RoutingRecord() as r_full:
        full, _ = prefill_c(params, {"tokens": toks[..., :n_text + 1], **front}, fresh(chk))
    got, r_dec = decode_after(prompt["tokens"])
    agree = (rows_routed_alike(r_dec, r_full.calls, b, s + 1) if is_moe
             else torch.ones((a, b), dtype=torch.bool))
    del r_full, r_dec
    what = f"{tag} decode vs prefill S+1"
    held_got, held_full, n_held = held_rows(what, got, full, agree)
    solo = agent(1, 1)
    bounds = (ENCDEC_BF16_ATOL, ENCDEC_BF16_RMS) if cfg.is_encdec else (WHOLE_BF16_ATOL,
                                                                         WHOLE_BF16_RMS)
    whole = {"held": held, "bounds": bounds if held else None,
             "rows_routed_alike": n_held, "rows": a * b}
    if held:
        whole["decode_vs_prefill"] = lm_check(what, held_got, held_full, *bounds)
        whole["agent1_stacked_vs_alone"] = lm_check(f"{tag} agent 1 stacked vs alone",
                                                    logits_warm[1], solo, *bounds)
        # the other row's prompt (and frames or patches)
        wrong = decode_after(prompt["tokens"].flip(1), {k: v.flip(1) for k, v in front.items()})[0]
        ctrl = f"{tag} decode after the other row's prompt (control)"
        if cfg.is_encdec:  # read: the rows' inputs are alike (the enc-dec controls)
            whole["decode_other_row_read"] = lm_diff(ctrl, wrong, full)
            wrong = decode_after(prompt["tokens"][..., :n_text // 2])[0]
            ctrl = f"{tag} decode after half the prompt (control)"
        whole["decode_control"] = lm_control(ctrl, held_rows(what, wrong, full, agree)[0],
                                             held_full, *bounds)
        other = agent(0, 1)
        whole["agent_control"] = lm_control(f"{tag} agent 1 vs agent 0's weights (control)",
                                            other, logits_warm[1], *bounds)
        del wrong, other
    else:
        whole["decode_vs_prefill"] = lm_diff(what, held_got, held_full)
        whole["agent1_stacked_vs_alone"] = lm_diff(f"{tag} agent 1 stacked vs alone",
                                                   logits_warm[1], solo)
    logits_rms = float(full.float().pow(2).mean().sqrt())
    del solo, got, full, held_got, held_full
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    # prefills: first, warm, S + 1, S, a one-agent forward; held: the control's
    # prefill and forward.  Decode steps (an encoder's launches each): the
    # timed ones, the profiled one, the one after S; held: the control's
    n_prefills, n_steps = (7, n_dec + 3) if held else (5, n_dec + 2)
    if held and cfg.is_encdec:  # the half-prompt control's prefill and step
        n_prefills, n_steps = n_prefills + 1, n_steps + 1
    want = n_prefills * n_attn + n_steps * cfg.encoder_layers
    if first_counts["flash_attention"] != n_attn or len(calls) != n_attn or \
            counts["flash_attention"] != want:
        raise AssertionError(f"{tag}: flash_attention launched {first_counts} in the first "
                             f"prefill ({len(calls)} calls), {counts} in all; expected "
                             f"{n_attn} a prefill, {want} in all")
    for name, out in [("prefill", logits), ("prefill_warm", logits_warm)] + \
            [("decode", x) for x in dec]:
        if not bool(torch.isfinite(out).all()) or out.shape != (a, b, 1, cfg.padded_vocab):
            raise AssertionError(f"{tag} {name}: {tuple(out.shape)} or not finite")
    enc_out, encoder, encoder_ms = None, None, None
    if frames is not None:  # the share of a decode step its encoder re-run takes
        encoder_ms = event_ms(lambda: tr.encode(params, cfg, frames))
        enc_out, ex0, encoder = encoder_checks(tag, cfg, params, frames, dev)
    x = lm_input(cfg, params, toks[..., :n_text + 1], front)
    layers = layer_checks(tag, cfg, chk, params, x, s, dev, enc_out)
    peak = torch.cuda.max_memory_allocated(dev)

    moe_same_bits = None
    if is_moe:  # the MoE of layer 0 twice on the prompt's normed embedding
        layer0 = tree_map(lambda x: x[:, 0, 0], params["stacks"]["moe"])
        h = rmsnorm(layer0["norm2"], embed(params["embed"], prompt["tokens"], torch.bfloat16),
                    cfg.norm_eps)
        y1, aux1 = moe_lib.moe_ffn(layer0["moe"], h, cfg)
        y2, aux2 = moe_lib.moe_ffn(layer0["moe"], h, cfg)
        moe_same_bits = same_bits(y1, y2) and same_bits(aux1, aux2)
        if not moe_same_bits:
            raise AssertionError(f"{tag}: two calls of moe_ffn gave other bits")
        del layer0, h, y1, y2
    if n_attn:
        profiles["prefill"] = lm_profile(lambda: prefill(params, prompt, fresh()))

    rows, attention = [], {}
    if n_attn:  # the first attention layer's q/k/v, after the model is freed
        kind = next(k for k in ("moe", "dec_attn", "attn", "local_attn") if k in cfg.pattern)
        window = cfg.sliding_window if kind == "local_attn" else 0
        rope = kind != "dec_attn"
        pos = torch.arange(s, device=dev)
        layer = tree_map(lambda x: x[:, 0, 0], params["stacks"][kind])
        x = x[..., :s, :]
        h = rmsnorm(layer["norm1"], x, cfg.norm_eps)
        qkv = {"": att.attention_qkv(layer["attn"], h, cfg, pos, use_rope=rope) + (True,)}
        if kind == "dec_attn":  # the encoder's layer 0, and the cross-attention
            enc0 = tree_map(lambda t: t[:, 0, 0], params["enc_stack"])
            he = rmsnorm(enc0["norm1"], ex0, cfg.norm_eps)
            qkv = {"_enc": att.attention_qkv(enc0["attn"], he, cfg, None, use_rope=False) +
                   (False,)}
            x1 = x + att.attention_block(layer["attn"], h, cfg, positions=pos,
                                         use_rope=False)[0]
            hx = rmsnorm(layer["norm_x"], x1, cfg.norm_eps)
            qkv["_xattn"] = att.attention_qkv(layer["xattn"], hx, cfg, pos, cross_x=enc_out,
                                              use_rope=False) + (False,)
            qkv["_dec"] = att.attention_qkv(layer["attn"], h, cfg, pos, use_rope=False) + (True,)
            del enc0, he, x1, hx, ex0, enc_out
        del params, h, layer, x
        torch.cuda.empty_cache()
        for suffix, (q, k, v, causal) in qkv.items():
            k, v = att._repeat_kv(k, cfg.n_heads), att._repeat_kv(v, cfg.n_heads)
            launches = sum(c == (causal, (a * b, cfg.n_heads, q.shape[2], cfg.hd),
                                 (a * b, cfg.n_heads, k.shape[2], cfg.hd)) for c in calls)
            attention[suffix or "attn"], row = attention_kernel_row(
                tag + suffix, "flash_attention_" + arch.split("-")[0] + suffix, cfg, q, k, v,
                window, launches, causal)
            rows.append(row)
            del q, k, v
        if sum(row["launches"] for row in rows) != (n_attn if kind == "dec_attn"
                                                    else first_counts["flash_attention"]):
            raise AssertionError(f"{tag}: the rows' launches {[r['launches'] for r in rows]} "
                                 f"do not split the prefill's {n_attn}")
        del qkv
    else:
        del params
    torch.cuda.empty_cache()

    phase(tag, nvidia_smi=smi, agents=a, batch_per_agent=b, prompt=s, text=n_text,
          capacity=cap, memory_allocated_at_start=allocated_at_start,
          n_params_per_agent=weight_bytes // (2 * a), weight_bytes=weight_bytes,
          kv_cache_bytes=kv_bytes, recurrent_state_bytes=state_bytes, init_s=init_s,
          prefill_first_ms=first_ms,
          **serving_reading(cfg, a, b, s, (weight_bytes, emb_bytes, kv_bytes, state_bytes),
                            warm_ms, dec_ms, dec_wall, cap, encoder_bytes),
          logits_rms=logits_rms, check_capacity_factor=chk.capacity_factor,
          encoder_ms=encoder_ms, encoder_share_of_decode_step=encoder_ms and
          encoder_ms / sorted(dec_ms)[len(dec_ms) // 2],
          n_layers=cfg.n_layers, whole_model=whole, encoder=encoder, layers=layers,
          moe_two_calls_same_bits=moe_same_bits,
          flash_attention_per_prefill=first_counts["flash_attention"],
          flash_attention=attention, max_memory_allocated=peak, launches=counts,
          profiles=profiles)
    return rows


def run_lm_reduced(dev, smi):
    """Phase 3.lm_zoo_reduced: OLMoE-1B-7B, Phi-3.5-MoE (whose full width,
    41.9 B parameters, does not fit one card), RecurrentGemma-9B,
    xLSTM-1.3B, Whisper-tiny (16 frames) and Pixtral-12B (16 patches) at
    ``reduced()`` size, A = 2 agents (seeds 0 and 1), B = 2 prompts of 64
    tokens: a prefill and 4 decode steps on the card against
    the same steps on the CPU (the card's greedy tokens forced), at f32
    (ZOO_F32_ATOL) and bf16 (LM_BF16_ATOL / LM_BF16_RMS).  An MoE config at
    bf16 runs at capacity_factor E / k (nothing drops, so a token routed
    apart moves no other token's slots) and holds the (agent, row) pairs
    whose tokens took the same experts on both devices at every layer; the
    pairs held are printed.  And the card's ``moe_ffn`` twice on one input,
    bit for bit."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.models import moe as moe_lib

    a, b, s, n_dec = LM_AGENTS, LM_BATCH, LM_REDUCED_S, LM_REDUCED_DECODE
    cpu = torch.device("cpu")
    out = {}
    for arch in LM_REDUCED:
        base = get_config(arch).reduced()
        drawn = [init_params(base, torch.Generator().manual_seed(i), device=cpu)
                 for i in range(a)]
        f32 = tree_map(lambda *xs: torch.stack(xs), *drawn)
        toks = torch.randint(0, base.vocab_size, (a, b, s + n_dec),
                             generator=torch.Generator().manual_seed(2))
        front = lm_front(base, b, cpu)
        start = s + (base.n_patches if "patches" in front else 0)  # the first decode position
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            cfg = dataclasses.replace(base, dtype=str(dt).removeprefix("torch."))
            is_moe = "moe" in cfg.pattern
            if is_moe and name == "bf16":
                cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
            runs = {}
            for device in (dev, cpu):
                params = tree_map(lambda x: x.to(device=device, dtype=dt), f32)
                fr = {k: v.to(device) for k, v in front.items()}
                cache = steps.make_agent_cache(cfg, a, b, start + n_dec, dtype=dt, device=device)
                with RoutingRecord() as routes:
                    lg, cache = steps.make_prefill_step(cfg)(
                        params, {"tokens": toks[..., :s].to(device), **fr}, cache)
                    logits = [lg]
                    for i in range(n_dec):
                        tok = (logits[-1].argmax(-1) if device == dev
                               else runs[dev][2][..., i:i + 1])
                        step_lg, cache = steps.make_decode_step(cfg)(
                            params, tok.to(device), start + i, cache, fr.get("frames"))
                        logits.append(step_lg)
                forced = torch.cat([x.argmax(-1).cpu() for x in logits[:-1]], dim=-1)
                runs[device] = (logits, routes.calls, forced)
            (card, r_card, _), (host, r_host, _) = runs[dev], runs[cpu]
            agree = (rows_routed_alike(r_card, r_host, b) if is_moe
                     else torch.ones((a, b), dtype=torch.bool))
            atol, rms_tol = (ZOO_F32_ATOL, None) if name == "f32" else (LM_BF16_ATOL,
                                                                      LM_BF16_RMS)
            errs = []
            for i, (x, y) in enumerate(zip(card, host)):
                what = f"3.lm_zoo_reduced {arch} {name} step {i}, card vs CPU"
                errs.append(lm_check(what, *held_rows(what, x, y, agree)[:2], atol, rms_tol))
            out[f"{arch} {name}"] = {"max_abs_err": max(e[0] for e in errs),
                                     "max_rel_rms": max(e[1] for e in errs), "atol": atol,
                                     "rms_tol": rms_tol, "rows_held": int(agree.sum()),
                                     "capacity_factor": cfg.capacity_factor}
    # the card's MoE twice on one input (reduced OLMoE, real capacity: drops)
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), dtype="bfloat16")
    p = moe_lib.moe_init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev,
                         lead=(a,))
    x = torch.randn((a, b, 256, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16) + 1.0
    same = all(same_bits(u, w) for u, w in zip(moe_lib.moe_ffn(p, x, cfg),
                                                moe_lib.moe_ffn(p, x, cfg)))
    if not same:
        raise AssertionError("3.lm_zoo_reduced: two calls of the card's moe_ffn gave other bits")
    phase("3.lm_zoo_reduced", nvidia_smi=smi, agents=a, batch_per_agent=b, prompt=s,
          decode_steps=n_dec, runs=out, moe_two_calls_same_bits=same)


def train_round(cfg, state, batches, eps, device):
    """``launch.train``'s u > 1 round on ``device`` from ``state`` (on the
    CPU): eq. (6) over complete_w(A), then a local step on each of
    ``batches`` with its draws ``eps [A, P]`` (CPU tensors).  Returns the
    state after each step and the steps' losses, on the CPU."""
    import torch

    from repro_torch.core.graphs import complete_w
    from repro_torch.launch import steps
    from repro_torch.optim import adam
    from repro_torch.optim.schedules import exponential_decay

    W = torch.as_tensor(complete_w(state.posterior.mean.shape[0]), dtype=torch.float32,
                        device=device)
    local = steps.make_local_step(cfg, adam(), exponential_decay(TRAIN_LR, TRAIN_LR_DECAY),
                                  kl_scale=TRAIN_KL, remat=False)
    st = state.to(device)
    prior = steps.make_consensus_step(cfg, W)(st.posterior)
    st = steps.BayesTrainState(posterior=prior, opt_state=st.opt_state, step=st.step)
    states, losses = [], []
    for batch, e in zip(batches, eps):
        st, loss = local(st, prior, {k: v.to(device) for k, v in batch.items()},
                         eps=e.to(device))
        states.append(st.to("cpu"))
        losses.append(float(loss))
    return states, losses


def train_card_vs_cpu(dev):
    """One u = TRAIN_REDUCED_U round of each TRAIN_REDUCED config at
    ``reduced()`` size and f32 on the card (the eq. (6) kernel) and on the
    CPU (its plain version) from one state (agent 1's mean moved by seeded
    noise), with the same tokens and draws, held by ``train_parity``; the
    control, the card's round on the agents' tokens swapped, must fail it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch_sampler
    from repro_torch.launch import steps
    from repro_torch.optim import adam

    a, u = TRAIN_AGENTS, TRAIN_REDUCED_U
    out = {}
    for arch in TRAIN_REDUCED:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        g = torch.Generator().manual_seed(0)
        state = steps.init_train_state(cfg, a, adam(), g, device="cpu")
        state.posterior.mean[1] += 1e-2 * torch.randn(state.posterior.mean.shape[1], generator=g)
        sampler = make_lm_batch_sampler(cfg.vocab_size, TRAIN_REDUCED_B, TRAIN_REDUCED_S,
                                        n_agents=a, device="cpu")
        batches = [sampler(g, i) for i in range(u)]
        eps = [torch.randn(state.posterior.mean.shape, generator=g) for _ in range(u)]
        card, card_losses = train_round(cfg, state, batches, eps, dev)
        cpu, cpu_losses = train_round(cfg, state, batches, eps, torch.device("cpu"))
        noise = functools.reduce(torch.logical_or, [adam_noise_lanes(x, y)
                                                    for x, y in zip(card, cpu)])
        fields = train_parity(card[-1], cpu[-1], noise, 2 * u * TRAIN_LR)
        loss_err = max(abs(x - y) for x, y in zip(card_losses, cpu_losses))
        if loss_err > PARITY_ATOL:
            fields["failures"].append(f"losses {loss_err} apart")
        if fields["failures"]:
            raise AssertionError(f"3.lm_train {arch} card vs CPU: {fields}")
        swapped = [{k: v.flip(0) for k, v in batch.items()} for batch in batches]
        wrong, _ = train_round(cfg, state, swapped, eps, dev)
        control = train_parity(wrong[-1], cpu[-1], noise, 2 * u * TRAIN_LR)
        if not control["failures"]:
            raise AssertionError(f"3.lm_train {arch}: the other agent's tokens pass the check")
        out[arch] = dict(fields, loss_max_abs_err=loss_err,
                         control_lanes_beyond=control["lanes_beyond"],
                         control_max_abs_err=control["max_abs_err"])
    return out


def run_lm_train(dev, smi):
    """Phase 3.lm_train: LM training at repro-100m's full width (P =
    163,597,056 an agent, bf16 compute, f32 posterior and Adam state),
    A = 2 on complete_w(2), launch/train.py's defaults.  ``launch.train``'s
    ``main`` for 3 rounds (eq. (6), then 4 local steps each): a finite loss
    each round, ``consensus_fused_network`` once a round, ``flash_attention``
    never (training differentiates ``chunked_attention``).  Then the steps
    themselves, each timed (CUDA events; wall on the host clock around a
    synchronised call): 3 round steps (u = 1), one u = 4 round (the
    consensus and its local steps), a ``bayesian=False`` step (KL exactly
    0), a profile of a round step and of a local step (device ms, kernels,
    busy share), 10 round steps on one batch (the loss must fall), the peak
    memory, each against ``launch.costmodel.analytic_costs``' bound over one
    card's peaks; the network kernel on the trained posterior against its
    plain version; and ``train_card_vs_cpu``.  Returns the
    ``consensus_fused_network_train`` row of the kernel line."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.graphs import complete_w
    from repro_torch.data.pipeline import make_lm_batch_sampler
    from repro_torch.kernels import consensus as kc
    from repro_torch.kernels import dispatch
    from repro_torch.launch import steps, train
    from repro_torch.launch.costmodel import analytic_costs
    from repro_torch.launch.dryrun import count_active_params, count_params, param_shapes
    from repro_torch.optim import adam
    from repro_torch.optim.schedules import exponential_decay

    cfg = get_config(TRAIN_ARCH)
    a, b, s, u = TRAIN_AGENTS, TRAIN_BATCH, TRAIN_S, TRAIN_U
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # launch/train.py's main, its defaults: 3 rounds of eq. (6) + 4 local steps
    printed = io.StringIO()
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        main_losses = train.main(["--arch", TRAIN_ARCH, "--rounds", str(TRAIN_ROUNDS),
                                  "--device", str(dev)])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    main_counts = dispatch.launch_counts()
    if (main_counts["consensus_fused_network"] != TRAIN_ROUNDS
            or main_counts["flash_attention"] != 0
            or not all(math.isfinite(x) for x in main_losses)):
        raise AssertionError(f"3.lm_train launch.train: losses {main_losses}, launches "
                             f"{main_counts}")

    W = torch.as_tensor(complete_w(a), dtype=torch.float32, device=dev)
    opt = adam()
    sched = exponential_decay(TRAIN_LR, TRAIN_LR_DECAY ** (1.0 / u))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps.init_train_state(cfg, a, opt, gen, device=dev)
    p = state.posterior.n_params()
    sampler = make_lm_batch_sampler(cfg.vocab_size, b, s, n_agents=a, device=dev)
    round_step = steps.make_train_round_step(cfg, W, opt=opt, lr_schedule=sched,
                                             kl_scale=TRAIN_KL, remat=False)
    local_step = steps.make_local_step(cfg, opt, sched, kl_scale=TRAIN_KL, remat=False)
    consensus = steps.make_consensus_step(cfg, W)

    def timed_wall(fn):  # (result, device ms, wall ms) of one synchronised call
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, ms = timed(fn)
        return out, ms, (time.perf_counter() - t) * 1e3

    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    rounds = []
    for r in range(TRAIN_ROUND_STEPS):
        batch = sampler(gen, r)
        (state, metrics), ms, wall = timed_wall(
            lambda st=state, bt=batch: round_step(st, bt, generator=gen))
        rounds.append({"device_ms": ms, "wall_ms": wall, "loss": float(metrics["loss"]),
                       "nll": metrics["nll"].tolist(), "kl": metrics["kl"].tolist()})
    prior, c_ms, c_wall = timed_wall(lambda: consensus(state.posterior))
    state = steps.BayesTrainState(posterior=prior, opt_state=state.opt_state, step=state.step)
    locals_ = []
    for i in range(u):
        batch = sampler(gen, TRAIN_ROUND_STEPS + i)
        (state, loss), ms, wall = timed_wall(
            lambda st=state, bt=batch: local_step(st, prior, bt, generator=gen))
        locals_.append({"device_ms": ms, "wall_ms": wall, "loss": float(loss)})
    del prior
    det_step = steps.make_train_round_step(cfg, W, opt=opt, lr_schedule=sched,
                                           kl_scale=TRAIN_KL, remat=False, bayesian=False)
    _, det = det_step(state, sampler(gen, 99))
    torch.cuda.synchronize()
    step_counts = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [x["loss"] for x in rounds + locals_] + [float(det["loss"])]
    if (step_counts["consensus_fused_network"] != TRAIN_ROUND_STEPS + 2
            or step_counts["flash_attention"] != 0 or not all(map(math.isfinite, losses))
            or torch.count_nonzero(det["kl"]) != 0):
        raise AssertionError(f"3.lm_train steps: losses {losses}, launches {step_counts}, "
                             f"deterministic KL {det['kl'].tolist()}")

    batch = sampler(gen, 100)
    profiles = {"round_step": lm_profile(lambda: round_step(state, batch, generator=gen)),
                "local_step": lm_profile(lambda: local_step(state, state.posterior, batch,
                                                            generator=gen))}
    fixed = []
    st = state
    for _ in range(TRAIN_FIXED_STEPS):  # one batch: the loss must fall
        st, metrics = round_step(st, batch, generator=gen)
        fixed.append(float(metrics["loss"]))
    del st
    if not (all(map(math.isfinite, fixed)) and fixed[-1] < fixed[0]):
        raise AssertionError(f"3.lm_train: 10 steps on one batch, losses {fixed}")

    # the network kernel on the trained posterior, against its plain version
    post = state.posterior
    network = functools.partial(kc.consensus_fused_network, W, post.mean, post.rho)
    plain = functools.partial(kc.consensus_network_plain, W, post.mean, post.rho)
    eq6_err = 0.0
    for g, w in zip(network(), plain()):
        err = (g - w).abs()
        if not bool(torch.all(err <= F32_TOL + F32_TOL * w.abs())):
            raise AssertionError(f"3.lm_train consensus: max err {float(err.max())}")
        eq6_err = max(eq6_err, float(err.max()))
    nbytes, ops = 16 * a * p + 4 * a * a, 4 * a * a * p + 20 * a * p
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    row = {"name": "consensus_fused_network_train", "route": "cuda",
           "source": SRC + "consensus_network.cu", "replaces": REF + "195",
           "launches": main_counts["consensus_fused_network"], "max_abs_err": eq6_err,
           "ms": cuda_ms(network), "plain_ms": event_ms(plain), "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}
    del post, state, network, plain

    shapes = param_shapes(cfg)
    costs = analytic_costs(cfg, mode="train", batch_global=a * b, seq_len=s, n_agents=a,
                           data_shards=1, model_shards=1,
                           n_matmul_params=count_active_params(shapes, cfg),
                           n_total_params=count_params(shapes))
    bound = {"flops": costs["flops_global"], "hbm_bytes": costs["hbm_bytes_global"],
             "compute_ms": costs["flops_global"] / BF16_FLOP_PER_S * 1e3,
             "memory_ms": costs["hbm_bytes_global"] / HBM_BYTES_PER_S * 1e3}
    bound["ms"] = max(bound["compute_ms"], bound["memory_ms"])
    med = sorted(x["device_ms"] for x in rounds)[len(rounds) // 2]
    local_med = sorted(x["device_ms"] for x in locals_)[len(locals_) // 2]
    torch.cuda.empty_cache()
    parity = train_card_vs_cpu(dev)
    # busy: the profiled device time over the event-timed step (the profiler's
    # own wall carries its start-up)
    busy = {"round_step": profiles["round_step"]["device_ms"] / med,
            "local_step": profiles["local_step"]["device_ms"] / local_med}
    phase("3.lm_train", nvidia_smi=smi, arch=TRAIN_ARCH, agents=a, batch_per_agent=b, seq=s,
          local_steps=u, n_params_per_agent=p, launch_train_s=main_s,
          launch_train_losses=main_losses, launch_train_lines=printed.getvalue().splitlines(),
          launch_train_launches=main_counts, round_steps=rounds,
          round_u4={"consensus_device_ms": c_ms, "consensus_wall_ms": c_wall,
                    "local_steps": locals_,
                    "device_ms": c_ms + sum(x["device_ms"] for x in locals_),
                    "wall_ms": c_wall + sum(x["wall_ms"] for x in locals_)},
          deterministic={"loss": float(det["loss"]), "kl": det["kl"].tolist()},
          step_launches=step_counts, fixed_batch_losses=fixed, profiles=profiles, busy=busy,
          max_memory_allocated=peak, bound=bound,
          round_step_device_ms_median=med, local_step_device_ms_median=local_med,
          round_step_bound_share=bound["ms"] / med, local_step_bound_share=bound["ms"] / local_med,
          consensus_ms=row["ms"], consensus_max_abs_err=eq6_err, card_vs_cpu=parity)
    return row


def run_lm_whisper_train(dev, smi):
    """Phase 3.lm_whisper_train: Whisper-tiny trained at full width (P =
    61,153,536 an agent, bf16 compute, f32 posterior and Adam state), A = 2
    on complete_w(2), WHISPER_BATCH clips an agent of 1,500 frames (normal
    x 0.1) and WHISPER_TEXT Zipf tokens, Adam at TRAIN_LR decaying
    TRAIN_LR_DECAY a round, kl_scale TRAIN_KL: one round step (u = 1), one
    u = 4 round (``make_consensus_step`` and 4 ``make_local_step`` steps),
    each timed (CUDA events; wall on the host clock around a synchronised
    call); a profile of a round step (device ms, kernels, busy share); 10
    round steps on one batch (the loss must fall); ``consensus_fused_network``
    once a consensus, ``flash_attention`` never (training differentiates
    ``chunked_attention``); every loss finite; the peak memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.graphs import complete_w
    from repro_torch.data.pipeline import make_lm_batch_sampler
    from repro_torch.kernels import dispatch
    from repro_torch.launch import steps
    from repro_torch.optim import adam
    from repro_torch.optim.schedules import exponential_decay

    cfg = get_config("whisper-tiny")
    a, b, s, u = TRAIN_AGENTS, WHISPER_BATCH, WHISPER_TEXT, TRAIN_U
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    W = torch.as_tensor(complete_w(a), dtype=torch.float32, device=dev)
    opt = adam()
    sched = exponential_decay(TRAIN_LR, TRAIN_LR_DECAY ** (1.0 / u))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps.init_train_state(cfg, a, opt, gen, device=dev)
    p = state.posterior.n_params()
    sampler = make_lm_batch_sampler(cfg.vocab_size, b, s, n_agents=a, device=dev)

    def batch(r):
        return {**sampler(gen, r), **lm_front(cfg, b, dev, seed=100 + r)}

    round_step = steps.make_train_round_step(cfg, W, opt=opt, lr_schedule=sched,
                                             kl_scale=TRAIN_KL, remat=False)
    local_step = steps.make_local_step(cfg, opt, sched, kl_scale=TRAIN_KL, remat=False)
    consensus = steps.make_consensus_step(cfg, W)

    def timed_wall(fn):  # (result, device ms, wall ms) of one synchronised call
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, ms = timed(fn)
        return out, ms, (time.perf_counter() - t) * 1e3

    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    bt = batch(0)
    (state, first), round_ms, round_wall = timed_wall(lambda: round_step(state, bt,
                                                                         generator=gen))
    losses = [float(first["loss"])]
    prior, c_ms, c_wall = timed_wall(lambda: consensus(state.posterior))
    state = steps.BayesTrainState(posterior=prior, opt_state=state.opt_state, step=state.step)
    locals_ = []
    for i in range(u):
        bt = batch(1 + i)
        (state, loss), ms, wall = timed_wall(
            lambda st=state, bt=bt: local_step(st, prior, bt, generator=gen))
        locals_.append({"device_ms": ms, "wall_ms": wall, "loss": float(loss)})
    del prior
    bt = batch(99)
    fixed, st = [], state
    for _ in range(TRAIN_FIXED_STEPS):  # one batch: the loss must fall
        st, metrics = round_step(st, bt, generator=gen)
        fixed.append(float(metrics["loss"]))
    del st
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    losses += [x["loss"] for x in locals_]
    if (counts["consensus_fused_network"] != 2 + TRAIN_FIXED_STEPS
            or counts["flash_attention"] != 0 or not all(map(math.isfinite, losses + fixed))):
        raise AssertionError(f"3.lm_whisper_train: losses {losses}, launches {counts}")
    if not fixed[-1] < fixed[0]:
        raise AssertionError(f"3.lm_whisper_train: 10 steps on one batch, losses {fixed}")
    profile = lm_profile(lambda: round_step(state, bt, generator=gen))
    del state
    torch.cuda.empty_cache()
    phase("3.lm_whisper_train", nvidia_smi=smi, agents=a, batch_per_agent=b, text=s,
          frames=cfg.encoder_seq, local_steps=u, n_params_per_agent=p,
          round_step={"device_ms": round_ms, "wall_ms": round_wall, "loss": losses[0],
                      "nll": first["nll"].tolist(), "kl": first["kl"].tolist()},
          round_u4={"consensus_device_ms": c_ms, "consensus_wall_ms": c_wall,
                    "local_steps": locals_,
                    "device_ms": c_ms + sum(x["device_ms"] for x in locals_),
                    "wall_ms": c_wall + sum(x["wall_ms"] for x in locals_)},
          fixed_batch_losses=fixed, launches=counts, profile=profile,
          busy=profile["device_ms"] / round_ms, max_memory_allocated=peak)


def flat_view(post):
    """A pytree posterior's ``[A, P]`` flat form (``core.flat``'s layout),
    for the checks that read flat buffers."""
    from repro_torch.core.flat import flat_posterior_from_pytree

    return flat_posterior_from_pytree(post, leading_axes=1)


def flat_state(state):
    """A pytree ``BayesTrainState``'s posterior and Adam moments in flat
    form (``train_parity``'s and ``adam_noise_lanes``' inputs)."""
    from types import SimpleNamespace

    mu, nu = state.opt_state.mu, state.opt_state.nu
    return SimpleNamespace(posterior=flat_view(state.posterior),
                           opt_state=SimpleNamespace(mu=flat_view(mu), nu=flat_view(nu)))


def run_lm_train_pod(dev, smi):
    """Phase 3.lm_train_pod: the pod axis of the LM mesh at repro-100m's
    full width (P = 163,597,056 an agent), A = 2 on LM_ZOO_W,
    launch/train.py's defaults (TRAIN_BATCH x TRAIN_S Zipf tokens, Adam at
    TRAIN_LR, kl_scale TRAIN_KL, bf16 compute).  A flat state and a pytree
    state (``init_train_state(flat=False)``) from one generator seed, agent
    1's mean moved by one seeded draw in both, on a ``("pod", "data",
    "model")`` mesh of (2, 1, 1) virtual shards of the card, the posterior
    shardings from ``param_shardings(state, mesh, agent_leading=True)``.
    Held: ``consensus_ppermute_pod`` at the bf16 wire bitwise
    ``consensus_ppermute_ring_flat`` on the flat posterior, leaf by leaf
    (control: W with its rows swapped, which must differ), its rotated
    bytes 2 A P 2 B; one ``make_train_round_step(consensus_impl=
    "ppermute")`` of each state from one ``eps``, the pytree's within the
    round-step tests' 1e-4 rule (``train_parity``) of the flat one (the
    share of bitwise-equal lanes printed); ``serve_params`` of the
    pytree-trained and of the flat-trained posterior, a prefill of S =
    LM_SMALL_S each, within LM_BF16_ATOL / LM_BF16_RMS of each other
    (whether bitwise printed; control: the prefill of the posterior before
    the round, which must read beyond them), ``flash_attention`` once a
    layer a prefill, the row's launches counted from 0 over the first
    prefill alone.  Read: TRAIN_ROUND_STEPS round steps of each form (device ms
    from CUDA events, wall ms), a profile of each (kernels a step), each
    form's peak memory, beside ``analytic_costs``' bound.  Over two real
    cards where the host has them: the pod consensus bitwise the virtual
    run.  Returns the ``flash_attention_train_pod`` row of the kernel line
    (the kernel at the prefill's shape)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import make_lm_batch_sampler
    from repro_torch.kernels import dispatch
    from repro_torch.launch import consensus_opt as co
    from repro_torch.launch import steps
    from repro_torch.launch.costmodel import analytic_costs
    from repro_torch.launch.dryrun import count_active_params, count_params, param_shapes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.optim import adam
    from repro_torch.optim.schedules import exponential_decay

    cfg = get_config(TRAIN_ARCH)
    a, b, s, u = TRAIN_AGENTS, TRAIN_BATCH, TRAIN_S, TRAIN_U
    bf16 = torch.bfloat16
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    opt = adam()
    sched = exponential_decay(TRAIN_LR, TRAIN_LR_DECAY ** (1.0 / u))
    flat = steps.init_train_state(cfg, a, opt, torch.Generator(device=dev).manual_seed(0),
                                  device=dev)
    tree = steps.init_train_state(cfg, a, opt, torch.Generator(device=dev).manual_seed(0),
                                  device=dev, flat=False)
    layout = flat.posterior.layout
    p = flat.posterior.n_params()
    if not all(torch.equal(x, y) for x, y in zip(tree_leaves(flat_view(tree.posterior)),
                                                  tree_leaves(flat.posterior))):
        raise AssertionError("3.lm_train_pod: the pytree and flat states of one seed differ")
    moved = 1e-2 * torch.randn(p, generator=torch.Generator(device=dev).manual_seed(1),
                               device=dev)
    flat.posterior.mean[1] += moved
    for leaf, m in zip(tree_leaves(tree.posterior.mean), tree_leaves(layout.unflatten(moved))):
        leaf[1] += m
    del moved
    W = torch.as_tensor(LM_ZOO_W, dtype=torch.float32, device=dev)
    mesh = make_mesh((a, 1, 1), ("pod", "data", "model"), dev)
    tree_sh = param_shardings(tree, mesh, agent_leading=True).posterior
    flat_sh = param_shardings(flat, mesh, agent_leading=True).posterior

    # the pod consensus against the flat ring, leaf by leaf
    co.reset_rotation_counts()
    pod = co.consensus_ppermute_pod(tree.posterior, W, mesh, tree_sh, wire_dtype=bf16)
    rotated = co.rotation_counts()
    ring = co.consensus_ppermute_ring_flat(flat.posterior, mesh, "pod", wire_dtype=bf16, W=W)
    ring_tree = (layout.unflatten(ring.mean), layout.unflatten(ring.rho))
    leaves_equal = [torch.equal(x, y) for x, y in zip(
        tree_leaves((pod.mean, pod.rho)), tree_leaves(ring_tree))]
    if not all(leaves_equal):
        raise AssertionError(f"3.lm_train_pod: the pod prior differs from the ring's in "
                             f"{leaves_equal.count(False)} of {len(leaves_equal)} leaves")
    swapped = co.consensus_ppermute_ring_flat(flat.posterior, mesh, "pod", wire_dtype=bf16,
                                              W=W.flip(0))
    control = float((flat_view(pod).mean - swapped.mean).abs().max())
    if control == 0.0:
        raise AssertionError("3.lm_train_pod: W with its rows swapped gives the pod's prior")
    del ring, ring_tree, swapped
    want_bytes = 2 * a * p * 2
    if rotated["bytes"] != want_bytes:
        raise AssertionError(f"3.lm_train_pod: rotated {rotated}, expected {want_bytes} bytes")
    cards = {}
    if torch.cuda.device_count() >= 2:
        real = make_mesh((a, 1, 1), ("pod", "data", "model"),
                         [torch.device("cuda", i) for i in range(a)])
        got = co.consensus_ppermute_pod(tree.posterior, W, real, param_shardings(
            tree, real, agent_leading=True).posterior, wire_dtype=bf16)
        cards = {"cards": a, "bitwise_virtual": all(
            torch.equal(x, y) for x, y in zip(tree_leaves(got), tree_leaves(pod)))}
        if not cards["bitwise_virtual"]:
            raise AssertionError(f"3.lm_train_pod: over real cards {cards}")
        del got
    del pod

    # one round of each form from one eps, the pytree within the 1e-4 rule
    kw = dict(opt=opt, lr_schedule=sched, kl_scale=TRAIN_KL, remat=False,
              consensus_impl="ppermute", consensus_wire_dtype=bf16, mesh=mesh)
    tree_step = steps.make_train_round_step(cfg, W, posterior_shardings=tree_sh, **kw)
    flat_step = steps.make_train_round_step(cfg, W, posterior_shardings=flat_sh, **kw)
    gen = torch.Generator(device=dev).manual_seed(2)
    sampler = make_lm_batch_sampler(cfg.vocab_size, b, s, n_agents=a, device=dev)
    batch = sampler(gen, 0)
    eps = torch.randn((a, p), generator=gen, device=dev)
    toks = lm_tokens(cfg, LM_SMALL_S, dev, seed=5)
    serve_cfg = dataclasses.replace(cfg, dtype="bfloat16")

    def prefill(post):  # next-token logits of one prefill served from ``post``
        params = steps.serve_params(post, bf16)
        cache = steps.make_agent_cache(serve_cfg, a, LM_BATCH, LM_SMALL_S, dtype=bf16,
                                       device=dev)
        return steps.make_prefill_step(serve_cfg)(params, {"tokens": toks}, cache)[0]

    before = prefill(tree.posterior)  # the served check's control
    state, tree_m = tree_step(tree, batch, eps=layout.unflatten(eps))
    flat1, flat_m = flat_step(flat, batch, eps=eps)
    del eps, tree, flat
    got = flat_state(state)
    noise = adam_noise_lanes(got, flat1)
    parity = train_parity(got, flat1, noise, 2 * TRAIN_LR)
    if parity["failures"]:
        raise AssertionError(f"3.lm_train_pod: pytree round vs flat round: {parity}")
    bitwise_share = float((got.posterior.mean == flat1.posterior.mean).float().mean())
    metrics = {k: float((tree_m[k] - flat_m[k]).abs().max()) for k in ("loss", "nll", "kl")}
    if max(metrics.values()) > PARITY_ATOL:
        raise AssertionError(f"3.lm_train_pod: metrics apart {metrics}")
    del got, noise

    # serving: the pytree-trained posterior against the flat-trained one, a prefill each
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    served_tree = prefill(state.posterior)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    served_flat = prefill(flat1.posterior)
    torch.cuda.synchronize()
    both = dispatch.launch_counts()
    if counts["flash_attention"] != cfg.n_layers or both["flash_attention"] != 2 * cfg.n_layers:
        raise AssertionError(f"3.lm_train_pod: launches {counts} in the first prefill, "
                             f"{both} in both")
    served = lm_check("3.lm_train_pod pytree-trained vs flat-trained prefill", served_tree,
                      served_flat, LM_BF16_ATOL, LM_BF16_RMS)
    served_bitwise = torch.equal(served_tree, served_flat)
    served_control = lm_control("3.lm_train_pod the prefill before the round (control)",
                                before, served_flat, LM_BF16_ATOL, LM_BF16_RMS)
    del flat1, before, served_tree, served_flat

    def timed_wall(fn):  # (result, device ms, wall ms) of one synchronised call
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, ms = timed(fn)
        return out, ms, (time.perf_counter() - t) * 1e3

    def series(name, step, state):
        """TRAIN_ROUND_STEPS round steps with only ``state`` resident, then
        a profile of one more; returns (the reading, the last state)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        co.reset_rotation_counts()
        rounds = []
        for r in range(TRAIN_ROUND_STEPS):
            bt = sampler(gen, 1 + r)
            (state, m), ms, wall = timed_wall(
                lambda st=state, bt=bt: step(st, bt, generator=gen))
            rounds.append({"device_ms": ms, "wall_ms": wall, "loss": float(m["loss"])})
        moved = co.rotation_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        prof = lm_profile(lambda st=state: step(st, sampler(gen, 99), generator=gen))
        if not all(math.isfinite(x["loss"]) for x in rounds):
            raise AssertionError(f"3.lm_train_pod {name}: losses {rounds}")
        return {"round_steps": rounds,
                "device_ms_median": sorted(x["device_ms"] for x in rounds)[len(rounds) // 2],
                "kernels_a_step": prof["device_kernels"], "profile": prof,
                "max_memory_allocated": peak,
                "rotated_bytes_a_round": moved["bytes"] // TRAIN_ROUND_STEPS}, state

    runs = {}
    runs["pytree"], state = series("pytree", tree_step, state)

    # the flat form of the same state, alone on the card, for the flat step's reading
    flat_form = flat_state(state)
    state = steps.BayesTrainState(
        posterior=flat_form.posterior,
        opt_state=dataclasses.replace(state.opt_state, mu=flat_form.opt_state.mu,
                                      nu=flat_form.opt_state.nu), step=state.step)
    del flat_form
    runs["flat"], state = series("flat", flat_step, state)
    del state
    torch.cuda.empty_cache()

    shapes = param_shapes(cfg)
    costs = analytic_costs(cfg, mode="train", batch_global=a * b, seq_len=s, n_agents=a,
                           data_shards=1, model_shards=1,
                           n_matmul_params=count_active_params(shapes, cfg),
                           n_total_params=count_params(shapes))
    bound = {"compute_ms": costs["flops_global"] / BF16_FLOP_PER_S * 1e3,
             "memory_ms": costs["hbm_bytes_global"] / HBM_BYTES_PER_S * 1e3}
    bound["ms"] = max(bound.values())
    q = torch.randn((a, LM_BATCH, LM_SMALL_S, cfg.n_heads, cfg.hd),
                    generator=torch.Generator(device=dev).manual_seed(6), device=dev).to(bf16)
    k, v = (torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(7 + i),
                        device=dev).to(bf16) for i in range(2))
    attention, row = attention_kernel_row("3.lm_train_pod", "flash_attention_train_pod", cfg,
                                          q, k, v, 0, counts["flash_attention"])
    del q, k, v
    torch.cuda.empty_cache()
    phase("3.lm_train_pod", nvidia_smi=smi, arch=TRAIN_ARCH, agents=a, batch_per_agent=b,
          seq=s, n_params_per_agent=p, mesh=mesh.shape, wire="bf16",
          pod_leaves=len(leaves_equal), pod_leaves_bitwise_ring=sum(leaves_equal),
          rows_swapped_control_max_abs=control, pod_rotations=rotated,
          rotated_bytes_expected=want_bytes, real_cards=cards or "one card",
          round_vs_flat={**parity, "metrics_max_abs_err": metrics,
                         "bitwise_equal_lane_share": bitwise_share},
          runs=runs, bound=bound,
          bound_share={name: bound["ms"] / r["device_ms_median"] for name, r in runs.items()},
          served_vs_flat_trained={"max_abs_err": served[0], "relative_rms": served[1],
                                  "bitwise": served_bitwise},
          served_before_round_control={"max_abs_err": served_control[0],
                                       "relative_rms": served_control[1]},
          launches=counts, launches_two_prefills=both, attention=attention)
    return row


def spmd_train_pair(name, cfg, state, W, mesh, batch, eps, tag="3.lm_spmd", profile=True,
                    launches=None, on_placed=None, **kw):
    """Round steps of ``state`` unsharded and of it placed on ``mesh``
    (``param_shardings(state, mesh, agent_leading=True)``), each twice from
    the same batch and ``eps`` (the second warm; the first's result freed
    before it): (both new states on the card, the metrics, the placed
    step's reading: device ms of each step from CUDA events, first and
    warm, the network kernel's launches (``launches``, default one a (data,
    model) position), the gathered and rotated bytes and the peak memory of
    the first placed step beside what was allocated before it, and, with
    ``profile``, its kernels from a profile of one more; ``on_placed(state)``'s
    reading of the warm step's placed state, before it is joined).  The
    ppermute route's unplaced ring runs over ``mesh``."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.launch import consensus_opt, spmd, steps
    from repro_torch.launch.sharding import param_shardings

    if kw.get("consensus_impl") == "ppermute":  # the unplaced ring's mesh and shardings
        kw.update(mesh=mesh, posterior_shardings=param_shardings(
            state, mesh, agent_leading=True).posterior)
    step = steps.make_train_round_step(cfg, W, **kw)
    (want, want_m), unsharded_first_ms = timed(lambda: step(state, batch, eps=eps))
    del want, want_m
    (want, want_m), unsharded_ms = timed(lambda: step(state, batch, eps=eps))
    placed = spmd.device_put(state, param_shardings(state, mesh, agent_leading=True))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    spmd.reset_spmd_counts()
    consensus_opt.reset_rotation_counts()
    (got, got_m), first_ms = timed(lambda: step(placed, batch, eps=eps))
    torch.cuda.synchronize()
    counts, moved = dispatch.launch_counts(), spmd.spmd_counts()
    rotated = consensus_opt.rotation_counts()
    peak = torch.cuda.max_memory_allocated()
    del got, got_m
    (got, got_m), ms = timed(lambda: step(placed, batch, eps=eps))
    prof = (lm_profile(lambda: step(placed, batch, eps=eps)) if profile
            else {"device_kernels": "not measured"})
    expect = mesh.size // mesh.shape["pod"] if launches is None else launches
    if counts["consensus_fused_network"] != expect:
        raise AssertionError(f"{tag} {name}: launches {counts}, {expect} of the network "
                             f"kernel expected")
    placed_reading = None if on_placed is None else on_placed(got)
    got = spmd.device_get(got)
    reading = {"mesh": mesh.shape, "ms": ms, "first_ms": first_ms,
               "unsharded_ms": unsharded_ms, "unsharded_first_ms": unsharded_first_ms,
               "consensus_fused_network": counts["consensus_fused_network"],
               "flash_attention": counts["flash_attention"],
               "spmd": {k: v for k, v in moved.items() if k != "gather_by_position"},
               "gather_bytes_by_position_max": max(moved["gather_by_position"].values(),
                                                   default=0),
               "rotated": rotated, "kernels_a_step": prof["device_kernels"], "profile": prof,
               "max_memory_allocated": peak, "memory_allocated_before": before,
               "loss": float(got_m["loss"]), "unsharded_loss": float(want_m["loss"])}
    if placed_reading is not None:
        reading["placed"] = placed_reading
    return got, want, got_m, want_m, reading


def run_lm_spmd(dev, smi):
    """Phase 3.lm_spmd: the language models' sharded execution
    (``launch.spmd_steps`` through ``launch.steps`` on inputs placed by
    ``launch.spmd.device_put``) over a ``("pod", "data", "model")`` mesh of
    virtual shards of the card, single controller.

    (a) Serving: Qwen3-8B at full width and depth, 3.lm_qwen3_8b's weights
    and prompts (A = 2 x B = 2, S = 4,096 Zipf tokens, bf16, a 4,128-slot
    cache), placed on (2, 2, 2) by ``param_shardings(..., agent_leading=
    True)``, ``cache_shardings`` and ``batch_pspec``: a prefill (first and
    warm) and SPMD_DECODE decode steps on the unsharded step's own inputs,
    each against the unsharded step of the same call on the same weights
    (LM_BF16_ATOL / LM_BF16_RMS; control: the agents swapped, which must
    fail); ``flash_attention`` 36 x 8 = 288 times in one prefill, read
    after a counter reset; the gathered and all-reduced bytes of the
    prefill and of a decode step equal to ``forward_gather_bytes``' formula,
    each position's gathers under its bound; each position's placed bytes
    equal to ``sharding_report``'s per-device bytes; prefill ms and decode
    ms a step (CUDA events) beside the unsharded steps'; peak memory; a
    profile of one sharded decode step; and ``flash_attention`` at a
    position's shape ([1, 16, 4096, 128], layer 0's own q/k/v of position
    (0, 0, 0)) against its plain version, beside SDPA.

    (b) Training: repro-100m at full width, 3.lm_train's A = 2, batch,
    Adam, lr and kl_scale, with 3.lm_train_pod's W (LM_ZOO_W) and agent 1's
    mean moved by one seeded draw, at float32 compute (TF32 off): the
    placed step splits its products over positions, so at bf16 the two
    steps' gradients part by bf16 roundings, beyond ``train_parity``'s
    1e-4 on Adam's moments, which holds fp32 sums in another order.  A
    pytree state on (2, 2, 2), one placed
    round step against the unsharded pytree round step from one ``eps``,
    within ``train_parity``; a flat state on (2, 1, 1), one placed round
    step against the unsharded one, bitwise (both run one agent a block on
    the card).  For each: ``consensus_fused_network`` once a (data, model)
    position, the gathered bytes, step ms from CUDA events beside the
    unsharded step's, kernels a step (a profile) and peak memory; and the
    network kernel on position (0, 0, 0)'s blocks of the pytree state,
    against its plain version.

    (c) Real cards: where the host has two or more, (a)'s prefill and
    first decode step and (b)'s two steps again with each pod on a card of
    its own, bitwise the virtual run; else the reason it was skipped.

    Returns the kernel line's ``flash_attention_spmd`` and
    ``consensus_fused_network_spmd`` rows."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import make_lm_batch_sampler
    from repro_torch.kernels import consensus as kc
    from repro_torch.kernels import dispatch
    from repro_torch.launch import spmd, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import (
        NamedSharding,
        batch_pspec,
        cache_shardings,
        param_shardings,
        sharding_report,
    )
    from repro_torch.launch.spmd_steps import forward_gather_bytes
    from repro_torch.models import attention as att
    from repro_torch.models.modules import embed, rmsnorm
    from repro_torch.optim import adam
    from repro_torch.optim.schedules import exponential_decay

    tag = "3.lm_spmd"
    axes = ("pod", "data", "model")
    n_cards = torch.cuda.device_count()

    def pod_cards(shape):  # each pod on a card of its own
        n = math.prod(shape) // shape[0]
        return [torch.device("cuda", p) for p in range(shape[0]) for _ in range(n)]

    # (a) serving: Qwen3-8B at full width and depth on (2, 2, 2)
    cfg = get_config("qwen3-8b")
    a, b, s = LM_AGENTS, LM_BATCH, LM_S
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm_params(cfg, dev, a, torch.bfloat16)
    toks = lm_tokens(cfg, s + 1 + LM_DECODE, dev)  # 3.lm_qwen3_8b's prompts
    prompt = {"tokens": toks[..., :s]}
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    cache = steps.make_agent_cache(cfg, a, b, LM_CAP, device=dev)
    (ref, cache), ref_ms = timed(lambda: prefill(params, prompt, cache))
    (ref, cache), ref_warm_ms = timed(lambda: prefill(params, prompt, cache))
    ref_dec, inputs, ref_dec_ms, _, cache = lm_decode(decode, params, toks[..., s:s + 1], s,
                                                      SPMD_DECODE, cache)
    forced = torch.cat(inputs, dim=-1)  # each unsharded step's input token
    del cache

    mesh = make_mesh((2, 2, 2), axes, dev)
    placed = spmd.device_put(params, param_shardings(params, mesh, agent_leading=True))
    report = sharding_report(params, mesh, agent_leading=True)
    placed_bytes = [spmd.position_bytes(placed, i) for i in range(mesh.size)]
    if set(placed_bytes) != {report[2]}:
        raise AssertionError(f"{tag}: placed bytes a position {placed_bytes}, sharding_report "
                             f"{report}")
    cache = steps.make_agent_cache(cfg, a, b, LM_CAP, device=dev)
    cache = spmd.device_put(cache, cache_shardings(cache, mesh))
    tokens = spmd.place(prompt["tokens"], NamedSharding(mesh, batch_pspec(mesh, (a, b, s))))
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    spmd.reset_spmd_counts()
    (logits, cache), first_ms = timed(lambda: prefill(placed, {"tokens": tokens}, cache))
    torch.cuda.synchronize()
    counts, moved = dispatch.launch_counts(), spmd.spmd_counts()
    (logits, cache), warm_ms = timed(lambda: prefill(placed, {"tokens": tokens}, cache))
    spmd.reset_spmd_counts()
    dec, _, dec_ms, dec_wall, cache = lm_decode(decode, placed, toks[..., s:s + 1], s,
                                                SPMD_DECODE, cache, tokens=forced)
    dec_moved = spmd.spmd_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    expect = cfg.n_layers * mesh.size
    if counts["flash_attention"] != expect:
        raise AssertionError(f"{tag}: flash_attention launched {counts['flash_attention']} "
                             f"times in a sharded prefill, expected {expect}")
    formula = forward_gather_bytes(cfg, mesh, b, s, 2, a)
    dec_formula = forward_gather_bytes(cfg, mesh, b, 1, 2, a)
    traffic = {
        "prefill": {k: moved[f"{k}_bytes"] for k in ("gather", "all_reduce")},
        "prefill_formula": {k: formula[k] for k in ("gather", "all_reduce")},
        "decode_step": {k: dec_moved[f"{k}_bytes"] / SPMD_DECODE for k in ("gather", "all_reduce")},
        "decode_step_formula": {k: dec_formula[k] for k in ("gather", "all_reduce")},
        "prefill_gather_by_position_max": max(moved["gather_by_position"].values()),
        "gather_per_position_bound": formula["gather_per_position_max"],
        "weight_bytes_an_agent": tree_bytes(params) // a}
    if (traffic["prefill"] != traffic["prefill_formula"]
            or traffic["decode_step"] != traffic["decode_step_formula"]
            or traffic["prefill_gather_by_position_max"] > formula["gather_per_position_max"]):
        raise AssertionError(f"{tag}: gathered bytes against the formula: {traffic}")
    whole = lm_check(f"{tag} sharded vs unsharded prefill", logits, ref, LM_BF16_ATOL,
                     LM_BF16_RMS)
    whole_ctrl = lm_control(f"{tag} the agents swapped (control)", logits.flip(0), ref,
                            LM_BF16_ATOL, LM_BF16_RMS)
    steps_err = [lm_check(f"{tag} sharded vs unsharded decode {i}", x, y, LM_BF16_ATOL,
                          LM_BF16_RMS) for i, (x, y) in enumerate(zip(dec, ref_dec))]
    dec_ctrl = lm_control(f"{tag} decode 0, the agents swapped (control)", dec[0].flip(0),
                          ref_dec[0], LM_BF16_ATOL, LM_BF16_RMS)
    prof = lm_profile(lambda: decode(placed, forced[..., -1:], s + SPMD_DECODE, cache))
    serving_cards = None
    if n_cards >= 2:
        real = make_mesh((2, 2, 2), axes, pod_cards((2, 2, 2)))
        r_params = spmd.device_put(params, param_shardings(params, real, agent_leading=True))
        r_cache = steps.make_agent_cache(cfg, a, b, LM_CAP, device=dev)
        r_cache = spmd.device_put(r_cache, cache_shardings(r_cache, real))
        r_logits, r_cache = prefill(r_params, prompt, r_cache)
        v_cache = steps.make_agent_cache(cfg, a, b, LM_CAP, device=dev)
        v_cache = spmd.device_put(v_cache, cache_shardings(v_cache, mesh))
        v_logits, v_cache = prefill(placed, prompt, v_cache)
        r_dec, _ = decode(r_params, toks[..., s:s + 1], s, r_cache)
        v_dec, _ = decode(placed, toks[..., s:s + 1], s, v_cache)
        serving_cards = {"cards": 2, "prefill_bitwise_virtual": torch.equal(r_logits, v_logits),
                         "decode_bitwise_virtual": torch.equal(r_dec, v_dec)}
        del r_params, r_cache, v_cache
        if not all(serving_cards.values()):
            raise AssertionError(f"{tag} over real cards: {serving_cards}")

    # flash_attention at a position's shape: layer 0's q/k/v of position (0, 0, 0)
    hl, kvl = cfg.n_heads // 2, cfg.n_kv_heads // 2
    layer0 = tree_map(lambda x: x[0, 0, 0], params["stacks"]["attn"])
    emb0 = {"emb": params["embed"]["emb"][0]}
    h = rmsnorm(layer0["norm1"], embed(emb0, toks[0, :1, :s], torch.bfloat16), cfg.norm_eps)
    q, k, v = att.attention_qkv(layer0["attn"], h, cfg, torch.arange(s, device=dev))
    q = q[None, ..., :hl, :].contiguous()
    k, v = (att._repeat_kv(t[None, ..., :kvl, :], hl).contiguous() for t in (k, v))
    del params, placed, cache, h, layer0, emb0
    torch.cuda.empty_cache()
    attention, flash_row = attention_kernel_row(tag, "flash_attention_spmd", cfg, q, k, v, 0,
                                                counts["flash_attention"])
    del q, k, v
    torch.cuda.empty_cache()
    serving = {"model": cfg.name, "mesh": mesh.shape, "agents": a, "batch_per_agent": b,
               "prompt": s, "capacity": LM_CAP, "prefill_first_ms": first_ms,
               "prefill_warm_ms": warm_ms, "unsharded_prefill_ms": ref_ms,
               "unsharded_prefill_warm_ms": ref_warm_ms,
               "decode_ms_median": statistics.median(dec_ms),
               "unsharded_decode_ms_median": statistics.median(ref_dec_ms),
               "decode_wall_s": dec_wall, "decode_steps": SPMD_DECODE,
               "prefill_max_abs_err_rel_rms": whole, "agents_swapped_control": whole_ctrl,
               "decode_max_abs_err_rel_rms": steps_err, "decode_control": dec_ctrl,
               "atol": LM_BF16_ATOL, "rms_tol": LM_BF16_RMS,
               "flash_attention_a_prefill": counts["flash_attention"],
               "flash_attention_expected": expect, "traffic": traffic,
               "placed_bytes_a_position": placed_bytes[0],
               "sharding_report_per_device": report[2], "max_memory_allocated": peak,
               "decode_profile": prof, "real_cards": serving_cards or f"{n_cards} card(s)"}

    # (b) training: repro-100m at full width, float32 compute (train_parity's setting)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    a, b, s, u = TRAIN_AGENTS, TRAIN_BATCH, TRAIN_S, TRAIN_U
    torch.cuda.empty_cache()
    opt = adam()
    kw = dict(opt=opt, lr_schedule=exponential_decay(TRAIN_LR, TRAIN_LR_DECAY ** (1.0 / u)),
              kl_scale=TRAIN_KL, remat=False)
    W = torch.as_tensor(LM_ZOO_W, dtype=torch.float32, device=dev)
    tree = steps.init_train_state(cfg, a, opt, torch.Generator(device=dev).manual_seed(0),
                                  device=dev, flat=False)
    layout = flat_view(tree.posterior).layout
    p = layout.n_params
    gen = torch.Generator(device=dev).manual_seed(1)
    moved_by = 1e-2 * torch.randn(p, generator=gen, device=dev)
    for leaf, m in zip(tree_leaves(tree.posterior.mean), tree_leaves(layout.unflatten(moved_by))):
        leaf[1] += m
    del moved_by
    batch = make_lm_batch_sampler(cfg.vocab_size, b, s, n_agents=a, device=dev)(gen, 0)
    eps = torch.randn((a, p), generator=gen, device=dev)
    mesh3 = make_mesh((2, 2, 2), axes, dev)
    got, want, got_m, want_m, tree_run = spmd_train_pair(
        "pytree", cfg, tree, W, mesh3, batch, layout.unflatten(eps), **kw)
    noise = adam_noise_lanes(flat_state(got), flat_state(want))
    parity = train_parity(flat_state(got), flat_state(want), noise, 2 * TRAIN_LR)
    if parity["failures"]:
        raise AssertionError(f"{tag} pytree (2, 2, 2) vs unsharded: {parity}")
    tree_run["parity"] = parity
    tree_run["metrics_max_abs_err"] = {k: float((got_m[k] - want_m[k]).abs().max())
                                       for k in ("loss", "nll", "kl")}
    tree_got = got
    del got, want, noise

    # the network kernel on position (0, 0, 0)'s blocks, [A, n]
    placed = spmd.device_put(tree.posterior, param_shardings(tree.posterior, mesh3,
                                                             agent_leading=True))
    group = [0, mesh3.size // 2]  # (0, 0, 0) and (1, 0, 0)
    rows = [torch.cat([x.blocks[j].reshape(1, -1) for x in tree_leaves(field)], 1)
            for field in (placed.mean, placed.rho) for j in group]
    mean_blk, rho_blk = torch.cat(rows[:2]).contiguous(), torch.cat(rows[2:]).contiguous()
    del rows, placed
    network = functools.partial(kc.consensus_fused_network, W, mean_blk, rho_blk)
    plain = functools.partial(kc.consensus_network_plain, W, mean_blk, rho_blk)
    eq6_err = 0.0
    for g, w in zip(network(), plain()):
        err = (g - w).abs()
        if not bool(torch.all(err <= F32_TOL + F32_TOL * w.abs())):
            raise AssertionError(f"{tag} consensus at a position's block: max err "
                                 f"{float(err.max())}")
        eq6_err = max(eq6_err, float(err.max()))
    n = mean_blk.shape[1]
    nbytes, ops = 16 * a * n + 4 * a * a, 4 * a * a * n + 20 * a * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    network_row = {"name": "consensus_fused_network_spmd", "route": "cuda",
                   "source": SRC + "consensus_network.cu", "replaces": REF + "195",
                   "launches": tree_run["consensus_fused_network"], "max_abs_err": eq6_err,
                   "ms": cuda_ms(network), "plain_ms": event_ms(plain),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": None}
    del mean_blk, rho_blk, network, plain

    flat = steps.BayesTrainState(posterior=flat_view(tree.posterior),
                                 opt_state=dataclasses.replace(
                                     tree.opt_state, mu=flat_view(tree.opt_state.mu),
                                     nu=flat_view(tree.opt_state.nu)), step=tree.step)
    mesh1 = make_mesh((2, 1, 1), axes, dev)
    got, want, _, _, flat_run = spmd_train_pair("flat", cfg, flat, W, mesh1, batch, eps, **kw)
    fields = {"posterior.mean": (got.posterior.mean, want.posterior.mean),
              "posterior.rho": (got.posterior.rho, want.posterior.rho),
              "adam.mu.mean": (got.opt_state.mu.mean, want.opt_state.mu.mean),
              "adam.mu.rho": (got.opt_state.mu.rho, want.opt_state.mu.rho),
              "adam.nu.mean": (got.opt_state.nu.mean, want.opt_state.nu.mean),
              "adam.nu.rho": (got.opt_state.nu.rho, want.opt_state.nu.rho)}
    flat_run["bitwise"] = {k: torch.equal(x, y) for k, (x, y) in fields.items()}
    if not all(flat_run["bitwise"].values()):
        noise = adam_noise_lanes(got, want)
        flat_run["parity"] = train_parity(got, want, noise, 2 * TRAIN_LR)
        if flat_run["parity"]["failures"]:
            raise AssertionError(f"{tag} flat (2, 1, 1) vs unsharded: {flat_run}")
    flat_got = got
    del got, want, fields

    training_cards = None
    if n_cards >= 2:
        training_cards = {"cards": 2}
        for name, state, shape, e, virtual in (("pytree", tree, (2, 2, 2), layout.unflatten(eps),
                                                tree_got),
                                               ("flat", flat, (2, 1, 1), eps, flat_got)):
            real = make_mesh(shape, axes, pod_cards(shape))
            step = steps.make_train_round_step(cfg, W, **kw)
            out, _ = step(spmd.device_put(state, param_shardings(state, real, agent_leading=True)),
                          batch, eps=e)
            out = spmd.device_get(out, dev)
            training_cards[f"{name}_bitwise_virtual"] = all(
                torch.equal(x, y) for x, y in zip(tree_leaves(out), tree_leaves(virtual)))
            del out
        if not all(v for k, v in training_cards.items() if k != "cards"):
            raise AssertionError(f"{tag} training over real cards: {training_cards}")
    del tree, flat, tree_got, flat_got, eps, batch
    torch.cuda.empty_cache()
    phase(tag, nvidia_smi=smi, serving=serving,
          training={"model": cfg.name, "agents": a, "batch_per_agent": b, "seq": s,
                    "n_params_per_agent": p, "pytree": tree_run, "flat": flat_run,
                    "consensus_at_a_position": {"n": n, "ms": network_row["ms"],
                                                "plain_ms": network_row["plain_ms"],
                                                "bound_ms": network_row["bound_ms"],
                                                "max_abs_err": eq6_err},
                    "real_cards": training_cards or f"{n_cards} card(s)"},
          attention=attention)
    return [flash_row, network_row]


def placed_routes(calls, a, n_layers, n_pos, mm):
    """A placed step's routing records (``RoutingRecord.calls``: for each
    agent, layer and position of its pod in row-major (data, model) order,
    that block's ``[T/data, k]``) joined as the unsharded step's: for each
    layer ``[A, T, k]``, the ``model``-0 positions' blocks in data order
    (the other positions route the same tokens)."""
    import torch

    if len(calls) != a * n_layers * n_pos:
        raise AssertionError(f"{len(calls)} routing records, {a} x {n_layers} x {n_pos} "
                             "expected")
    per = [calls[(x * n_layers + layer) * n_pos:(x * n_layers + layer + 1) * n_pos]
           for x in range(a) for layer in range(n_layers)]
    return [torch.stack([torch.cat(per[x * n_layers + layer][::mm]) for x in range(a)])
            for layer in range(n_layers)]


def last_tokens(calls, b):
    """Routing records ``[A, B S, k]`` cut to each row's last token."""
    return [x.reshape(x.shape[0], b, -1, x.shape[-1])[:, :, -1] for x in calls]


def moe_drops(calls, cfg):
    """The assignments an unsharded step's dispatch drops: each agent's
    slots from its routing records (``[A, T, k]`` a layer) over
    ``models.moe._capacity`` of its T tokens."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import moe as moe_lib

    dropped = 0
    for idx in calls:
        a, t, k = idx.shape
        cap = moe_lib._capacity(t, cfg.n_experts, k, cfg.capacity_factor)
        flat = idx.reshape(a, t * k)
        running = torch.cumsum(F.one_hot(flat, cfg.n_experts), 1)
        slot = running.gather(2, flat[..., None])[..., 0] - 1
        dropped += int((slot >= cap).sum())
    return dropped


def run_lm_spmd_kinds(dev, smi):
    """Phase 3.lm_spmd_kinds: the ``moe``, ``local_attn`` and ``rglru``
    kinds and tied embeddings under data x model > 1 (``launch.spmd_steps``
    through ``launch.steps`` on placed inputs), on a (2, 2, 2) ``("pod",
    "data", "model")`` mesh of virtual shards of the card.

    (a) Serving at full width and depth: OLMoE-1B-7B and RecurrentGemma-9B,
    one at a time, with 3.lm_olmoe's and 3.lm_recurrentgemma's weights and
    prompts (A = 2 x B = 2, S = 4,096 Zipf tokens, bf16, LM_CAP slots): a
    prefill (first and warm) and SPMD_DECODE decode steps on the unsharded
    step's own inputs, each against the unsharded step of the same call on
    the same weights (``SPMD_KINDS_BF16``).  RecurrentGemma within
    WHOLE_BF16_ATOL / WHOLE_BF16_RMS; OLMoE within LM_BF16_*, at
    capacity factor E / k (nothing drops), on the (agent, row)
    pairs whose held token (the prompt's last, or the step's) took the same
    experts at every layer in both runs, counted, as 3.lm_olmoe holds its
    decode: a row-parallel bf16 sum can tip a near-tie among the router's
    bf16 logits to another expert, so a step may hold no row, and the check
    needs one held (step, agent, row) in the prefill and the steps (the
    rows routed alike over the whole prompt are counted too).  Control, on
    the held rows of every step: the agents swapped, which must fail.
    ``flash_attention`` once an attention layer a position in one prefill
    (16 x 8 = 128, 12 x 8 = 96), read after a counter reset; the gathered,
    all-reduced and all-gathered bytes of the prefill and of a decode step
    equal to ``forward_gather_bytes``' formula, each position's gathers
    under its bound; each position's placed bytes equal to
    ``sharding_report``'s; prefill and decode ms (CUDA events) beside the
    unsharded steps', and the peak memory.  Then ``flash_attention`` at a
    position's shape on the first attention layer's q/k/v of the embedded
    prompt at position (0, 0, 0): [1, 8, 4096, 128] causal (OLMoE), [1, 8,
    4096, 256] with window 2,048 and K/V from one head (RecurrentGemma),
    against its plain version, beside SDPA.

    (b) Drops: OLMoE and Phi-3.5-MoE at ``reduced()`` size, float32, A = 2
    x B = 4 rows of LM_REDUCED_S tokens, capacity factor
    SPMD_DROP_FACTOR (where the unsharded dispatch drops): a placed prefill
    and decode step within ZOO_F32_ATOL of the unsharded ones, and the
    placed steps' dropped assignments (``spmd_steps.moe_counts``) equal to
    the unsharded prefill's (from its routing, ``moe_drops``), which must
    be some.

    (c) Training: the pytree train round of reduced OLMoE (the router's aux
    in the loss) and RecurrentGemma (tied) on (2, 2, 2) at float32, against
    the card's unsharded round from the same ``eps``, within
    ``train_parity``; ``consensus_fused_network`` once a (data, model)
    position.

    (d) Real cards: where the host has two or more, (a)'s prefill and first
    decode step with each pod on a card of its own, bitwise the virtual
    run; else the reason it was skipped.

    Returns the kernel line's ``flash_attention_spmd_olmoe`` and
    ``flash_attention_spmd_recurrentgemma`` rows."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import make_lm_batch_sampler
    from repro_torch.kernels import dispatch
    from repro_torch.launch import spmd, spmd_steps, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import (
        NamedSharding,
        batch_pspec,
        cache_shardings,
        param_shardings,
        sharding_report,
    )
    from repro_torch.launch.spmd_steps import forward_gather_bytes
    from repro_torch.models import attention as att
    from repro_torch.models.modules import embed, rmsnorm
    from repro_torch.optim import adam
    from repro_torch.optim.schedules import exponential_decay

    tag = "3.lm_spmd_kinds"
    axes = ("pod", "data", "model")
    n_cards = torch.cuda.device_count()
    mesh = make_mesh((2, 2, 2), axes, dev)
    n_pos = mesh.size // mesh.shape["pod"]
    a, b, s, n_dec = LM_AGENTS, LM_BATCH, LM_S, SPMD_DECODE
    serving, rows = {}, []

    # (a) serving at full width and depth
    for arch in SPMD_KINDS:
        cfg = get_config(arch)
        is_moe = "moe" in cfg.pattern
        if is_moe:  # nothing drops: each row's logits hang on its own routing only
            cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        kinds = cfg.pattern * cfg.n_periods + cfg.tail
        n_moe = kinds.count("moe")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = lm_params(cfg, dev, a, torch.bfloat16)  # agent i from seed i
        toks = lm_tokens(cfg, s + 1 + LM_SHORT_DECODE, dev)  # run_lm_new's prompts
        prompt = {"tokens": toks[..., :s]}
        prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
        cache = steps.make_agent_cache(cfg, a, b, LM_CAP, device=dev)
        with RoutingRecord() as r_ref:
            (ref, cache), ref_ms = timed(lambda: prefill(params, prompt, cache))
        del cache
        cache = steps.make_agent_cache(cfg, a, b, LM_CAP, device=dev)
        (ref, cache), ref_warm_ms = timed(lambda: prefill(params, prompt, cache))
        with RoutingRecord() as r_ref_dec:
            ref_dec, inputs, ref_dec_ms, _, cache = lm_decode(decode, params,
                                                              toks[..., s:s + 1], s, n_dec,
                                                              cache)
        forced = torch.cat(inputs, dim=-1)  # each unsharded step's input token
        del cache

        placed = spmd.device_put(params, param_shardings(params, mesh, agent_leading=True))
        report = sharding_report(params, mesh, agent_leading=True)
        placed_bytes = [spmd.position_bytes(placed, i) for i in range(mesh.size)]
        if set(placed_bytes) != {report[2]}:
            raise AssertionError(f"{tag} {arch}: placed bytes a position {placed_bytes}, "
                                 f"sharding_report {report}")
        tokens = spmd.place(prompt["tokens"], NamedSharding(mesh, batch_pspec(mesh, (a, b, s))))

        def fresh():
            c = steps.make_agent_cache(cfg, a, b, LM_CAP, device=dev)
            return spmd.device_put(c, cache_shardings(c, mesh))

        cache = fresh()
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        spmd.reset_spmd_counts()
        with RoutingRecord() as r_got:
            (logits, cache), first_ms = timed(lambda: prefill(placed, {"tokens": tokens}, cache))
        torch.cuda.synchronize()
        counts, moved = dispatch.launch_counts(), spmd.spmd_counts()
        cache = fresh()  # a recurrent cache holds the state a prefill starts from
        (logits, cache), warm_ms = timed(lambda: prefill(placed, {"tokens": tokens}, cache))
        spmd.reset_spmd_counts()
        with RoutingRecord() as r_got_dec:
            dec, _, dec_ms, dec_wall, cache = lm_decode(decode, placed, toks[..., s:s + 1], s,
                                                        n_dec, cache, tokens=forced)
        dec_moved = spmd.spmd_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        expect = sum(kind != "rglru" for kind in kinds) * mesh.size
        if counts["flash_attention"] != expect:
            raise AssertionError(f"{tag} {arch}: flash_attention launched "
                                 f"{counts['flash_attention']} times in a sharded prefill, "
                                 f"expected {expect}")
        formula = forward_gather_bytes(cfg, mesh, b, s, 2, a)
        dec_formula = forward_gather_bytes(cfg, mesh, b, 1, 2, a)
        kinds_moved = ("gather", "all_reduce", "all_gather")
        traffic = {
            "prefill": {k: moved[f"{k}_bytes"] for k in kinds_moved},
            "prefill_formula": {k: formula[k] for k in kinds_moved},
            "decode_step": {k: dec_moved[f"{k}_bytes"] / n_dec for k in kinds_moved},
            "decode_step_formula": {k: dec_formula[k] for k in kinds_moved},
            "prefill_gather_by_position_max": max(moved["gather_by_position"].values()),
            "gather_per_position_bound": formula["gather_per_position_max"],
            "weight_bytes_an_agent": tree_bytes(params) // a}
        if (traffic["prefill"] != traffic["prefill_formula"]
                or traffic["decode_step"] != traffic["decode_step_formula"]
                or traffic["prefill_gather_by_position_max"]
                > formula["gather_per_position_max"]):
            raise AssertionError(f"{tag} {arch}: moved bytes against the formula: {traffic}")

        # the held rows: all of them, or for the MoE those routed alike up to the step
        agree_prefill = torch.ones((a, b), dtype=torch.bool)
        step_agree, prompt_alike = [agree_prefill] * n_dec, None
        if is_moe:  # the rows whose held token took the same experts at every layer
            joined = placed_routes(r_got.calls, a, n_moe, n_pos, 2)
            prompt_alike = int(rows_routed_alike(joined, r_ref.calls, b).sum())
            agree_prefill = rows_routed_alike(last_tokens(joined, b), last_tokens(r_ref.calls, b),
                                              b)
            mine, theirs = a * n_moe * n_pos, n_moe  # routing records a decode step
            step_agree = [rows_routed_alike(
                placed_routes(r_got_dec.calls[i * mine:(i + 1) * mine], a, n_moe, n_pos, 2),
                r_ref_dec.calls[i * theirs:(i + 1) * theirs], b) for i in range(n_dec)]
            del joined
        del r_ref, r_ref_dec, r_got, r_got_dec
        what = f"{tag} {arch} sharded vs unsharded"
        bounds = SPMD_KINDS_BF16[arch]
        pool, errs, held = [], [], []
        for name, (x, y, ok) in [("prefill", (logits, ref, agree_prefill))] + [
                (f"decode {i}", step) for i, step in enumerate(zip(dec, ref_dec, step_agree))]:
            held.append(int(ok.sum()))
            if not held[-1]:
                errs.append(None)
                continue
            got, want, _ = held_rows(f"{what} {name}", x, y, ok)
            errs.append(lm_check(f"{what} {name}", got, want, *bounds))
            pool.append((got, want, held_rows(f"{what} {name}", x.flip(0), y, ok)[0]))
        if not pool:
            raise AssertionError(f"{what}: no (step, agent, row) routed alike")
        got, want, wrong = (torch.cat(part) for part in zip(*pool))
        whole = lm_check(f"{what}, the held rows of every step", got, want, *bounds)
        ctrl = lm_control(f"{tag} {arch} the agents swapped (control)", wrong, want, *bounds)
        del pool
        prof = lm_profile(lambda: decode(placed, forced[..., -1:], s + n_dec, cache))
        del got, want, wrong, dec, ref_dec, logits, ref

        cards = None
        if n_cards >= 2:  # (d): each pod on a card of its own
            real = make_mesh((2, 2, 2), axes, [torch.device("cuda", p) for p in range(2)
                                                 for _ in range(n_pos)])
            r_params = spmd.device_put(params, param_shardings(params, real, agent_leading=True))
            r_cache = steps.make_agent_cache(cfg, a, b, LM_CAP, device=dev)
            r_cache = spmd.device_put(r_cache, cache_shardings(r_cache, real))
            r_logits, r_cache = prefill(r_params, prompt, r_cache)
            v_cache = fresh()
            v_logits, v_cache = prefill(placed, prompt, v_cache)
            r_dec, _ = decode(r_params, toks[..., s:s + 1], s, r_cache)
            v_dec, _ = decode(placed, toks[..., s:s + 1], s, v_cache)
            cards = {"cards": 2, "prefill_bitwise_virtual": torch.equal(r_logits, v_logits),
                     "decode_bitwise_virtual": torch.equal(r_dec, v_dec)}
            del r_params, r_cache, v_cache
            if not all(cards.values()):
                raise AssertionError(f"{tag} {arch} over real cards: {cards}")

        layers_read = None
        if not is_moe:  # the placed bf16 parting, layer by layer (read)
            x = lm_input(cfg, params, toks[..., :SPMD_LAYER_READ_S + 1], {})
            layers_read = placed_layers(f"{tag} {arch}", cfg, params, placed, mesh, x,
                                        SPMD_LAYER_READ_S, dev, held=False)
            del x
            torch.cuda.empty_cache()

        # flash_attention at a position's shape: the first attention layer's q/k/v
        kind = "moe" if is_moe else "local_attn"
        window = cfg.sliding_window if kind == "local_attn" else 0
        hl = cfg.n_heads // 2
        kvl = cfg.n_kv_heads // 2 if cfg.n_kv_heads % 2 == 0 else cfg.n_kv_heads
        layer = tree_map(lambda x: x[0, 0, 0], params["stacks"][kind])
        emb0 = {"emb": params["embed"]["emb"][0]}
        h = rmsnorm(layer["norm1"], embed(emb0, toks[0, :1, :s], torch.bfloat16), cfg.norm_eps)
        q, k, v = att.attention_qkv(layer["attn"], h, cfg, torch.arange(s, device=dev))
        q = q[None, ..., :hl, :].contiguous()
        k, v = (att._repeat_kv(t[None, ..., :kvl, :], hl).contiguous() for t in (k, v))
        del params, placed, cache, h, layer, emb0
        torch.cuda.empty_cache()
        attention, row = attention_kernel_row(f"{tag} {arch}", "flash_attention_spmd_"
                                              + arch.split("-")[0], cfg, q, k, v, window,
                                              counts["flash_attention"])
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
        serving[arch] = {
            "mesh": mesh.shape, "agents": a, "batch_per_agent": b, "prompt": s,
            "capacity": LM_CAP, "capacity_factor": cfg.capacity_factor if is_moe else None,
            "prefill_first_ms": first_ms, "prefill_warm_ms": warm_ms,
            "unsharded_prefill_ms": ref_ms, "unsharded_prefill_warm_ms": ref_warm_ms,
            "decode_ms_median": statistics.median(dec_ms),
            "unsharded_decode_ms_median": statistics.median(ref_dec_ms),
            "decode_wall_s": dec_wall, "decode_steps": n_dec,
            "rows": a * b, "rows_held_prefill": held[0], "rows_held_decode": held[1:],
            "rows_routed_alike_whole_prompt": prompt_alike,
            "prefill_max_abs_err_rel_rms": errs[0], "decode_max_abs_err_rel_rms": errs[1:],
            "held_rows_max_abs_err_rel_rms": whole, "agents_swapped_control": ctrl,
            "atol": bounds[0], "rms_tol": bounds[1],
            "flash_attention_a_prefill": counts["flash_attention"],
            "flash_attention_expected": expect, "traffic": traffic,
            "placed_bytes_a_position": placed_bytes[0],
            "sharding_report_per_device": report[2], "max_memory_allocated": peak,
            "decode_profile": prof, "attention": attention, "layers_read": layers_read,
            "real_cards": cards or f"{n_cards} card(s)"}

    # (b) drops: reduced MoE configs at float32, a capacity factor that drops
    drops = {}
    for arch in SPMD_DROP_CONFIGS:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                  capacity_factor=SPMD_DROP_FACTOR)
        n_moe = cfg.n_layers
        params = lm_params(cfg, dev, a, torch.float32)
        toks = lm_tokens(cfg, LM_REDUCED_S + 1, dev, b=SPMD_DROP_BATCH)
        prompt = {"tokens": toks[..., :LM_REDUCED_S]}
        cap = LM_REDUCED_S + 8
        prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
        cache = steps.make_agent_cache(cfg, a, SPMD_DROP_BATCH, cap, torch.float32, device=dev)
        with RoutingRecord() as r_ref:
            ref, cache = prefill(params, prompt, cache)
        ref_dec, _ = decode(params, toks[..., -1:], LM_REDUCED_S, cache)
        want_drops = moe_drops(r_ref.calls, cfg)
        placed = spmd.device_put(params, param_shardings(params, mesh, agent_leading=True))
        cache = steps.make_agent_cache(cfg, a, SPMD_DROP_BATCH, cap, torch.float32, device=dev)
        cache = spmd.device_put(cache, cache_shardings(cache, mesh))
        spmd_steps.reset_moe_counts()
        with RoutingRecord() as r_got:
            got, cache = prefill(placed, prompt, cache)
        got_counts = spmd_steps.moe_counts()
        got_dec, _ = decode(placed, toks[..., -1:], LM_REDUCED_S, cache)
        routed_alike = bool(rows_routed_alike(placed_routes(r_got.calls, a, n_moe, n_pos, 2),
                                              r_ref.calls, SPMD_DROP_BATCH).all())
        err = [float((x - y).abs().max()) for x, y in ((got, ref), (got_dec, ref_dec))]
        drops[arch] = {"capacity_factor": SPMD_DROP_FACTOR, "batch_per_agent": SPMD_DROP_BATCH,
                       "prompt": LM_REDUCED_S, "unsharded_dropped": want_drops,
                       "placed": got_counts, "routed_alike": routed_alike,
                       "prefill_max_abs_err": err[0], "decode_max_abs_err": err[1],
                       "atol": ZOO_F32_ATOL}
        if (want_drops == 0 or got_counts["dropped"] != want_drops or not routed_alike
                or max(err) > ZOO_F32_ATOL):
            raise AssertionError(f"{tag} drops, {arch}: {drops[arch]}")
        del params, placed, cache

    # (c) training: the pytree round of reduced OLMoE and RecurrentGemma, float32
    training = {}
    opt = adam()
    kw = dict(opt=opt, lr_schedule=exponential_decay(TRAIN_LR, TRAIN_LR_DECAY ** (1.0 / TRAIN_U)),
              kl_scale=TRAIN_KL, remat=False)
    W = torch.as_tensor(LM_ZOO_W, dtype=torch.float32, device=dev)
    for arch in SPMD_KINDS:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        tree = steps.init_train_state(cfg, a, opt, torch.Generator(device=dev).manual_seed(0),
                                      device=dev, flat=False)
        layout = flat_view(tree.posterior).layout
        gen = torch.Generator(device=dev).manual_seed(1)
        moved_by = 1e-2 * torch.randn(layout.n_params, generator=gen, device=dev)
        for leaf, m in zip(tree_leaves(tree.posterior.mean),
                           tree_leaves(layout.unflatten(moved_by))):
            leaf[1] += m
        batch = make_lm_batch_sampler(cfg.vocab_size, TRAIN_BATCH, TRAIN_S, n_agents=a,
                                      device=dev)(gen, 0)
        eps = layout.unflatten(torch.randn((a, layout.n_params), generator=gen, device=dev))
        got, want, got_m, want_m, run = spmd_train_pair(f"{arch} pytree", cfg, tree, W, mesh,
                                                        batch, eps, tag=tag, **kw)
        noise = adam_noise_lanes(flat_state(got), flat_state(want))
        run["parity"] = train_parity(flat_state(got), flat_state(want), noise, 2 * TRAIN_LR)
        run["metrics_max_abs_err"] = {k: float((got_m[k] - want_m[k]).abs().max())
                                      for k in ("loss", "nll", "kl")}
        if run["parity"]["failures"]:
            raise AssertionError(f"{tag} training, {arch} (2, 2, 2) vs unsharded: {run}")
        training[arch] = run
        del tree, got, want, noise, batch, eps
    torch.cuda.empty_cache()
    phase(tag, nvidia_smi=smi, serving=serving, drops=drops,
          training={"batch_per_agent": TRAIN_BATCH, "seq": TRAIN_S, **training},
          real_cards=None if n_cards >= 2 else f"skipped: {n_cards} card(s), two needed")
    return rows


def placed_layers(tag, cfg, params, placed, mesh, x, s, dev, held):
    """Every layer of ``cfg`` placed on ``mesh`` (``spmd_steps.apply_layer``,
    the data x model schedule's own layer step) against the unsharded block
    (``block_apply``) on the same bf16 input: a teacher-forced stream from
    ``x [A, B, S + 1, D]`` (``lm_input``), each layer's input the unsharded
    output of the layer before, so no layer's parting reaches the next.  At
    each layer, on both sides: the prefill of positions 0..S-1 into the
    layer's cache (placed by ``cache_shardings``), then the decode of
    position S from it; each on the block's contribution (its output less
    its input, in fp32).  ``held``: within ``LAYER_BF16_*``, and the
    control, the placed outputs with the agents swapped, must fail them at
    every layer; else read.  Returns the worst readings and each layer's
    (layer, kind, prefill, decode)."""
    import torch

    from repro_torch.launch import spmd, steps
    from repro_torch.launch.sharding import cache_shardings
    from repro_torch.launch.spmd_steps import apply_layer
    from repro_torch.models import transformer as tr

    a, b = x.shape[:2]
    pos = torch.arange(s + 1, device=dev)
    cache = steps.make_agent_cache(cfg, a, b, s + 2, device=dev)
    cache = spmd.device_put(cache, cache_shardings(cache, mesh))

    def placed_block(layer, rows, positions):  # [A, B, T, D] through the placed layer
        return apply_layer(cfg, placed, cache, layer, rows, positions)

    def contribution(y, x_in):
        return y.float() - x_in.float()

    worst = {"prefill": (0.0, 0.0), "decode": (0.0, 0.0)}
    per_layer, controls = [], {}
    for layer, kind, lp in model_layers(cfg, params):
        c_u = tr.block_cache_init(kind, cfg, b, s + 2, torch.bfloat16, dev, lead=(a,))
        want_p = tr.block_apply(kind, lp, x[..., :s, :], cfg, positions=pos[:s], cache=c_u)[0]
        want_d = tr.block_apply(kind, lp, x[..., s:, :], cfg, positions=pos[s:], cache=c_u)[0]
        got_p = placed_block(layer, x[..., :s, :], pos[:s])
        got_d = placed_block(layer, x[..., s:, :], pos[s:])
        reading = [layer, kind]
        for name, got, want, x_in in (("prefill", got_p, want_p, x[..., :s, :]),
                                      ("decode", got_d, want_d, x[..., s:, :])):
            what = f"{tag} layer {layer} ({kind}) {name}, placed vs unsharded"
            g, w = contribution(got, x_in), contribution(want, x_in)
            err = (lm_check(what, g, w, LAYER_BF16_ATOL, LAYER_BF16_RMS) if held
                   else lm_diff(what, g, w))
            wrong = contribution(got.flip(0), x_in)
            ctrl_what = f"{tag} layer {layer} ({kind}) {name}, the agents swapped (control)"
            ctrl = (lm_control(ctrl_what, wrong, w, LAYER_BF16_ATOL, LAYER_BF16_RMS) if held
                    else lm_diff(ctrl_what, wrong, w))
            controls[name] = min(controls.get(name, ctrl), ctrl, key=lambda c: c[1])
            worst[name] = tuple(map(max, worst[name], err))
            reading.append(err)
        per_layer.append(reading)
        x = torch.cat([want_p, want_d], dim=-2)
        del c_u, want_p, want_d, got_p, got_d
    del cache
    largest = sorted(per_layer, key=lambda r: -r[2][1])[:6]
    return {"layers": len(per_layer), "prompt": s, "held": held,
            "bounds": (LAYER_BF16_ATOL, LAYER_BF16_RMS),
            "worst_max_abs_err_rel_rms": worst, "controls_weakest": controls,
            "largest_prefill_rel_rms": largest, "per_layer": per_layer}


def run_lm_spmd_xlstm_whisper(dev, smi):
    """Phase 3.lm_spmd_xlstm_whisper: the ``mlstm`` / ``slstm`` and
    ``enc_attn`` / ``dec_attn`` kinds under data x model > 1
    (``launch.spmd_steps`` through ``launch.steps`` on placed inputs), on a
    (2, 2, 2) ``("pod", "data", "model")`` mesh of virtual shards of the
    card.

    (a) xLSTM-1.3B at full width and depth (48 blocks, d_model 2,048), with
    3.lm_xlstm's weights (agent i from seed i), A = 2 x B = 2 Zipf prompts
    of SPMD_XLSTM_S tokens, bf16: a prefill (first and warm, each into a
    fresh cache) and SPMD_NEW_DECODE decode steps on the unsharded steps' own
    inputs, beside the unsharded steps of the same call.  The cache is
    placed with a block of its own on every position, and each position's
    copy of the mLSTM's ``m`` (computed on every model position) must be
    bitwise equal over ``model`` after the steps.  The whole model's
    logits are read beside LM_BF16_* (at random init one bf16 rounding
    taken the other way grows through 48 layers: 3.lm_xlstm); every block
    is held by ``placed_layers`` within LAYER_BF16_* (prefill and decode,
    the placed block against the unsharded one on the same input), the
    agents swapped the control.  The moved bytes of the prefill and of a
    decode step equal to ``forward_gather_bytes``, each position's gathers
    under its bound; each position's placed bytes equal to
    ``sharding_report``'s; ms (CUDA events) beside the unsharded steps';
    peak memory.

    (b) Whisper-tiny at full width and depth, 3.lm_whisper's weights,
    clips and prompts (A = 2 x WHISPER_BATCH clips of 1,500 frames,
    WHISPER_TEXT-token prompts, WHISPER_CAP slots), bf16: a prefill and
    SPMD_NEW_DECODE decode steps, each re-running the placed encoder over the
    frames, within LM_BF16_* of the unsharded steps (control: the agents
    swapped); ``flash_attention`` (4 + 4 + 4) x 8 = 96 times a prefill; the
    bytes (the encoder's frames counted), placed bytes, ms and peak memory
    as (a).  Then ``flash_attention`` at a position's shapes: the encoder's
    layer 0 [4, 3, 1500, 64] non-causal, and the first cross-attention [4,
    3, 224, 64] over 1,500 keys, on position (0, 0, 0)'s rows and heads,
    against the plain version, beside SDPA; each row's launches are the
    placed prefill's recorded ``ops.attention`` calls of its shape, and
    with the causal self-attention's they must add up to its launches.

    (c) Training at f32 (TF32 off): the pytree round of reduced xLSTM
    (TRAIN_BATCH x TRAIN_S tokens: its mLSTM chunk is 256 steps) and of
    Whisper-tiny at full width (WHISPER_BATCH clips of 1,500 frames and
    WHISPER_TEXT tokens an agent) on (2, 2, 2), with LM_ZOO_W and agent 1's
    mean moved by a seeded draw, each against the card's unsharded round
    from the same ``eps`` within ``train_parity`` (which fails a lane that
    is not finite); ``consensus_fused_network`` once a (data, model)
    position; step ms, bytes and peak memory, no profile.

    (d) Real cards: where the host has two or more, (a)'s and (b)'s
    prefill and first decode step with each pod on a card of its own,
    bitwise the virtual run; else the reason it was skipped.

    Returns the kernel line's ``flash_attention_spmd_whisper_enc`` and
    ``flash_attention_spmd_whisper_cross`` rows."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import make_lm_batch_sampler
    from repro_torch.kernels import dispatch, ops
    from repro_torch.launch import spmd, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import (
        NamedSharding,
        batch_pspec,
        cache_shardings,
        param_shardings,
        sharding_report,
    )
    from repro_torch.launch.spmd_steps import forward_gather_bytes
    from repro_torch.models import attention as att
    from repro_torch.models import transformer as tr
    from repro_torch.models.modules import embed, rmsnorm
    from repro_torch.optim import adam
    from repro_torch.optim.schedules import exponential_decay

    tag = "3.lm_spmd_xlstm_whisper"
    axes = ("pod", "data", "model")
    n_cards = torch.cuda.device_count()
    mesh = make_mesh((2, 2, 2), axes, dev)
    coords = spmd.position_coords(mesh)
    a, n_dec = LM_AGENTS, SPMD_NEW_DECODE
    serving, rows, cards = {}, [], {}

    def place(x):
        return spmd.place(x, NamedSharding(mesh, batch_pspec(mesh, tuple(x.shape))))

    def own_blocks(tree):  # a block of its own on every position (no shared views)
        return tree_map(lambda x: spmd.Placed(x.sharding, [blk.clone() for blk in x.blocks],
                                              x.shape, x.dtype), tree)

    for arch, b, n_text, cap in (("xlstm-1.3b", LM_BATCH, SPMD_XLSTM_S, SPMD_XLSTM_S + 32),
                                 ("whisper-tiny", WHISPER_BATCH, WHISPER_TEXT, WHISPER_CAP)):
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        allocated_at_start = torch.cuda.memory_allocated(dev)
        params = lm_params(cfg, dev, a, torch.bfloat16)  # agent i from seed i
        toks = lm_tokens(cfg, n_text + 1 + n_dec, dev, b=b)
        front = lm_front(cfg, b, dev)  # Whisper's frames; {} for the xLSTM
        frames = front.get("frames")
        prompt = {"tokens": toks[..., :n_text], **front}
        prefill = steps.make_prefill_step(cfg)
        decode = functools.partial(steps.make_decode_step(cfg), frames=frames)

        def fresh_ref():
            return steps.make_agent_cache(cfg, a, b, cap, device=dev)

        cache = fresh_ref()
        (ref, cache), ref_ms = timed(lambda: prefill(params, prompt, cache))
        cache = fresh_ref()  # a recurrent cache holds the state a prefill starts from
        (ref, cache), ref_warm_ms = timed(lambda: prefill(params, prompt, cache))
        ref_dec, inputs, ref_dec_ms, _, cache = lm_decode(decode, params,
                                                          toks[..., n_text:n_text + 1], n_text,
                                                          n_dec, cache)
        forced = torch.cat(inputs, dim=-1)  # each unsharded step's input token
        del cache

        placed = spmd.device_put(params, param_shardings(params, mesh, agent_leading=True))
        report = sharding_report(params, mesh, agent_leading=True)
        placed_bytes = [spmd.position_bytes(placed, i) for i in range(mesh.size)]
        if set(placed_bytes) != {report[2]}:
            raise AssertionError(f"{tag} {arch}: placed bytes a position {placed_bytes}, "
                                 f"sharding_report {report}")
        p_prompt = {k: place(v) for k, v in prompt.items()}
        p_frames = p_prompt.get("frames")
        p_decode = functools.partial(steps.make_decode_step(cfg), frames=p_frames)

        def fresh():
            c = steps.make_agent_cache(cfg, a, b, cap, device=dev)
            return own_blocks(spmd.device_put(c, cache_shardings(c, mesh)))

        cache = fresh()
        calls = []  # (causal, q shape, k shape) of each ops.attention call in the prefill
        attention_op = ops.attention

        def recorded(q, k, v, **kw):
            calls.append((kw.get("causal", True), tuple(q.shape), tuple(k.shape)))
            return attention_op(q, k, v, **kw)

        torch.cuda.synchronize()
        ops.attention = recorded
        dispatch.reset_launch_counts()
        spmd.reset_spmd_counts()
        try:
            (logits, cache), first_ms = timed(lambda: prefill(placed, p_prompt, cache))
            torch.cuda.synchronize()
            counts, moved = dispatch.launch_counts(), spmd.spmd_counts()
        finally:
            ops.attention = attention_op
        cache = fresh()
        (logits, cache), warm_ms = timed(lambda: prefill(placed, p_prompt, cache))
        spmd.reset_spmd_counts()
        dec, _, dec_ms, dec_wall, cache = lm_decode(p_decode, placed,
                                                    toks[..., n_text:n_text + 1], n_text, n_dec,
                                                    cache, tokens=forced)
        dec_moved = spmd.spmd_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        kinds = cfg.pattern * cfg.n_periods + cfg.tail
        expect = (cfg.encoder_layers + 2 * kinds.count("dec_attn")) * mesh.size
        if counts["flash_attention"] != expect or len(calls) != expect:
            raise AssertionError(f"{tag} {arch}: flash_attention launched "
                                 f"{counts['flash_attention']} times in a placed prefill "
                                 f"({len(calls)} calls), expected {expect}")
        n_f = cfg.encoder_seq if cfg.is_encdec else 0
        formula = forward_gather_bytes(cfg, mesh, b, n_text, 2, a, frames=n_f)
        dec_formula = forward_gather_bytes(cfg, mesh, b, 1, 2, a, frames=n_f)
        kinds_moved = ("gather", "all_reduce", "all_gather")
        traffic = {
            "prefill": {k: moved[f"{k}_bytes"] for k in kinds_moved},
            "prefill_formula": {k: formula[k] for k in kinds_moved},
            "decode_step": {k: dec_moved[f"{k}_bytes"] / n_dec for k in kinds_moved},
            "decode_step_formula": {k: dec_formula[k] for k in kinds_moved},
            "prefill_gather_by_position_max": max(moved["gather_by_position"].values()),
            "gather_per_position_bound": formula["gather_per_position_max"],
            "weight_bytes_an_agent": tree_bytes(params) // a}
        if (traffic["prefill"] != traffic["prefill_formula"]
                or traffic["decode_step"] != traffic["decode_step_formula"]
                or traffic["prefill_gather_by_position_max"]
                > formula["gather_per_position_max"]):
            raise AssertionError(f"{tag} {arch}: moved bytes against the formula: {traffic}")

        what = f"{tag} {arch} placed vs unsharded"
        pairs = [("prefill", logits, ref)] + [(f"decode {i}", x, y)
                                              for i, (x, y) in enumerate(zip(dec, ref_dec))]
        reading = {"mesh": mesh.shape, "agents": a, "batch_per_agent": b, "prompt": n_text,
                   "capacity": cap, "prefill_first_ms": first_ms, "prefill_warm_ms": warm_ms,
                   "unsharded_prefill_ms": ref_ms, "unsharded_prefill_warm_ms": ref_warm_ms,
                   "decode_ms_median": statistics.median(dec_ms),
                   "unsharded_decode_ms_median": statistics.median(ref_dec_ms),
                   "decode_wall_s": dec_wall, "decode_steps": n_dec,
                   "bounds": (LM_BF16_ATOL, LM_BF16_RMS),
                   "flash_attention_a_prefill": counts["flash_attention"],
                   "flash_attention_expected": expect, "traffic": traffic,
                   "placed_bytes_a_position": placed_bytes[0],
                   "sharding_report_per_device": report[2], "max_memory_allocated": peak,
                   "memory_allocated_at_start": allocated_at_start}
        if cfg.is_encdec:  # held
            reading["max_abs_err_rel_rms"] = [lm_check(f"{what} {name}", x, y, LM_BF16_ATOL,
                                                       LM_BF16_RMS) for name, x, y in pairs]
            reading["agents_swapped_control"] = [
                lm_control(f"{tag} {arch} {name}, the agents swapped (control)", x.flip(0), y,
                           LM_BF16_ATOL, LM_BF16_RMS) for name, x, y in pairs]
        else:  # read: 48 layers carry one rounding taken the other way to O(1)
            reading["max_abs_err_rel_rms_read"] = [lm_diff(f"{what} {name}", x, y)
                                                   for name, x, y in pairs]
            reading["agents_swapped_read"] = [lm_diff(f"{what} {name} swapped", x.flip(0), y)
                                              for name, x, y in pairs]
            m_leaf = cache["stacks"]["mlstm"]["m"]
            same = all(torch.equal(m_leaf.blocks[i], m_leaf.blocks[coords.index(c[:2] + (0,))])
                       for i, c in enumerate(coords))
            if not same or m_leaf.blocks[0].data_ptr() == m_leaf.blocks[1].data_ptr():
                raise AssertionError(f"{tag} {arch}: the mLSTM's m copies differ over model")
            reading["mlstm_m_bitwise_over_model"] = same
        del logits, ref, dec, ref_dec, cache

        if n_cards >= 2:  # (d): each pod on a card of its own
            n_pos = mesh.size // mesh.shape["pod"]
            real = make_mesh((2, 2, 2), axes, [torch.device("cuda", p) for p in range(2)
                                                 for _ in range(n_pos)])
            r_params = spmd.device_put(params, param_shardings(params, real, agent_leading=True))
            r_cache = steps.make_agent_cache(cfg, a, b, cap, device=dev)
            r_cache = spmd.device_put(r_cache, cache_shardings(r_cache, real))
            r_logits, r_cache = prefill(r_params, prompt, r_cache)
            v_logits, v_cache = prefill(placed, prompt, fresh())
            tok0 = toks[..., n_text:n_text + 1]
            r_dec, _ = steps.make_decode_step(cfg)(r_params, tok0, n_text, r_cache, frames)
            v_dec, _ = steps.make_decode_step(cfg)(placed, tok0, n_text, v_cache, frames)
            cards[arch] = {"cards": 2, "prefill_bitwise_virtual": torch.equal(r_logits,
                                                                              v_logits),
                           "decode_bitwise_virtual": torch.equal(r_dec, v_dec)}
            del r_params, r_cache, v_cache
            if not all(cards[arch].values()):
                raise AssertionError(f"{tag} {arch} over real cards: {cards[arch]}")

        x = lm_input(cfg, params, toks[..., :n_text + 1], front)
        if not cfg.is_encdec:  # every block held, prefill and decode
            reading["layers"] = placed_layers(tag, cfg, params, placed, mesh, x, n_text, dev,
                                              held=True)
        else:  # flash_attention at a position's shapes: position (0, 0, 0)'s rows and heads
            rb, hl = b // 2, cfg.n_heads // 2
            p0 = tree_map(lambda t: t[0], params)
            fr = frames[0, :rb]
            enc0 = tree_map(lambda t: t[0, 0], p0["enc_stack"])
            fpos = torch.arange(fr.shape[-2], device=dev)
            he = rmsnorm(enc0["norm1"], fr.to(torch.bfloat16) + tr._sinusoidal(
                fpos, cfg.d_model).to(torch.bfloat16), cfg.norm_eps)
            qkv = {"enc": att.attention_qkv(enc0["attn"], he, cfg, None, use_rope=False)}
            enc_out = tr.encode(p0, cfg, fr)
            dec0 = tree_map(lambda t: t[0, 0], p0["stacks"]["dec_attn"])
            pos = torch.arange(n_text, device=dev)
            xt = x[0, :rb, :n_text]
            h = rmsnorm(dec0["norm1"], xt, cfg.norm_eps)
            x1 = xt + att.attention_block(dec0["attn"], h, cfg, positions=pos, use_rope=False)[0]
            hx = rmsnorm(dec0["norm_x"], x1, cfg.norm_eps)
            qkv["cross"] = att.attention_qkv(dec0["xattn"], hx, cfg, pos, cross_x=enc_out,
                                             use_rope=False)
            del p0, fr, enc0, he, enc_out, dec0, xt, h, x1, hx
            reading["attention"] = {}
            # each row's launches: the placed prefill's recorded calls of its shape
            shapes = {"self": (True, (rb, hl, n_text, cfg.hd), (rb, hl, n_text, cfg.hd))}
            for name, (q, k, v) in qkv.items():
                q, k, v = (t[None, ..., :hl, :].contiguous() for t in (q, k, v))
                shapes[name] = (False, (rb, hl, q.shape[2], cfg.hd),
                                (rb, hl, k.shape[2], cfg.hd))
                launches = sum(c == shapes[name] for c in calls)
                reading["attention"][name], row = attention_kernel_row(
                    f"{tag} {name}", f"flash_attention_spmd_whisper_{name}", cfg, q, k, v, 0,
                    launches, causal=False)
                rows.append(row)
            split = {name: sum(c == shape for c in calls) for name, shape in shapes.items()}
            reading["flash_attention_split"] = split
            if sum(split.values()) != counts["flash_attention"] or 0 in split.values():
                raise AssertionError(f"{tag} {arch}: the placed prefill's {len(calls)} "
                                     f"attention calls split as {split}, not into its "
                                     f"{counts['flash_attention']} launches")
            del qkv, q, k, v
        serving[arch] = reading
        del params, placed, x, toks, front, frames, prompt, p_prompt, p_frames
        torch.cuda.empty_cache()

    # (c) training, float32: the pytree round of reduced xLSTM and of Whisper-tiny
    training = {}
    opt = adam()
    kw = dict(opt=opt, lr_schedule=exponential_decay(TRAIN_LR, TRAIN_LR_DECAY ** (1.0 / TRAIN_U)),
              kl_scale=TRAIN_KL, remat=False)
    W = torch.as_tensor(LM_ZOO_W, dtype=torch.float32, device=dev)
    for arch in ("xlstm-1.3b", "whisper-tiny"):
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        if not cfg.is_encdec:
            cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
        b, s = (WHISPER_BATCH, WHISPER_TEXT) if cfg.is_encdec else (TRAIN_BATCH, TRAIN_S)
        tree = steps.init_train_state(cfg, a, opt, torch.Generator(device=dev).manual_seed(0),
                                      device=dev, flat=False)
        layout = flat_view(tree.posterior).layout
        gen = torch.Generator(device=dev).manual_seed(1)
        moved_by = 1e-2 * torch.randn(layout.n_params, generator=gen, device=dev)
        for leaf, m in zip(tree_leaves(tree.posterior.mean),
                           tree_leaves(layout.unflatten(moved_by))):
            leaf[1] += m
        del moved_by
        batch = {**make_lm_batch_sampler(cfg.vocab_size, b, s, n_agents=a, device=dev)(gen, 0),
                 **lm_front(cfg, b, dev, seed=100)}
        eps = layout.unflatten(torch.randn((a, layout.n_params), generator=gen, device=dev))
        # no profile: on the H100 one of a placed xLSTM step (207,865 kernels)
        # takes the profiler 123 s, one of Whisper's 45 s
        got, want, got_m, want_m, run = spmd_train_pair(f"{arch} pytree", cfg, tree, W, mesh,
                                                        batch, eps, tag=tag, profile=False,
                                                        **kw)
        noise = adam_noise_lanes(flat_state(got), flat_state(want))
        run["parity"] = train_parity(flat_state(got), flat_state(want), noise, 2 * TRAIN_LR)
        run["metrics_max_abs_err"] = {k: float((got_m[k] - want_m[k]).abs().max())
                                      for k in ("loss", "nll", "kl")}
        run.update(model=cfg.name, batch_per_agent=b, seq=s, n_params_per_agent=layout.n_params)
        if run["parity"]["failures"]:
            raise AssertionError(f"{tag} training, {arch} (2, 2, 2) vs unsharded: {run}")
        training[arch] = run
        del tree, got, want, noise, batch, eps
        torch.cuda.empty_cache()
    phase(tag, nvidia_smi=smi, serving=serving, training=training,
          real_cards=cards or f"skipped: {n_cards} card(s), two needed")
    return rows


def wire_lanes(tag, got, want):
    """Two priors at the bf16 wire (``[A, P]`` mean and rho pairs): the
    lanes where they part by more than F32_TOL (a statistic at a wire
    rounding boundary, rounded apart), each held within one bf16 place of
    the value plus 1, at most SPMD_FLIP_SHARE of the lanes.  Returns (the
    lanes, as one ``[A, P]`` bool, their count, the largest parting)."""
    import torch

    lanes, worst = None, 0.0
    for g, w in zip(got, want):
        err = (g - w).abs()
        far = err > F32_TOL + F32_TOL * w.abs()
        if not bool(torch.all(err <= F32_TOL + BF16_PLACE * (w.abs() + 1.0))):
            raise AssertionError(f"{tag}: a prior lane beyond one bf16 place")
        worst = max(worst, float(err.max()))
        lanes = far if lanes is None else lanes | far
    count = int(lanes.sum())
    if count > SPMD_FLIP_SHARE * lanes.numel():
        raise AssertionError(f"{tag}: {count} wire-boundary lanes of {lanes.numel()}")
    return lanes, count, worst


def run_lm_spmd_consensus(dev, smi):
    """Phase 3.lm_spmd_consensus: the placed train round's other routes
    (``launch.spmd_steps.train_round``): a flat state under data x model,
    the ppermute consensus and the bf16 wire.  repro-100m at full width
    (P = 163,597,056 an agent), float32 compute, 3.lm_spmd's A = 2, batch,
    Adam, lr and kl_scale, W = SPMD_WIRE_W, agent 1's mean moved by one
    seeded draw, on (2, 2, 2) virtual positions of the card.  Cases, each
    one placed round step against the unsharded round step of the same
    route from one ``eps`` (``spmd_train_pair``, no profile), within
    ``train_parity``: the flat state at the f32 einsum, at the bf16 einsum
    and at ppermute (bf16, its default); the pytree state at the bf16
    einsum and at ppermute.  At the bf16 einsum the priors' wire-boundary
    lanes (``wire_lanes``: the network kernel's, handed W rounded through
    the wire, against ``consensus_einsum(_flat)``'s) are held within one
    bf16 place and exempted from PARITY_ATOL in the round; the ppermute
    prior (``spmd_steps.pod_ppermute``) is bitwise the unplaced ring's
    (``consensus_ppermute_ring_flat`` / ``consensus_ppermute_pod``); every
    position of a pod holds the flat rows bitwise alike.  Bytes, each
    case's equal to formulas: the local step's gathers
    (``forward_gather_bytes``), all-reduces (the forward's, a replicated
    leaf's gradient over each axis it is replicated on, the NLL's sum over
    data) and all-gathers (the logits' column blocks over model), the
    einsum's gathers (the cost model's f32 exchange a (data, model)
    position; its bf16 wire bytes beside), the flat rows' re-join (six
    times ``rejoin_bytes``), the rotations (the cost model's bf16 wire
    bytes, both ring directions for the flat state).  Returns the kernel line's
    ``consensus_fused_network_spmd_wire`` row: the network kernel at
    position (0, 0, 0)'s block, the bf16 wire, W rounded through it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.posterior import GaussianPosterior
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import make_lm_batch_sampler
    from repro_torch.kernels import consensus as kc
    from repro_torch.launch import consensus_opt as co
    from repro_torch.launch import spmd, spmd_steps, steps
    from repro_torch.launch.costmodel import consensus_roofline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.optim import adam
    from repro_torch.optim.schedules import exponential_decay

    tag = "3.lm_spmd_consensus"
    bf16 = torch.bfloat16
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    a, b, s = TRAIN_AGENTS, TRAIN_BATCH, TRAIN_S
    torch.cuda.empty_cache()
    opt = adam()
    kw = dict(opt=opt, lr_schedule=exponential_decay(TRAIN_LR, TRAIN_LR_DECAY ** (1.0 / TRAIN_U)),
              kl_scale=TRAIN_KL, remat=False)
    W = torch.as_tensor(SPMD_WIRE_W, dtype=torch.float32, device=dev)
    w_wire = W.to(bf16).float()
    flat = steps.init_train_state(cfg, a, opt, torch.Generator(device=dev).manual_seed(0),
                                  device=dev)
    layout, p = flat.posterior.layout, flat.posterior.layout.n_params
    gen = torch.Generator(device=dev).manual_seed(1)
    flat.posterior.mean[1] += 1e-2 * torch.randn(p, generator=gen, device=dev)
    batch = make_lm_batch_sampler(cfg.vocab_size, b, s, n_agents=a, device=dev)(gen, 0)
    eps = torch.randn((a, p), generator=gen, device=dev)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), dev)
    k = mesh.size // mesh.shape["pod"]

    def rows_alike(state):  # every position of a pod holds its rows bitwise alike
        pods = [pos["pod"] for pos in mesh.positions()]
        same = True
        for buf in tree_leaves(state.posterior) + tree_leaves(state.opt_state):
            first = {}
            same &= all(torch.equal(first.setdefault(pod, blk), blk)
                        for pod, blk in zip(pods, buf.blocks))
        return {"rows_bitwise_alike": same}

    def block_sizes(post):  # n of each (data, model) position's [A, n] eq. (6) block
        return [sum(x.blocks[i][0].numel() for x in tree_leaves(post.mean)) for i in range(k)]

    def roofline_bytes(sizes, wire):
        return sum(consensus_roofline(a, n, len(layout.specs), wire_dtype=wire)["wire"]
                   ["collective_bytes"] for n in sizes)

    # a round's traffic as formulas: the local step's (the forward's gathers and
    # all-reduces, a replicated leaf's gradient all-reduced over each axis it is
    # replicated on, the NLL's sum over data, the logits' column blocks gathered
    # over model), then eq. (6)'s gathers and the flat rows' re-join
    shapes = layout.unflatten(torch.empty((a, p), device="meta"))
    fwd = spmd_steps.forward_gather_bytes(cfg, mesh, b, s, 4, a)
    _, dd, mm = spmd.mesh_sizes(mesh)
    grads = n_block = 0  # n_block: what a (data, model) position holds of an agent's row
    for x, sh in zip(tree_leaves(shapes), tree_leaves(param_shardings(shapes, mesh,
                                                                      agent_leading=True))):
        used = {ax for e in sh.spec if e is not None for ax in (e if isinstance(e, tuple) else (e,))}
        blk = x[0].numel() // (spmd.shard_factor(sh) // mesh.shape["pod"])
        n_block += blk
        for axis in {"data", "model"} - used:
            g = mesh.shape[axis]
            grads += 2 * a * (k // g) * 2 * (g - 1) * blk * 4
    local = {"gather_bytes": fwd["gather"],
             "all_reduce_bytes": fwd["all_reduce"] + grads + a * 2 * (dd - 1) * 4,
             "all_gather_bytes": a * dd * mm * (mm - 1) * (b // dd) * s * (cfg.padded_vocab // mm)
             * 4}
    eq6 = roofline_bytes([n_block] * k, "f32")
    rejoin = 6 * spmd_steps.rejoin_bytes(layout, mesh, a)

    def case(form, name, state, e, route, prior_check):
        """One placed round step against the unsharded one (``route`` the
        step's consensus keywords), ``prior_check(placed posterior)`` first;
        its traffic against the formulas.  Returns the reading."""
        ppermute = route.get("consensus_impl") == "ppermute"
        placed = spmd.device_put(state.posterior, param_shardings(state.posterior, mesh,
                                                                  agent_leading=True))
        prior = prior_check(placed)
        del placed
        torch.cuda.empty_cache()
        got, want, got_m, want_m, run = spmd_train_pair(
            f"{form} {name}", cfg, state, W, mesh, batch, e, tag=tag, profile=False,
            launches=0 if ppermute else k, on_placed=rows_alike if form == "flat" else None,
            **kw, **route)
        if form == "flat" and not run["placed"]["rows_bitwise_alike"]:
            raise AssertionError(f"{tag} {form} {name}: a pod's positions hold other rows")
        g, w = (x if form == "flat" else flat_state(x) for x in (got, want))
        noise = adam_noise_lanes(g, w)
        exempt = 2 * TRAIN_LR
        lanes = prior.pop("lanes", None)
        if lanes is not None and bool(lanes.any()):  # a wire-boundary lane: one bf16 place more
            noise = noise | lanes
            exempt += BF16_PLACE * (1.0 + float(w.posterior.mean.abs().max()))
        run["parity"] = train_parity(g, w, noise, exempt)
        run["prior"] = prior
        run["metrics_max_abs_err"] = {x: float((got_m[x] - want_m[x]).abs().max())
                                      for x in ("loss", "nll", "kl")}
        if run["parity"]["failures"]:
            raise AssertionError(f"{tag} {form} {name} (2, 2, 2) vs unsharded: {run}")
        want_bytes = dict(local)
        want_bytes["all_gather_bytes"] += ((0 if ppermute else eq6)
                                           + (rejoin if form == "flat" else 0))
        run["traffic_formula"] = want_bytes
        if any(run["spmd"][x] != y for x, y in want_bytes.items()):
            raise AssertionError(f"{tag} {form} {name}: moved {run['spmd']}, formula {want_bytes}")
        del got, want, g, w, noise
        torch.cuda.empty_cache()
        return run

    def einsum_prior(form, unplaced):
        def check(placed):
            view = (spmd_steps.FlatRows(layout, placed.mean).as_tree(placed) if form == "flat"
                    else placed)
            spmd.reset_spmd_counts()
            got = spmd_steps.pod_consensus(view, W, bf16)
            moved = spmd.spmd_counts()["all_gather_bytes"]
            got = flat_view(spmd.device_get(got))
            want = unplaced()
            lanes, count, worst = wire_lanes(f"{tag} {form}", (got.mean, got.rho),
                                             (want.mean, want.rho))
            sizes = block_sizes(view)
            formula = roofline_bytes(sizes, "f32")
            if moved != formula:
                raise AssertionError(f"{tag} {form}: eq. (6) gathered {moved} bytes, the "
                                     f"cost model's f32 exchange {formula}")
            return {"lanes": lanes, "wire_boundary_lanes": count, "max_abs_err": worst,
                    "block_sizes": sizes, "gather_bytes": moved, "gather_bytes_formula": formula,
                    "wire_bytes_bf16_cost_model": roofline_bytes(sizes, "bf16")}
        return check

    def ppermute_prior(form, unplaced, both_ways):
        def check(placed):
            co.reset_rotation_counts()
            got = spmd.device_get(spmd_steps.pod_ppermute(placed, W, bf16))
            rotated = co.rotation_counts()
            want = unplaced()
            same = all(torch.equal(x, y) for x, y in zip(tree_leaves(got), tree_leaves(want)))
            if not same:
                raise AssertionError(f"{tag} {form} ppermute: the placed prior is not the "
                                     f"unplaced ring's")
            sizes = [p] * k if form == "flat" else block_sizes(placed)
            formula = (2 if both_ways else 1) * roofline_bytes(sizes, "bf16")
            if rotated["bytes"] != formula:
                raise AssertionError(f"{tag} {form} ppermute: rotated {rotated}, formula "
                                     f"{formula}")
            return {"bitwise_unplaced": same, "rotated": rotated, "rotated_formula": formula}
        return check

    runs = {}
    runs["flat_einsum_f32"] = case(
        "flat", "einsum f32", flat, eps, {},
        lambda placed: {"block_sizes": block_sizes(spmd_steps.FlatRows(
            layout, placed.mean).as_tree(placed))})
    runs["flat_einsum_bf16"] = case(
        "flat", "einsum bf16", flat, eps, {"consensus_wire_dtype": bf16},
        einsum_prior("flat", lambda: co.consensus_einsum_flat(flat.posterior, W, bf16)))
    runs["flat_ppermute"] = case(
        "flat", "ppermute", flat, eps, {"consensus_impl": "ppermute"},
        ppermute_prior("flat", lambda: co.consensus_ppermute_ring_flat(
            flat.posterior, mesh, "pod", wire_dtype=bf16, W=W), True))

    # the network kernel at position (0, 0, 0)'s block of the flat rows, bf16 wire
    placed = spmd.device_put(flat.posterior, param_shardings(flat.posterior, mesh,
                                                             agent_leading=True))
    view = spmd_steps.FlatRows(layout, placed.mean).as_tree(placed)
    group = [0, mesh.size // 2]  # (0, 0, 0) and (1, 0, 0)
    blocks = [torch.cat([x.blocks[j].reshape(1, -1) for x in tree_leaves(field)], 1)
              for field in (view.mean, view.rho) for j in group]
    mean_blk, rho_blk = torch.cat(blocks[:2]).contiguous(), torch.cat(blocks[2:]).contiguous()
    del blocks, view, placed
    network = functools.partial(kc.consensus_fused_network, w_wire, mean_blk, rho_blk,
                                wire_dtype=bf16)
    plain = functools.partial(kc.consensus_network_plain, w_wire, mean_blk, rho_blk, bf16)
    got_k, want_k = network(), plain()
    lanes, flips, eq6_err = wire_lanes(f"{tag} row 1sw", got_k, want_k)
    off_boundary = max(float((g_ - w_).abs().masked_fill(lanes, 0.0).max())
                       for g_, w_ in zip(got_k, want_k))
    del got_k, want_k, lanes
    n = mean_blk.shape[1]
    nbytes, ops = 16 * a * n + 4 * a * a, 4 * a * a * n + 20 * a * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    wire_row = {"name": "consensus_fused_network_spmd_wire", "route": "cuda",
                "source": SRC + "consensus_network.cu", "replaces": REF + "195",
                "launches": runs["flat_einsum_bf16"]["consensus_fused_network"],
                "max_abs_err": eq6_err, "ms": cuda_ms(network), "plain_ms": event_ms(plain),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}
    kernel = {"n": n, "wire_boundary_lanes": flips, "max_abs_err_off_boundary": off_boundary,
              "atol": F32_TOL, **{x: wire_row[x] for x in ("ms", "plain_ms", "bound_ms")}}
    del mean_blk, rho_blk, network, plain

    # the pytree form of the same state, alone on the card
    post = GaussianPosterior(mean=tree_map(torch.clone, layout.unflatten(flat.posterior.mean)),
                             rho=tree_map(torch.clone, layout.unflatten(flat.posterior.rho)))
    tree = steps.BayesTrainState(posterior=post, opt_state=opt.init(post), step=flat.step)
    del flat, post
    torch.cuda.empty_cache()
    e = layout.unflatten(eps)
    runs["pytree_einsum_bf16"] = case(
        "pytree", "einsum bf16", tree, e, {"consensus_wire_dtype": bf16},
        einsum_prior("pytree", lambda: flat_view(co.consensus_einsum(tree.posterior, W, bf16))))
    runs["pytree_ppermute"] = case(
        "pytree", "ppermute", tree, e, {"consensus_impl": "ppermute"},
        ppermute_prior("pytree", lambda: co.consensus_ppermute_pod(
            tree.posterior, W, mesh, param_shardings(tree.posterior, mesh,
                                                     agent_leading=True), bf16), False))
    del tree, e, eps, batch
    torch.cuda.empty_cache()

    bytes_ = {"local_step": local, "eq6_gather_f32": eq6,
              "eq6_wire_bf16_cost_model": roofline_bytes([n_block] * k, "bf16"),
              "rejoin": rejoin, "rejoin_k_minus_1_rows": 6 * (k - 1) * a * p * 4}
    phase(tag, nvidia_smi=smi, model=cfg.name, agents=a, batch_per_agent=b, seq=s,
          n_params_per_agent=p, mesh=mesh.shape, W=SPMD_WIRE_W, runs=runs, bytes=bytes_,
          kernel_1sw=kernel)
    return [wire_row]


def run_moe_ep(dev, smi):
    """Phase 3.moe_ep: the expert-parallel MoE layer
    (``launch.expert_parallel.moe_ffn_expert_parallel``) at full layer
    width on virtual shards of the card: OLMoE-1B-7B (E = 64, top-8, D =
    2,048, F = 1,024) over a (1, 8) ``("data", "model")`` mesh and
    Phi-3.5-MoE (E = 16, top-2, D = 4,096, F = 6,400) over (1, 4), each on
    ``3.lm_olmoe``'s 16,384 tokens (x ``[4, 4096, D]`` bf16, normal from a
    seed), weights from ``moe_init`` at seed 0 cast to bf16.  Held: at
    capacity factor 16 (no drops) against ``models.moe.moe_ffn``
    (``LAYER_BF16_ATOL`` / ``LAYER_BF16_RMS``), with the control, each token
    routed to its top-(k - 1) experts, beyond those bounds; two calls the
    same bits.  Read at the config's capacity factor (1.25): the drop
    share, each all-to-all's bytes a shard beside (m - 1) cap D 2 B, ms a
    call (CUDA events) beside ``moe_ffn``'s.  Over real cards where the
    host has more than one: the largest count of cards that divides E,
    bitwise the virtual run of that mesh shape."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import expert_parallel as ep
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import _capacity, moe_ffn, moe_init

    out = {}
    for arch, m in EP_CONFIGS:
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = moe_init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        params = {k: v.to(torch.bfloat16) for k, v in params.items()}
        weight_bytes = tree_bytes(params)
        x = torch.randn(EP_TOKENS + (cfg.d_model,), generator=torch.Generator(device=dev)
                        .manual_seed(1), device=dev).to(torch.bfloat16)
        mesh = make_mesh((1, m), ("data", "model"), dev)
        no_drop = dataclasses.replace(cfg, capacity_factor=16.0)
        ep.reset_ep_counts()
        y, aux = ep.moe_ffn_expert_parallel(params, x, no_drop, mesh)
        if ep.ep_counts()["dropped"]:
            raise AssertionError(f"3.moe_ep {arch}: drops at capacity factor 16")
        want, want_aux = moe_ffn(params, x, no_drop)
        held = lm_check(f"3.moe_ep {arch} vs moe_ffn", y, want, LAYER_BF16_ATOL, LAYER_BF16_RMS)
        del y
        fewer = dataclasses.replace(no_drop, top_k=cfg.top_k - 1)
        ctrl = lm_control(f"3.moe_ep {arch} top-(k - 1) (control)", moe_ffn(params, x, fewer)[0],
                          want, LAYER_BF16_ATOL, LAYER_BF16_RMS)
        del want
        torch.cuda.empty_cache()
        call = functools.partial(ep.moe_ffn_expert_parallel, params, x, cfg, mesh)
        ep.reset_ep_counts()
        first, first_aux = call()
        counts = ep.ep_counts()
        again, again_aux = call()
        if not (torch.equal(first, again) and torch.equal(first_aux, again_aux)):
            raise AssertionError(f"3.moe_ep {arch}: two calls give other bits")
        if not bool(torch.isfinite(first).all()):
            raise AssertionError(f"3.moe_ep {arch}: non-finite output")
        del again
        t_dev = x.shape[0] * x.shape[1] // m
        cap = _capacity(t_dev, m, cfg.top_k, cfg.capacity_factor)
        per_shard = counts["bytes"] // (2 * m)  # two all-to-alls of activations
        expect = (m - 1) * cap * cfg.d_model * 2
        if per_shard != expect:
            raise AssertionError(f"3.moe_ep {arch}: {per_shard} B a shard and direction, "
                                 f"expected {expect}")
        cards = "one card"
        n_cards = torch.cuda.device_count()
        if n_cards > 1:
            k = max(c for c in range(1, n_cards + 1) if cfg.n_experts % c == 0)
            devices = [torch.device("cuda", i) for i in range(k)]
            virtual = ep.moe_ffn_expert_parallel(params, x, cfg, make_mesh((1, k), ("data",
                                                                                   "model"), dev))
            real = ep.moe_ffn_expert_parallel(params, x, cfg, make_mesh((1, k), ("data", "model"),
                                                                        devices))
            cards = {"cards": k, "bitwise_virtual": torch.equal(real[0], virtual[0])
                     and torch.equal(real[1], virtual[1])}
            if not cards["bitwise_virtual"]:
                raise AssertionError(f"3.moe_ep {arch}: over real cards {cards}")
            del virtual, real
        ms = event_ms(call)
        plain_ms = event_ms(functools.partial(moe_ffn, params, x, cfg))
        kept, dropped = counts["kept"], counts["dropped"]
        out[arch] = {"experts": cfg.n_experts, "top_k": cfg.top_k, "d_model": cfg.d_model,
                     "d_ff": cfg.d_ff, "mesh": mesh.shape, "tokens": x.shape[0] * x.shape[1],
                     "weight_bytes": weight_bytes, "no_drop_vs_moe_ffn": held,
                     "no_drop_aux": float(aux), "moe_ffn_aux": float(want_aux),
                     "control_top_k_minus_1": ctrl, "bounds": [LAYER_BF16_ATOL, LAYER_BF16_RMS],
                     "capacity_factor": cfg.capacity_factor, "capacity": cap,
                     "drop_share": dropped / (kept + dropped), "counts": counts,
                     "all_to_all_bytes_a_shard": per_shard,
                     "all_to_all_bytes_expected": expect, "ms": ms, "moe_ffn_ms": plain_ms,
                     "aux": float(first_aux), "real_cards": cards,
                     "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
        del params, x, first, call
    torch.cuda.empty_cache()
    phase("3.moe_ep", nvidia_smi=smi, **out)


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
    errs.update(check_shard(dev))
    session, counts, prior, slice_run_s = run_slice(dev)
    l_session, l_counts = run_launch(dev, session)
    run_launch_checkpoint(dev, smi, l_session)
    gossip = run_gossip(dev)
    g_session, g_counts = gossip["3.gossip"]
    sharded = run_sharded(dev, smi)
    sharded_rungs(dev, sharded, g_session.state)
    sh_session, sh_counts = sharded["f32", 3, 1]  # 3 virtual shards, f32
    csr_counts = run_csr(dev, g_session)
    ops_counts = run_ops(dev, session, prior)
    d_session, d_counts = run_delayed(dev, smi)
    sp_counts = run_sparse(dev, smi)
    run_sparse_1e4(dev, smi)
    run_serve(dev, session, smi)  # after 3.sparse: its graphs stay out of that peak
    run_obs(dev, smi, slice_wall_ms=slice_run_s * 1e3 / 3)
    run_obs_gossip(dev, smi)
    lm_row = run_lm_qwen3(dev, smi)
    zoo_row, zoo_f32_launches = run_lm_repro100m(dev, smi)
    new_rows = [row for tag, arch, held, depth in LM_NEW
                for row in run_lm_new(dev, smi, tag, arch, held, n_layers=depth)]
    run_lm_reduced(dev, smi)
    train_row = run_lm_train(dev, smi)
    new_rows += run_lm_new(dev, smi, "3.lm_whisper", "whisper-tiny", True, WHISPER_BATCH,
                           WHISPER_TEXT, WHISPER_CAP, FRONT_DECODE)
    run_lm_whisper_train(dev, smi)
    new_rows += run_lm_new(dev, smi, "3.lm_pixtral", "pixtral-12b", True, PIXTRAL_BATCH,
                           PIXTRAL_TEXT, LM_CAP, FRONT_DECODE)
    pod_row = run_lm_train_pod(dev, smi)
    spmd_rows = run_lm_spmd(dev, smi)
    spmd_rows += run_lm_spmd_kinds(dev, smi)
    spmd_rows += run_lm_spmd_xlstm_whisper(dev, smi)
    spmd_rows += run_lm_spmd_consensus(dev, smi)
    run_moe_ep(dev, smi)
    card_vs_cpu("4.parity", session, fig4_spec())
    card_vs_cpu("4.launch_parity", l_session, launch_spec())
    card_vs_cpu("4.gossip_parity", g_session, gossip_spec())
    card_vs_cpu("4.delayed_parity", d_session, gossip_spec(clock=DELAYED_CLOCK))
    card_vs_cpu("4.sharded_parity", sh_session, gossip_spec(consensus_impl="ppermute"),
                cpu_devices=[torch.device("cpu")] * 3)
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
        # the f32 kernel: 3.lm_repro100m's f32 prefill runs it at repro-100m's
        # shape; no path runs its other rows' shapes, which are timed only
        **{name: 0 for name in ATTN_F32_SHAPES},
        "flash_attention_f32_repro100m": zoo_f32_launches,
        "consensus_fused_segments": d_counts["consensus_fused_segments"],
        "consensus_fused_segments_4200": sp_counts["consensus_fused_segments"],
        "consensus_fused_shard": sh_counts["consensus_fused_shard"],
        "consensus_shard_encode": sh_counts["consensus_shard_encode"],
    }
    rows = (timings(dev, launches, errs) + [lm_row, zoo_row] + new_rows + [train_row, pod_row]
            + spmd_rows)
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
