"""Analytic roofline cost model (port of ``repro.launch.costmodel``'s
byte models).

Three memory-bound models, each a pure function of plain numbers:

* ``consensus_roofline`` — one eq. (6) round's HBM traffic per execution
  strategy (``leaf_loop``, ``flat_fused``, ``flat_sparse``,
  ``flat_segments``) and the collective bytes at a wire dtype;
* ``gossip_window_roofline`` — one gossip event window's traffic (masked,
  dense, edge-native, history ring, sharded interconnect);
* ``serve_roofline`` — the serving tier's snapshot residency, publish and
  per-batch apply bytes.

and the model zoo's FLOP, HBM-byte and collective-byte model of one train,
prefill or decode step, ``analytic_costs`` (with ``_layer_kind_counts``).

Every count and dict key is the reference's; the ``roofline_seconds`` are
those counts over the card's constants in ``launch.mesh`` (H100 SXM5:
``HBM_BW`` = 3.35 TB/s, ``PEAK_FLOPS_BF16`` = 989 TFLOP/s, ``ICI_BW`` =
NVLink's 450 GB/s a direction), not the TPU v5e's.  ``analytic_costs``
divides by the reference's ``chips = agents x data x model shards`` (2 for
two agents); on one card that holds every agent, read ``flops_global`` and
``hbm_bytes_global`` over one card's peaks instead.
"""
from __future__ import annotations

from typing import Any

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

ATTN_KINDS = ("attn", "local_attn", "moe", "dec_attn")


def _wire_bytes_per_el(wire_dtype: str) -> int:
    """Bytes per exchanged scalar at a wire dtype (``core.numerics
    .WIRE_DTYPES`` names), in plain ints: the cost model touches no
    tensor."""
    sizes = {"f32": 4, "bf16": 2, "f16": 2}
    if wire_dtype not in sizes:
        raise ValueError(
            f"unknown wire_dtype {wire_dtype!r}; known: {sorted(sizes)}"
        )
    return sizes[wire_dtype]


def consensus_roofline(
    n_agents: int,
    n_params: int,
    n_leaves: int,
    max_degree: int | None = None,
    bytes_per_el: int = 4,
    *,
    wire_dtype: str = "f32",
    n_edges: int | None = None,
) -> dict[str, Any]:
    """Analytic HBM traffic of one consensus round (eq. 6), per execution
    strategy, for the memory-bound roofline (``obs.roofline
    .consensus_attainment`` holds a measured round against it).

    The posterior state is 2 buffers (mean, rho) of [n_agents, n_params]
    scalars.  Counted array-sized HBM touches (reads + writes), per buffer
    pair:

    * ``leaf_loop``: the unfused per-leaf einsum reference — per leaf the
      chain softplus/square/reciprocal -> einsum -> mul/einsum/div ->
      rsqrt/softplus_inv materializes ~6 round-trips (12 touches) over the
      leaf-sized tensors; a compiler fuses within each elementwise group but the
      two einsums force the intermediates (prec, prec*mu, new_prec, new_pm)
      through HBM, and each of the ``n_leaves`` leaves dispatches its own
      kernel chain.
    * ``flat_fused``: the single network-wide kernel — read mean+rho once,
      write mean+rho once: 4 touches, 1 HBM pass, independent of n_leaves.
    * ``flat_sparse``: same, but each agent reads only deg(i) <= max_degree
      neighbor rows instead of all N (identical write traffic).

    Returns bytes per strategy, the pass counts, and the roofline seconds at
    ``HBM_BW`` (single chip).

    WIRE term (``wire_dtype``): with the agent axis sharded, eq. (6)
    all-gathers BOTH sufficient statistics (prec, prec*mu) across agents;
    at a compressed wire dtype the payload is cast at the exchange
    boundary, so the collective bytes scale with ``wire_dtype``'s itemsize
    — bf16 exactly halves them (asserted by unit test).  Reported in the
    ``wire`` block; the HBM terms stay at ``bytes_per_el`` (the buffers
    are fp32-resident, only the exchange compresses).

    E-PARAMETERIZATION (``n_edges`` — self-loops included, i.e.
    ``SparseGraph.n_edges``): every sparse term is really a function of the
    directed edge count E, not of N^2.  ``flat_segments`` is the
    edge-native ``core.flat.consensus_flat_segments`` traffic — gather both
    statistics' source row per edge, write both network buffers — and the
    edge-parameterized wire collective moves only the E - N off-diagonal
    rows instead of the dense N(N-1).  When ``n_edges`` is omitted it is
    derived as ``n_agents * max_degree`` (the padded-table bound), which
    makes ``flat_segments`` coincide with ``flat_sparse``; pass the true E
    for ragged-degree graphs (Watts-Strogatz, Barabasi-Albert), where the
    padded bound overcounts.
    """
    wire_el = _wire_bytes_per_el(wire_dtype)
    row_bytes = n_params * bytes_per_el  # one agent, one buffer
    net_bytes = n_agents * row_bytes  # one buffer for the whole network
    touches_leaf_loop = 12.0  # ~6 round-trips over both buffers
    touches_fused = 4.0  # read mean+rho, write mean+rho
    deg = n_agents if max_degree is None else max_degree
    n_edges_eff = int(n_agents * deg) if n_edges is None else int(n_edges)
    bytes_leaf_loop = touches_leaf_loop * net_bytes
    bytes_fused = touches_fused * net_bytes
    # sparse: each agent reads deg(i) neighbor rows of both buffers; writes
    # are the same 2 network-sized buffers as the dense fused kernel
    bytes_sparse = 2.0 * n_agents * deg * row_bytes + 2.0 * net_bytes
    # segments: 2 E-row gathers (prec, prec*mu sources) + 2 network writes —
    # O(E), never O(N^2); equals bytes_sparse when E = N * deg
    bytes_segments = 2.0 * n_edges_eff * row_bytes + 2.0 * net_bytes
    out = {
        "n_agents": n_agents,
        "n_params": n_params,
        "n_leaves": n_leaves,
        "n_edges": n_edges_eff,
        "hbm_bytes": {
            "leaf_loop": bytes_leaf_loop,
            "flat_fused": bytes_fused,
            "flat_sparse": bytes_sparse,
            "flat_segments": bytes_segments,
        },
        "hbm_passes": {  # in fused-pass units (1.0 = one read+write of both buffers)
            "leaf_loop": touches_leaf_loop / touches_fused,
            "flat_fused": 1.0,
            "flat_sparse": bytes_sparse / bytes_fused,
            "flat_segments": bytes_segments / bytes_fused,
        },
        "roofline_seconds": {
            "leaf_loop": bytes_leaf_loop / HBM_BW,
            "flat_fused": bytes_fused / HBM_BW,
            "flat_sparse": bytes_sparse / HBM_BW,
            "flat_segments": bytes_segments / HBM_BW,
        },
        "model_speedup_fused_vs_leaf_loop": bytes_leaf_loop / bytes_fused,
        # collective exchange of (prec, prec*mu) over a sharded agent axis:
        # ring all-gather of both statistics = 2 x net x (N-1)/N per agent
        # -> 2 x N x (N-1) x row bytes globally, at the WIRE itemsize;
        # the edge-parameterized form moves only the E - N off-diagonal rows
        "wire": {
            "dtype": wire_dtype,
            "bytes_per_el": wire_el,
            "collective_bytes": (
                2.0 * n_agents * (n_agents - 1) * n_params * wire_el
            ),
            "collective_bytes_f32": (
                2.0 * n_agents * (n_agents - 1) * n_params * 4
            ),
            "collective_bytes_edges": (
                2.0 * max(n_edges_eff - n_agents, 0) * n_params * wire_el
            ),
        },
    }
    out["wire"]["model_saving_vs_f32"] = (
        out["wire"]["collective_bytes_f32"] / out["wire"]["collective_bytes"]
        if out["wire"]["collective_bytes"] else 1.0
    )
    return out


def gossip_window_roofline(
    n_agents: int,
    n_params: int,
    n_participating: int,
    n_merging: int | None = None,
    bytes_per_el: int = 4,
    *,
    n_shards: int = 1,
    n_cross_offsets: int = 0,
    delay_depth: int = 0,
    n_stale_events: int = 0,
    wire_dtype: str = "f32",
    history_dtype: str = "f32",
    n_event_edges: int | None = None,
    n_padded_edges: int | None = None,
) -> dict[str, Any]:
    """Analytic HBM traffic of ONE gossip event window (repro.gossip), for
    the active-edge masked consensus (``consensus_fused_masked_sparse``).

    Only agents PARTICIPATING in the window's events (source or target of a
    fired edge) have their (mean, rho) rows read, and only MERGING agents
    (>= 1 incoming event) are written; untouched agents cost nothing (their
    rows pass through in place — a donated-buffer window update never
    streams them).  With every agent participating this degenerates to the
    dense fused number (``consensus_roofline``'s ``flat_fused``: 4 network
    passes' worth of touches), which the monotonicity unit test pins:
    window bytes are monotone in the active fraction and bounded above by
    the dense fused bytes.

    ``n_participating`` / ``n_merging`` come straight from an
    ``EventWindow`` (``window.participating().sum()`` /
    ``window.active.sum()``); ``n_merging`` defaults to
    ``n_participating``.

    INTERCONNECT term (``n_shards > 1`` — the sharded
    ``consensus_ppermute_window`` execution): each of the window's
    ``n_cross_offsets`` fired shard offsets
    (``launch.consensus_opt.window_shard_offsets``) is one ppermute
    rotation moving every shard's [N/S, P] (prec, prec*mu) block —
    ``2 x N x P`` bytes globally per offset — vs the dense layout's
    all-gather of both statistics (``2 x N x P x (S-1)``).  The ppermute
    schedule wins whenever the window crosses fewer than S-1 offsets, and
    an idle window moves ZERO bytes.

    DELIVERY-LATENCY term (``delay_depth > 0`` — a ``DelayedClock``): the
    engine writes each window's post-local (mean, rho) into the [K, N, P]
    history ring (one extra network write, ``2 x N x P`` bytes) and the
    gather consensus reads one stale (mean, rho) row pair per delivered
    event (``n_stale_events``, i.e. ``EventWindow.n_events``).  The ring
    buffer's RESIDENT footprint is ``hist_resident_bytes`` =
    ``2 x (delay_depth + 1) x N x P`` — the capacity planner's number, not
    a per-window traffic term.

    WIRE term (``wire_dtype``): the ppermuted payload and the dense
    all-gather both carry the (prec, prec*mu) statistics AT THE WIRE DTYPE
    (the sharded window casts them at the exchange boundary), so every
    ``ici_bytes`` entry scales with the wire itemsize — bf16 exactly
    halves the interconnect bytes (asserted by unit test).  The HBM terms
    stay at ``bytes_per_el`` (fp32-resident buffers); ``history_dtype``
    independently sizes the ring's resident footprint and its per-window
    traffic (bf16 halves the resident ring).

    EDGE-NATIVE term (``n_event_edges`` — the window's fired NON-SELF event
    count, ``EventWindow.n_events`` or the thinned-Poisson fired count):
    the segment-sum window (``consensus_flat_segments`` over fired edges +
    the merging rows' self edges) gathers one (prec, prec*mu) source row
    pair per fired edge plus each merging row's own pair, and writes the
    merging rows — ``window_segments`` is a pure function of
    (E_fired, n_merging, P), with NO N term at all: the roofline the
    N = 10^4+ sparse windows are held against.

    ``n_padded_edges`` additionally reports the STATIC execution cost the
    engine actually pays: the ``SparseWindow`` rides fixed-shape
    ``[E_max]`` buffers (one trace for the whole run) plus N self-loop
    slots, and a zero-weight pad slot still gathers its source row even
    though it contributes nothing — ``window_segments_padded`` is the
    per-window ceiling ``2 x (E_max + N) x row + 2 x n_merging x row``,
    what a capacity planner should budget (and what shrinking the clock's
    ``e_max`` buys).
    """
    if n_merging is None:
        n_merging = n_participating
    if not 0 <= n_merging <= n_participating <= n_agents:
        raise ValueError(
            "expected 0 <= n_merging <= n_participating <= n_agents, got "
            f"{n_merging} / {n_participating} / {n_agents}"
        )
    if n_shards < 1 or not 0 <= n_cross_offsets <= max(n_shards - 1, 0):
        raise ValueError(
            f"expected n_shards >= 1 and 0 <= n_cross_offsets <= n_shards - 1"
            f", got {n_shards} / {n_cross_offsets}"
        )
    if delay_depth < 0 or n_stale_events < 0:
        raise ValueError("delay_depth and n_stale_events must be >= 0")
    wire_el = _wire_bytes_per_el(wire_dtype)
    hist_el = _wire_bytes_per_el(history_dtype)
    row_bytes = n_params * bytes_per_el
    net_bytes = n_agents * row_bytes
    # read mean+rho of participants, write mean+rho of merging agents
    bytes_window = 2.0 * n_participating * row_bytes + 2.0 * n_merging * row_bytes
    bytes_dense = 4.0 * net_bytes  # consensus_roofline flat_fused
    # history ring (at its RESIDENT dtype): one (mean, rho) network write
    # per window + one stale row pair read per delivered event
    hist_row = n_params * hist_el
    hist_net = n_agents * hist_row
    bytes_history = (
        2.0 * hist_net + 2.0 * n_stale_events * hist_row
        if delay_depth > 0 else 0.0
    )
    # interconnect: ppermute rotations vs the dense all-gather of both
    # sufficient statistics over the agent axis (global bytes, at the WIRE
    # dtype — the payload is cast at the exchange boundary)
    wire_net = n_agents * n_params * wire_el
    ici_ppermute = n_cross_offsets * 2.0 * wire_net
    ici_allgather = 2.0 * wire_net * (n_shards - 1)
    out = {
        "n_agents": n_agents,
        "n_params": n_params,
        "n_participating": n_participating,
        "n_merging": n_merging,
        # NOT EventWindow.active_fraction (the merging-agent mean): this is
        # the fraction of agents whose rows the window kernel must read
        "participating_fraction": n_participating / n_agents if n_agents else 0.0,
        "hbm_bytes": {"window_masked": bytes_window, "dense_fused": bytes_dense},
        # fused-pass units: 1.0 == one read+write of both network buffers
        "hbm_passes": {
            "window_masked": bytes_window / bytes_dense if bytes_dense else 0.0,
            "dense_fused": 1.0,
        },
        "roofline_seconds": {
            "window_masked": bytes_window / HBM_BW,
            "dense_fused": bytes_dense / HBM_BW,
        },
        "model_speedup_window_vs_dense": (
            bytes_dense / bytes_window if bytes_window else float("inf")
        ),
    }
    out["wire_dtype"] = wire_dtype
    if n_event_edges is not None:
        if n_event_edges < 0:
            raise ValueError("n_event_edges must be >= 0")
        bytes_segments = (
            2.0 * (n_event_edges + n_merging) * row_bytes
            + 2.0 * n_merging * row_bytes
        )
        out["n_event_edges"] = int(n_event_edges)
        out["hbm_bytes"]["window_segments"] = bytes_segments
        out["hbm_passes"]["window_segments"] = (
            bytes_segments / bytes_dense if bytes_dense else 0.0
        )
        out["roofline_seconds"]["window_segments"] = bytes_segments / HBM_BW
    if n_padded_edges is not None:
        if n_event_edges is not None and n_padded_edges < n_event_edges:
            raise ValueError(
                f"n_padded_edges={n_padded_edges} is below the fired count "
                f"n_event_edges={n_event_edges} (pads can only add slots)"
            )
        if n_padded_edges < 0:
            raise ValueError("n_padded_edges must be >= 0")
        # static [E_max] buffers + N self-loop slots: pad slots gather their
        # source row like any edge (zero weight, zero contribution)
        bytes_padded = (
            2.0 * (n_padded_edges + n_agents) * row_bytes
            + 2.0 * n_merging * row_bytes
        )
        out["n_padded_edges"] = int(n_padded_edges)
        out["hbm_bytes"]["window_segments_padded"] = bytes_padded
        out["hbm_passes"]["window_segments_padded"] = (
            bytes_padded / bytes_dense if bytes_dense else 0.0
        )
        out["roofline_seconds"]["window_segments_padded"] = (
            bytes_padded / HBM_BW
        )
    if delay_depth > 0:
        out["delay_depth"] = delay_depth
        out["history_dtype"] = history_dtype
        out["hbm_bytes"]["history"] = bytes_history
        out["hist_resident_bytes"] = 2.0 * (delay_depth + 1) * hist_net
        out["roofline_seconds"]["history"] = bytes_history / HBM_BW
    if n_shards > 1:
        out["n_shards"] = n_shards
        out["n_cross_offsets"] = n_cross_offsets
        out["ici_bytes"] = {
            "window_ppermute": ici_ppermute,
            "dense_allgather": ici_allgather,
        }
        out["roofline_seconds"]["ici_window_ppermute"] = ici_ppermute / ICI_BW
        out["roofline_seconds"]["ici_dense_allgather"] = ici_allgather / ICI_BW
        out["model_ici_saving_ppermute_vs_allgather"] = (
            ici_allgather / ici_ppermute if ici_ppermute else float("inf")
        )
    return out


def serve_roofline(
    n_agents: int,
    n_params: int,
    *,
    snapshot_dtype: str = "f32",
    mc_samples: int = 8,
    batch: int = 1,
    dim: int = 1,
    n_classes: int = 2,
    bytes_per_el: int = 4,
) -> dict[str, Any]:
    """Analytic bytes model of the posterior serving tier (``repro.serve``),
    for the memory-bound roofline of one served micro-batch.

    SNAPSHOT term: the published double buffer is 2 x [n_agents, n_params]
    scalars RESIDENT at ``snapshot_dtype`` (the ``core.numerics`` wire
    vocabulary) — a bf16 snapshot is exactly HALF the fp32 HBM (asserted by
    unit test).  ``snapshot_publish_bytes`` is the traffic of one publish:
    read the fp32 training buffers, write the snapshot-resident copy.

    PER-QUERY APPLY term: one micro-batch of ``batch`` rows under one
    agent's posterior draws ``mc_samples`` parameter samples; each sample
    reads the agent's (mean, rho) row pair once (``2 x n_params`` at the
    snapshot dtype — the fp32 widening is fused into the read), streams
    the [batch, dim] inputs and writes [batch, n_classes] fp32
    probabilities.  ``mc_samples=0`` (the point estimate) still reads the
    mean row once.  The serving regime is posterior-row bound whenever
    ``mc_samples x n_params >> batch x dim``, which is the paper's setting
    — so apply bytes scale ~linearly in L, the ensemble size.
    """
    snap_el = _wire_bytes_per_el(snapshot_dtype)
    if mc_samples < 0 or batch <= 0:
        raise ValueError("mc_samples must be >= 0 and batch positive")
    snapshot_bytes = 2.0 * n_agents * n_params * snap_el
    snapshot_bytes_f32 = 2.0 * n_agents * n_params * 4
    publish_bytes = snapshot_bytes_f32 + snapshot_bytes  # read fp32, write resident
    draws = max(mc_samples, 1)  # the point estimate still reads the mean row
    row_reads = (2.0 if mc_samples else 1.0) * draws * n_params * snap_el
    io_bytes = batch * dim * bytes_per_el + batch * n_classes * 4.0
    apply_bytes = row_reads + io_bytes
    out = {
        "n_agents": n_agents,
        "n_params": n_params,
        "snapshot_dtype": snapshot_dtype,
        "mc_samples": mc_samples,
        "batch": batch,
        "snapshot_hbm_bytes": snapshot_bytes,
        "snapshot_hbm_bytes_f32": snapshot_bytes_f32,
        "snapshot_saving_vs_f32": (
            snapshot_bytes_f32 / snapshot_bytes if snapshot_bytes else 1.0
        ),
        "snapshot_publish_bytes": publish_bytes,
        "apply_bytes_per_batch": apply_bytes,
        "apply_bytes_per_row": apply_bytes / batch,
        "posterior_row_bound": row_reads > io_bytes,
        "roofline_seconds": {
            "publish": publish_bytes / HBM_BW,
            "apply_per_batch": apply_bytes / HBM_BW,
        },
    }
    return out


def _layer_kind_counts(cfg) -> dict[str, int]:
    counts: dict[str, int] = {}
    for k in cfg.pattern:
        counts[k] = counts.get(k, 0) + cfg.n_periods
    for k in cfg.tail:
        counts[k] = counts.get(k, 0) + 1
    return counts


def analytic_costs(
    cfg,
    *,
    mode: str,  # train | prefill | decode
    batch_global: int,
    seq_len: int,
    n_agents: int,
    data_shards: int,
    model_shards: int,
    n_matmul_params: int,  # matmul-active params per agent (dryrun.count_active_params)
    n_total_params: int,  # all params per agent
    window: int | None = None,
    chunk_size: int = 512,
    kv_bytes: float = 2.0,  # bf16 cache; 1.0 + per-head scales for int8
) -> dict[str, Any]:
    """One step's global FLOPs, HBM bytes and collective bytes, with the
    roofline's three terms; the reference's coefficients, term for term
    (fwd+bwd = 6 N D for ``train``, the causal half of attention, ~14
    fp32 passes of the posterior, its gradient and Adam's state a step)."""
    a = n_agents
    b = batch_global  # total across agents
    s = seq_len
    hd = cfg.hd
    h = cfg.n_heads
    d = cfg.d_model
    f = 6.0 if mode == "train" else 2.0  # fwd+bwd vs fwd-only multiplier
    counts = _layer_kind_counts(cfg)
    kv_len = s  # cache length for decode
    tokens = b * (1 if mode == "decode" else s)

    # ---------------- FLOPs ----------------
    flops = f * n_matmul_params * tokens  # dense matmul term (2ND fwd, 4ND bwd)
    # attention: 4*B*Sq*Skv_eff*H*hd per layer fwd (scores + PV), f/2 scales bwd
    for kind, n_l in counts.items():
        if kind not in ATTN_KINDS and kind not in ("mlstm", "slstm"):
            continue
        if kind in ATTN_KINDS:
            if mode == "decode":
                skv = min(kv_len, window) if window else kv_len
                attn = 4.0 * b * 1 * skv * h * hd
            else:
                w_eff = cfg.sliding_window if kind == "local_attn" else (window or 0)
                skv_sum = (s * min(w_eff, s)) if w_eff else (s * s * 0.5)  # causal half
                attn = 4.0 * b * skv_sum * h * hd
            flops += (f / 2.0) * attn * n_l
            if kind == "dec_attn" and cfg.is_encdec:
                sq = 1 if mode == "decode" else s
                flops += (f / 2.0) * 4.0 * b * sq * cfg.encoder_seq * h * hd * n_l
        elif kind == "mlstm":
            p = 2 * d
            dk = p // cfg.n_heads
            c = 1 if mode == "decode" else min(chunk_size // 2, s)
            # intra-chunk masked attention (~c keys/query) + state update (dk*dk outer)
            per_tok = 4.0 * c * cfg.n_heads * dk + 4.0 * cfg.n_heads * dk * dk
            flops += (f / 2.0) * per_tok * tokens * n_l
        elif kind == "slstm":
            hd_s = d // cfg.n_heads
            flops += (f / 2.0) * 8.0 * d * hd_s * tokens * n_l  # 4 block-diag matvecs
    if cfg.is_encdec and mode != "decode":
        # encoder self-attention (bidirectional, no causal half)
        flops += (f / 2.0) * 4.0 * b * cfg.encoder_seq**2 * h * hd * cfg.encoder_layers

    # ---------------- HBM bytes ----------------
    param_bytes_bf16 = n_total_params * 2
    if mode == "train":
        # posterior (mu,rho fp32) + grads + Adam (4 fp32) read/write ~= 14 passes
        state = 14.0 * n_total_params * 4 * a
        weights = 3.0 * param_bytes_bf16 * a  # theta sample read fwd + 2x bwd
        # activations: ~8 d-wide tensors/layer/token bf16, ~2.5x for bwd+remat
        act = 2.5 * cfg.n_layers * tokens * 8.0 * d * 2
        hbm = state + weights + act
    elif mode == "prefill":
        weights = param_bytes_bf16 * a
        act = cfg.n_layers * tokens * 8.0 * d * 2
        kv_write = 2.0 * cfg.n_layers * tokens * cfg.n_kv_heads * hd * kv_bytes
        hbm = weights + act + kv_write
    else:  # decode
        weights = param_bytes_bf16 * a
        skv = min(kv_len, window) if window else kv_len
        n_attn = sum(n for k, n in counts.items() if k in ATTN_KINDS)
        kv_read = 2.0 * n_attn * b * skv * cfg.n_kv_heads * hd * kv_bytes
        # recurrent state read/write
        rec = 0.0
        if "mlstm" in counts:
            p = 2 * d
            rec += 2.0 * counts["mlstm"] * b * cfg.n_heads * (p // cfg.n_heads) ** 2 * 4
        if "rglru" in counts:
            rec += 2.0 * counts["rglru"] * b * d * 4
        if "slstm" in counts:
            rec += 2.0 * counts["slstm"] * b * d * 4
        hbm = weights + kv_read + rec + tokens * 8.0 * d * 2 * cfg.n_layers

    # ---------------- collective bytes ----------------
    dsh, msh = data_shards, model_shards
    coll = 0.0
    # GLOBAL collective bytes (summed over devices).  Ring collectives: an
    # all-gather/reduce-scatter of a tensor of TOTAL size T over g
    # participants moves T*(g-1)/g per participant -> T*(g-1) global; an
    # all-reduce moves ~2x that.
    # TP activation all-reduces: ~2 per layer; per TP group the tensor is
    # [tokens/dsh, d] bf16 -> global = 2ops * 2x * tokens*d*2B * (m-1)
    if msh > 1:
        coll += (f / 2.0) * 2.0 * 2.0 * cfg.n_layers * tokens * d * 2 * (msh - 1)
    if mode == "train":
        # FSDP param all-gather (1 fwd + 2 bwd passes) + grad reduce-scatter
        # over the data axis
        if dsh > 1:
            per_agent = 3.0 * param_bytes_bf16 * (dsh - 1)  # AG: 1 fwd + 2 bwd
            per_agent += n_total_params * 4 * (dsh - 1)  # grad reduce-scatter fp32
            coll += per_agent * a
        # consensus (eq. 6): exchange (prec, prec*mu) fp32 across agents
        if a > 1:
            coll += 2.0 * 2.0 * n_total_params * 4 * (a - 1) / a * a
        # MoE all-to-all: k copies of each token's d-vector there and back
        if cfg.n_experts:
            coll += 2.0 * tokens * cfg.top_k * d * 2
    elif cfg.n_experts:
        coll += 2.0 * tokens * cfg.top_k * d * 2

    chips = a * dsh * msh if a > 1 else dsh * msh
    t_compute = flops / (chips * PEAK_FLOPS_BF16)
    t_memory = hbm / (chips * HBM_BW)
    t_coll = coll / (chips * ICI_BW)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    return {
        "flops_global": flops,
        "hbm_bytes_global": hbm,
        "collective_bytes_global": coll,
        "roofline_seconds": terms,
        "dominant": max(terms, key=terms.get),
        "chips": chips,
    }
