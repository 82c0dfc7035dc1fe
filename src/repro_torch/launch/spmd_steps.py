"""The language models' prefill, decode and train round over a placed
``("pod", "data", "model")`` mesh (port of the reference's sharded
execution: ``repro.launch.steps`` under ``jit`` with inputs placed by
``repro.launch.sharding``; GSPMD inserts the collectives there, this module
writes them out with ``launch.spmd``'s).  ``launch.steps``' prefill, decode
and train-round steps come here when their inputs are placed
(``spmd.device_put``), as the reference's ``jit`` reads its inputs'
shardings.

Storage follows the reference's specs (``param_shardings(...,
agent_leading=True)``, ``cache_shardings``, ``batch_pspec``).  Two schedules:

* **Pod-only** (``data`` and ``model`` of size 1): each pod position runs
  the unsharded forward, or the unsharded local step, on its agents'
  blocks.  Every block kind runs.
* **data x model > 1**: every kind (``SHARDED_KINDS``), and tied
  embeddings.  Position ``(p, d, m)`` computes for the agents of pod ``p``
  and the batch rows its token block holds (block ``d`` of B; an enc-dec
  config's frames too).  The layer loop (``_apply_block``) walks each
  period's pattern in order, each kind's stack indexed by that kind's own
  occurrence count (``models.transformer._apply_period``), then the tail
  (``apply_layer`` runs one layer alone, through the same dispatch).
  Just before use a position gathers (``spmd.gather``) what it computes
  with and no more, norm scales whole, and its tokens' embedding rows
  (``spmd.gather_rows``):

  - attention (``attn``, ``local_attn``, ``moe``): query heads ``[m H/M,
    (m+1) H/M)`` and the KV heads those use (all KV heads where
    ``n_kv_heads`` does not divide M: Granite-20B's and RecurrentGemma's
    one), the column blocks of ``wq`` / ``wk`` / ``wv`` over ``data`` and
    the head-row block of ``wo``.  ``local_attn`` takes
    ``cfg.sliding_window``; ``window_override`` applies to ``attn`` /
    ``local_attn`` and never to ``moe``.  Prefill launches
    ``flash_attention`` once a layer a position, on ``[B/data, H/M, S,
    hd]``; decode attends over the position's own cache block (plain
    ``chunked_attention``, as unsharded).  The KV cache's ``(B over data,
    KV heads over model)`` blocks, a ring of ``min(capacity, window)``
    slots for ``local_attn``, are written in place;
  - the FFN (``attn``, ``local_attn``, ``rglru``): FFN columns ``[m F/M,
    (m+1) F/M)``, the column blocks of ``w_gate`` / ``w_up`` and the F-row
    block of ``w_down``;
  - ``moe`` (``_moe``): experts ``[m E/M, (m+1) E/M)``, stored with E over
    ``model`` and D over ``data``, gathered over ``data``; the router
    whole.  The tokens are replicated over ``model`` within a data block
    and every position routes them (``models.moe.route_topk``).  Capacity
    is the agent's (``_capacity`` of its B S tokens) and an assignment's
    slot its expert's running count in token-major order over the whole
    batch, so each data block's slots begin after the counts of the blocks
    before it: an all-gather over ``data`` of the per-expert counts gives
    that exclusive prefix, and exactly the unsharded dispatch's
    assignments drop.  A position runs its experts on its block's kept
    assignments (``min(capacity, its tokens)`` slots an expert) and
    combines their contributions in float32; an all-reduce over ``model``
    of those float32 partials adds them up (``moe_counts()``: the kept and
    dropped assignments, summed on the device).  In training the
    load-balancing aux takes the expert counts and probability sums
    all-reduced over ``data`` (the agent's whole token axis);
  - ``rglru`` (``_recurrent``, the Griffin block), channel-parallel over
    ``model`` as the reference's cache spec fixes it: the position's D/M
    channels of the branch and the gate (column blocks of ``w_in`` /
    ``w_gate``), the conv on them (``conv_w``'s column block, ``conv_b``'s
    slice); ``w_r`` / ``w_i`` read every channel, so ``conv_out`` is
    all-gathered over ``model`` and the position takes their column
    blocks; the scan on its channels (its slice of ``lam_raw``) from its
    cache block ``h [B/data, D/M]`` / ``conv [B/data, 3, D/M]``, written in
    place;
  - ``mlstm`` (``_mlstm``), value-parallel as the reference's cache spec
    fixes it (``C [B, H, hd, hd]``'s value dim and ``n``'s key dim over
    ``model``): ``up``, ``q`` and ``k`` on the position's column block of
    ``w_up`` / ``wq`` / ``wk`` (``2 D/M`` columns), each all-gathered over
    ``model`` (an activation, where gathering ``wq`` / ``wk`` whole would
    move ``2 (2D)^2`` weights a layer and position every step); ``w_i`` /
    ``w_f`` whole, so ``m`` comes out alike on every model position; ``v``,
    the gate, the out-norm's scale and ``w_down``'s rows on value block
    ``m`` of every head (``_Grid.value_cols``); ``n``'s key blocks
    all-gathered at the layer's start and carried whole through the
    chunkwise scan (``models.xlstm.mlstm_scan`` on the value block); the
    out-norm over all ``2 D`` from float32 partial sums of squares
    all-reduced over ``model`` (``_out_norm``); ``C``'s value block, ``n``'s
    key block and ``m`` written in place once every position has read its
    state;
  - ``slstm`` (``_slstm``), head-parallel: channels ``[m D/M, (m+1) D/M)``,
    whole heads (the column blocks of ``w_z`` / ``w_i`` / ``w_f`` /
    ``w_o``, the head block of ``r_*``), so the sequential scan needs no
    communication; its ``c`` / ``n`` / ``h`` cache blocks, and ``m`` (whole
    on every model position) all-gathered over ``model`` once after the
    scan; the out-norm as the mLSTM's;
  - ``enc_attn`` / ``dec_attn`` (Whisper): the encoder (``_encode``) runs
    on the ``attn`` schedule, non-causal and without RoPE, from the
    position's frames plus the sinusoid, ``enc_norm``'s scale whole, so
    every model position holds its rows' encoder output; a ``dec_attn``
    layer's causal self-attention (no RoPE) over its cache block, then the
    cross-attention: the position's heads, q from the stream, k / v from
    the encoder output through ``xattn``'s column blocks, ``xattn.wo``
    row-parallel.  Prefill launches ``flash_attention`` for the encoder,
    the self- and the cross-attention; a decode step re-runs the encoder
    (the reference's step does);
  - the head: ``lm_head``'s column block over ``data``, or, with tied
    embeddings, the embedding's row region ``[m V/M, (m+1) V/M)``.

  The o-, down- and ``w_out`` projections (the xLSTM's ``w_down`` too)
  are row-parallel: an all-reduce over ``model`` (bf16 partials summed in
  float32) adds them to the residual stream.  The logits come out ``[A,
  B, T, V]``, joined over ``data`` and ``model``.  ``forward_gather_bytes``
  is the schedule's traffic as a formula.

The train round runs every route of the reference's
``make_train_round_step`` on a placed state, flat or pytree, on a pod-only
or a data x model mesh.  Eq. (6) by ``consensus_impl``:

* ``"einsum"`` (the default), at the f32, bf16 or f16 wire
  (``pod_consensus``): each ``(data, model)`` position's blocks gathered
  over ``pod``, concatenated over the leaves into ``[A, n]``, and
  ``kernels.consensus.consensus_fused_network`` run on them (one launch a
  ``(data, model)`` position, on its first pod position's device; the
  plain version on the CPU), each pod position taking its agents' rows
  back.  At a bf16 / f16 wire the kernel rounds the exchanged statistics
  and is handed W rounded through the wire, as the reference's
  ``consensus_einsum(_flat)`` rounds both;
* ``"ppermute"`` (``pod_ppermute``), bf16 unless a wire is given: each
  position mixes the blocks it holds with the rotated wire pairs of its
  neighbours along ``pod`` (``launch.consensus_opt.ring_blocks``, the
  unplaced ring's own arithmetic, so the prior is bitwise the unplaced
  ``consensus_ppermute_ring_flat`` / ``consensus_ppermute_pod``);
* ``"none"``.

The local step:

* pod-only: ``vi.bayes_by_backprop.blocked_update`` on each pod position's
  blocks, the unsharded step's own code (one agent a block where the
  unsharded step also runs one);
* data x model > 1 (a pytree state): for one agent at a time, each
  position samples its own blocks (``theta = mean + softplus(rho) eps``),
  the sharded forward runs on them (an enc-dec config's frames sliced by
  data block; plain ``chunked_attention``: ``flash_attention`` has no
  backward), the logits' column blocks are
  all-gathered over ``model`` for the NLL, the router's aux is added as
  the reference adds it (``router_aux_weight aux ntok``), the KL counts
  each distinct block once (at its first holder), and autograd runs
  through the gathers' copies and sums (a tied embedding's gradient sums
  its two uses so).  The gradient of a leaf replicated over an axis is
  all-reduced over it.  Adam then runs on each position's blocks.  The
  activations are kept (``remat`` is a memory choice that changes no bit;
  a position holds its share of them).

A flat state has the spec ``("pod", None)``: its rows are replicated over
data x model.  On a pod-only mesh it runs as above.  Under data x model it
runs as the parameter dict its rows flatten (``FlatRows``): the ppermute
ring on each position's whole row, then each position's blocks of every
leaf taken as views of its own row (nothing moves), ``pod_consensus`` and
the pytree local step on them (each position's eq. (6) on about a
``1 / (data x model)`` share of the row), and the posterior's and Adam's
rows joined again on every position, an all-gather over data x model
(``rejoin_bytes``).  So under ``"einsum"`` and ``"none"`` the round is
bitwise the placed pytree round of the same posterior.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.flat import FlatPosterior
from repro_torch.core.numerics import canonical_wire_dtype, softplus
from repro_torch.core.posterior import _leaf_kl
from repro_torch.core.tree import tree_leaves, tree_map, tree_replace_leaves
from repro_torch.launch import spmd
from repro_torch.launch.sharding import _block as narrow_block
from repro_torch.launch.sharding import (
    NamedSharding,
    batch_pspec,
    block_index,
    cache_shardings,
    join_blocks,
    param_shardings,
)
from repro_torch.optim.optimizers import apply_updates

NEXT = "ROADMAP 10i"
SHARDED_KINDS = ("attn", "local_attn", "moe", "rglru", "mlstm", "slstm", "enc_attn", "dec_attn")
_moe_tally: dict = {}  # device -> [kept, dropped] assignments, summed on that device


def moe_counts() -> dict:
    """The ``moe`` layers' kept and dropped assignments since the last
    ``reset_moe_counts`` (each assignment counted once, at the position
    holding its expert; one host sync a device)."""
    total = [0, 0]
    for t in _moe_tally.values():
        total = [x + int(y) for x, y in zip(total, t.tolist())]
    return {"kept": total[0], "dropped": total[1]}


def reset_moe_counts() -> None:
    _moe_tally.clear()


# ---------------------------------------------------------------------------
# what runs where
# ---------------------------------------------------------------------------


def mesh_of(tree):
    return next(x for x in tree_leaves(tree) if isinstance(x, spmd.Placed)).mesh


def sharded_schedule(cfg, mesh) -> bool:
    """Whether ``cfg`` runs the data x model schedule on ``mesh`` (False:
    pod-only).  Raises ``NotImplementedError`` naming ROADMAP 10i for a
    kind it does not run (none now), ``ValueError`` where heads, FFN
    columns, experts, recurrence channels, the mLSTM's width and head
    columns or the vocabulary do not split over ``model``."""
    _, dd, mm = spmd.mesh_sizes(mesh)
    if dd * mm == 1:
        return False
    kinds = set(cfg.pattern) | set(cfg.tail) | ({"enc_attn"} if cfg.is_encdec else set())
    other = sorted(kinds - set(SHARDED_KINDS))
    if other:
        raise NotImplementedError(
            f"{cfg.name}: the {', '.join(other)} block kind(s) do not run under data x model = "
            f"{dd} x {mm} yet ({NEXT}); a mesh whose data and model axes are 1 runs every kind")
    splits = [("query heads", cfg.n_heads), ("padded vocabulary", cfg.padded_vocab)]
    if kinds - {"moe", "mlstm", "slstm"}:
        splits.append(("FFN columns", cfg.d_ff))
    if "moe" in kinds:
        splits.append(("experts", cfg.n_experts))
    if kinds & {"rglru", "slstm"}:
        splits.append(("recurrence channels", cfg.d_model))
    if "mlstm" in kinds:  # p = 2 D, and each head's hd = p / H value and key columns
        splits += [("mLSTM columns", 2 * cfg.d_model),
                   ("mLSTM head columns", 2 * cfg.d_model // cfg.n_heads)]
    for what, n in splits:
        if n % mm:
            raise ValueError(f"{cfg.name}: {n} {what} do not split over the {mm}-way model axis")
    return True


def _place(x, mesh, spec_fn):
    return x if isinstance(x, spmd.Placed) else spmd.place(x, NamedSharding(mesh, spec_fn(x)))


def _place_cache(cache, mesh):
    """A decode cache placed by ``cache_shardings`` (a placed one kept;
    blocks on the cache's device are views, so writes reach it)."""
    if cache is None or spmd.is_placed(cache):
        return cache
    return spmd.device_put(cache, cache_shardings(cache, mesh))


def _place_batch(batch: dict, mesh) -> dict:
    """Every tensor of ``batch`` placed by ``batch_pspec`` (placed ones kept)."""
    return {k: None if v is None else _place(v, mesh, lambda t: batch_pspec(mesh, tuple(t.shape)))
            for k, v in batch.items()}


class _Grid:
    """The mesh, the config's local sizes and each position's coordinates."""

    def __init__(self, cfg, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.data, self.model = spmd.mesh_sizes(mesh)[1:]
        self.coords = spmd.position_coords(mesh)
        self.dt = getattr(torch, cfg.dtype)
        mm, hd, kv = self.model, cfg.hd, cfg.n_kv_heads
        self.hl = cfg.n_heads // mm  # query heads a position
        self.fl = cfg.d_ff // mm
        self.vl = cfg.padded_vocab // mm
        self.el = cfg.n_experts // mm  # experts a position
        self.dl = cfg.d_model // mm  # recurrence channels a position
        self.pl = 2 * cfg.d_model // mm  # the mLSTM's up / q / k columns a position
        self.hv = 2 * cfg.d_model // cfg.n_heads // mm  # its value columns a head a position
        if kv % mm == 0:
            self.kv_computed = kv // mm  # the position's KV block: all of it is used
            self.kv_all = False
        else:
            group = cfg.n_heads // kv
            if self.hl % group and group % self.hl:
                raise ValueError(f"{cfg.name}: {self.hl} query heads a position straddle the "
                                 f"{group}-head KV groups")
            self.kv_computed = kv
            self.kv_all = True
        self.lcfg = dataclasses.replace(cfg, n_heads=self.hl, n_kv_heads=self.kv_computed,
                                        head_dim=hd)

    def kv_cols(self, m: int) -> tuple[int, int]:
        """The ``wk`` / ``wv`` columns position model ``m`` computes."""
        hd = self.cfg.hd
        if self.kv_all:
            return 0, self.cfg.n_kv_heads * hd
        return m * self.kv_computed * hd, (m + 1) * self.kv_computed * hd

    def kv_take(self, m: int) -> slice:
        """The computed KV heads the position's query heads read."""
        if not self.kv_all:
            return slice(None)
        group = self.cfg.n_heads // self.cfg.n_kv_heads
        return slice(m * self.hl // group, ((m + 1) * self.hl - 1) // group + 1)

    def value_cols(self, m: int) -> list[tuple[int, int]]:
        """The mLSTM's columns of ``p = 2 D`` position model ``m``
        computes: value block ``m`` of every head, ``[h hd + m hd/M, h hd
        + (m+1) hd/M)`` in head order (``C``'s value block)."""
        hd = self.hv * self.model
        return [(h * hd + m * self.hv, h * hd + (m + 1) * self.hv)
                for h in range(self.cfg.n_heads)]

    def window(self, kind: str, override) -> int:
        """The attention window of ``kind`` (``block_apply``'s rule)."""
        if override is not None and kind in ("attn", "local_attn"):
            return override
        return self.cfg.sliding_window if kind == "local_attn" else 0


def _w(leaf, i, lead, *ranges):
    """Position ``i``'s gather of ``leaf`` at the layer index ``lead``
    (one entry a leading dim), ``ranges`` over the dims after it."""
    out = spmd.gather(leaf, i, tuple((x, x + 1) for x in lead) + ranges)
    return out.reshape(out.shape[len(lead):])


def _w_parts(leaf, i, lead, parts, dim):
    """Position ``i``'s gathers of ``leaf`` at ``lead``, one for each
    ``(start, stop)`` of ``parts`` along body dim ``dim`` (whole elsewhere),
    concatenated along it."""
    return torch.cat([_w(leaf, i, lead, *(None,) * dim, r) for r in parts], dim)


def _cols(m: int, n: int) -> tuple[int, int]:
    """Block ``m`` of size ``n``."""
    return m * n, (m + 1) * n


def _layers(cfg, params_a, caches_a):
    """(kind, its params, layer index, its cache) of every layer in order:
    each period's pattern, each kind's stack at that kind's own occurrence
    count, then the tail."""
    out = []
    for p in range(cfg.n_periods):
        seen: dict[str, int] = {}
        for kind in cfg.pattern:
            o = seen.get(kind, 0)
            seen[kind] = o + 1
            out.append((kind, params_a["stacks"][kind], (p, o),
                        None if caches_a is None else caches_a["stacks"][kind]))
    for t, kind in enumerate(cfg.tail):
        out.append((kind, params_a["tail"][t], (),
                    None if caches_a is None else caches_a["tail"][t]))
    return out


# ---------------------------------------------------------------------------
# the data x model forward of one agent
# ---------------------------------------------------------------------------


def _attention(grid, ap, lead, i, m, h, positions, cache, window, causal=True, use_rope=True,
               cross=None):
    """Position ``i``'s attention (model index ``m``): its query heads over
    the KV heads they read (of ``cross [rows, F, D]``, the encoder's
    output, when given: no mask, no cache), out ``[..., S, H/M * hd]``
    before ``wo``; ``models.attention.attention_block``'s routes."""
    from repro_torch.models import attention as att

    hd = grid.cfg.hd
    local = {"wq": _w(ap["wq"], i, lead, None, _cols(m, grid.hl * hd))}
    for name in ("wk", "wv"):
        local[name] = _w(ap[name], i, lead, None, grid.kv_cols(m))
    for name in ("q_norm", "k_norm"):
        if name in ap:
            local[name] = {"scale": _w(ap[name]["scale"], i, lead)}
    q, k, v = att.attention_qkv(local, h, grid.lcfg, positions, cross, use_rope)
    take = grid.kv_take(m)
    if cache is not None and h.shape[-2] == 1:
        att.cache_update(cache, k, v, positions[:1])
        kd, vd = att.cache_read_kv(cache, h.dtype)
        out = att.chunked_attention(q, kd[..., take, :], vd[..., take, :], causal=True,
                                    window=window, q_offset=positions[0],
                                    k_valid=cache["pos"] >= 0, k_positions=cache["pos"],
                                    chunk_size=kd.shape[-3])
    else:
        if cache is not None:
            att._prefill_cache(cache, k, v, positions)
        k, v = k[..., take, :], v[..., take, :]
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            out = att.chunked_attention(q, k, v, causal=causal, window=window)
        elif not causal and h.shape[-2] == 1:  # a decode step's one query row a head
            out = att.chunked_attention(q, k, v, causal=False, chunk_size=k.shape[-3])
        elif not causal:
            out = att.kernel_attention_full(q, att._repeat_kv(k, grid.hl),
                                            att._repeat_kv(v, grid.hl))
        else:
            out = att.kernel_attention(q, att._repeat_kv(k, grid.hl), att._repeat_kv(v, grid.hl),
                                       causal=True, window=window)
    return out.reshape(tuple(h.shape[:-1]) + (grid.hl * hd,))


def _cache_at(caches, i, lead):
    return None if caches is None else {k: v.blocks[i][lead] for k, v in caches.items()}


def _attention_half(grid, lp, lead, x: dict, members, positions, caches, window, *,
                    causal=True, use_rope=True, norm="norm1", attn="attn", cross=None):
    """The attention half of an attention block: ``x {i: [rows, S, D]}``
    -> ``x + wo(attention)``, ``wo`` row-parallel, all-reduced over
    ``model``.  ``norm`` / ``attn`` name the half's leaves (a ``dec_attn``
    block's cross-attention: ``norm_x`` / ``xattn`` over ``cross {i:
    [rows, F, D]}``)."""
    from repro_torch.models.modules import matmul, rmsnorm

    cfg, dt = grid.cfg, grid.dt
    part = {}
    for i, m in members:
        h = rmsnorm({"scale": _w(lp[norm]["scale"], i, lead)}, x[i], cfg.norm_eps)
        out = _attention(grid, lp[attn], lead, i, m, h, positions[i], _cache_at(caches, i, lead),
                         window, causal, use_rope, None if cross is None else cross[i])
        wo = _w(lp[attn]["wo"], i, lead, _cols(m, grid.hl * cfg.hd), None)
        part[i] = matmul(out, wo.to(dt))
    y = spmd.all_reduce(part, grid.mesh, "model")
    return {i: x[i] + y[i] for i in x}


def _ffn(grid, lp, lead, x: dict, members):
    """``norm2`` and the SwiGLU FFN over FFN columns ``[m F/M, (m+1) F/M)``,
    ``w_down`` row-parallel, all-reduced over ``model``."""
    from repro_torch.models.modules import rmsnorm, swiglu

    cfg, dt = grid.cfg, grid.dt
    part = {}
    for i, m in members:
        h2 = rmsnorm({"scale": _w(lp["norm2"]["scale"], i, lead)}, x[i], cfg.norm_eps)
        f, mlp = _cols(m, grid.fl), lp["mlp"]
        part[i] = swiglu({"w_gate": _w(mlp["w_gate"], i, lead, None, f),
                          "w_up": _w(mlp["w_up"], i, lead, None, f),
                          "w_down": _w(mlp["w_down"], i, lead, f, None)}, h2, dt)
    y = spmd.all_reduce(part, grid.mesh, "model")
    return {i: x[i] + y[i] for i in x}


def _moe(grid, lp, lead, x: dict, members, n_tokens: int, row_blocks: int, aux: dict | None):
    """``norm2`` and the MoE FFN (module docstring): ``n_tokens`` the
    agent's B S tokens, ``row_blocks`` the batch's blocks over ``data`` (1:
    every data position holds every row).  With ``aux`` (a dict), each
    position's load-balancing loss of the layer is added to ``aux[i]``."""
    import torch.nn.functional as F

    from repro_torch.models import moe as moe_lib
    from repro_torch.models.modules import rmsnorm

    cfg, dt = grid.cfg, grid.dt
    e, k, el = cfg.n_experts, cfg.top_k, grid.el
    cap = moe_lib._capacity(n_tokens, e, k, cfg.capacity_factor)
    mp = lp["moe"]
    routed, counts, stats = {}, {}, {}
    for i, m in members:
        h2 = rmsnorm({"scale": _w(lp["norm2"]["scale"], i, lead)}, x[i], cfg.norm_eps)
        ht = h2.reshape(-1, h2.shape[-1])  # [T_local, D], token-major
        weights, idx, probs = moe_lib.route_topk(ht @ _w(mp["router"], i, lead).to(dt), k)
        expert_of = idx.reshape(-1)  # [T_local k]
        own = (expert_of >= m * el) & (expert_of < (m + 1) * el)
        le = torch.where(own, expert_of - m * el, 0)
        hot = F.one_hot(le, el) * own[:, None]  # [T_local k, E/M]
        routed[i] = (ht, weights, expert_of, probs, le, own, torch.cumsum(hot, 0))
        counts[i] = hot.sum(0, dtype=torch.int32)[None]
    # each data block's slots start after the counts of the blocks before it
    prefix = {i: torch.zeros_like(c[0]) for i, c in counts.items()}
    if row_blocks > 1:
        every = spmd.all_gather(counts, grid.mesh, "data", 0)
        prefix = {i: every[i][:grid.coords[i][1]].sum(0) for i in counts}
    part = {}
    for i, m in members:
        ht, weights, expert_of, probs, le, own, running = routed.pop(i)
        t, d = ht.shape
        local = torch.gather(running, 1, le[:, None])[:, 0] - 1  # slot within the block's run
        keep = own & (local + prefix[i][le] < cap)
        tally = torch.stack([keep.sum(), (own & ~keep).sum()])
        _moe_tally[tally.device] = _moe_tally.get(tally.device, 0) + tally
        cl = min(cap, t)  # a block's kept slots an expert: at most one a token
        token_of = torch.arange(t, device=ht.device).repeat_interleave(k)
        cell = torch.where(keep, le * cl + local, el * cl)
        slots = torch.zeros(el * cl + 1, dtype=torch.long, device=ht.device)
        slots.scatter_(0, cell, torch.where(keep, token_of + 1, 0))
        xt_pad = torch.cat([ht.new_zeros((1, d)), ht])
        x_disp = xt_pad[slots[:el * cl]].reshape(el, cl, d)
        experts = _cols(m, el)
        g = torch.matmul(x_disp, _w(mp["w_gate"], i, lead, experts, None, None).to(dt))
        u = torch.matmul(x_disp, _w(mp["w_up"], i, lead, experts, None, None).to(dt))
        del x_disp
        yd = torch.matmul(F.silu(g) * u, _w(mp["w_down"], i, lead, experts, None, None).to(dt))
        del g, u
        src = torch.where(keep, le * cl + local, 0)
        contrib = torch.where(keep[:, None], yd.reshape(el * cl, d)[src].float()
                              * weights.reshape(-1)[:, None], 0.0).reshape(t, k, d)
        out = contrib[:, 0]
        for j in range(1, k):
            out = out + contrib[:, j]
        part[i] = out.reshape(x[i].shape)
        if aux is not None:  # the block's expert counts and probability sums
            stats[i] = torch.stack([F.one_hot(expert_of, e).sum(0).float(), probs.sum(0)])
    y = spmd.all_reduce(part, grid.mesh, "model")  # float32 partials
    x = {i: x[i] + y[i].to(dt) for i in x}
    if aux is not None:
        if row_blocks > 1:  # over the agent's whole token axis
            stats = spmd.all_reduce(stats, grid.mesh, "data")
        for i in aux:  # models.moe.load_balance_loss
            frac, mean_prob = stats[i][0] / (n_tokens * k), stats[i][1] / n_tokens
            aux[i] = aux[i] + e * torch.sum(frac * mean_prob)
    return x


def _recurrent(grid, rp, lead, x: dict, members, caches):
    """The Griffin recurrent block (``models.rglru.rglru_block``) over
    channels ``[m D/M, (m+1) D/M)`` a position (module docstring); its
    state written into the position's cache block in place."""
    import torch.nn.functional as F

    from repro_torch.models import rglru as rg
    from repro_torch.models.modules import matmul, rmsnorm

    cfg, dt = grid.cfg, grid.dt
    local, conv = {}, {}
    for i, m in members:
        c = _cols(m, grid.dl)
        xin = rmsnorm({"scale": _w(rp["norm"]["scale"], i, lead)}, x[i], cfg.norm_eps)
        branch = matmul(xin, _w(rp["w_in"], i, lead, None, c).to(dt))
        gate = F.gelu(matmul(xin, _w(rp["w_gate"], i, lead, None, c).to(dt)), approximate="tanh")
        state = _cache_at(caches, i, lead)
        if state is None:
            rows = x[i].shape[:-2]
            state = {"h": torch.zeros(rows + (grid.dl,), device=x[i].device),
                     "conv": torch.zeros(rows + (rg.CONV_WIDTH - 1, grid.dl), device=x[i].device)}
        conv[i], hist = rg.causal_conv1d(branch, _w(rp["conv_w"], i, lead, None, c),
                                         _w(rp["conv_b"], i, lead, c), state["conv"])
        local[i] = (c, gate, state, hist)
    every = spmd.all_gather(conv, grid.mesh, "model", -1)  # w_r, w_i read every channel
    part = {}
    for i, m in members:
        c, gate, state, hist = local.pop(i)
        r = torch.sigmoid(matmul(every[i], _w(rp["w_r"], i, lead, None, c).to(dt)))
        ig = torch.sigmoid(matmul(every[i], _w(rp["w_i"], i, lead, None, c).to(dt)))
        hs, h_last = rg.rglru_scan(conv[i], r, ig, _w(rp["lam_raw"], i, lead, c), state["h"])
        part[i] = matmul(hs.to(dt) * gate, _w(rp["w_out"], i, lead, c, None).to(dt))
        if caches is not None:
            state["h"].copy_(h_last)
            state["conv"].copy_(hist)
    y = spmd.all_reduce(part, grid.mesh, "model")
    return {i: x[i] + y[i] for i in x}


def _out_norm(grid, hs: dict, scale_of, members, width: int) -> dict:
    """An RMS norm over ``width`` channels of which each position holds a
    block ``hs[i]``: float32 partial sums of squares all-reduced over
    ``model``, then the scale's slice ``scale_of(i, m)`` (``rmsnorm``'s
    numerics, the sum in another order)."""
    sq = spmd.all_reduce({i: torch.sum(torch.square(hs[i].float()), -1, keepdim=True)
                          for i, _ in members}, grid.mesh, "model")
    return {i: (hs[i].float() * torch.rsqrt(sq[i] / width + grid.cfg.norm_eps)
                * scale_of(i, m).float()).to(hs[i].dtype) for i, m in members}


def _mlstm(grid, lp, lead, x: dict, members, caches):
    """The mLSTM block (``models.xlstm.mlstm_block``), value-parallel over
    ``model`` as the reference's cache spec fixes it (module docstring);
    its state written into the position's cache blocks in place once
    every position has read its own."""
    import torch.nn.functional as F

    from repro_torch.models import xlstm as xl
    from repro_torch.models.modules import matmul, rmsnorm

    cfg, dt, mesh = grid.cfg, grid.dt, grid.mesh
    nh, p, hv = cfg.n_heads, 2 * cfg.d_model, grid.hv
    hd = p // nh
    xin, up = {}, {}
    for i, m in members:
        xin[i] = rmsnorm({"scale": _w(lp["norm"]["scale"], i, lead)}, x[i], cfg.norm_eps)
        up[i] = matmul(xin[i], _w(lp["w_up"], i, lead, None, _cols(m, grid.pl)).to(dt))
    up = spmd.all_gather(up, mesh, "model", -1)  # every projection below reads all of it
    q, k = {}, {}
    for i, m in members:
        q[i] = matmul(up[i], _w(lp["wq"], i, lead, None, _cols(m, grid.pl)).to(dt))
        k[i] = matmul(up[i], _w(lp["wk"], i, lead, None, _cols(m, grid.pl)).to(dt))
    q, k = spmd.all_gather(q, mesh, "model", -1), spmd.all_gather(k, mesh, "model", -1)
    n_whole = None
    if caches is not None:  # n's key blocks: q . n needs the whole key dim
        n_whole = spmd.all_gather({i: caches["n"].blocks[i][lead] for i, _ in members}, mesh,
                                  "model", -1)
    hs, gate, new = {}, {}, {}
    for i, m in members:
        rows = tuple(x[i].shape[:-1])
        parts = grid.value_cols(m)
        v = matmul(up[i], _w_parts(lp["wv"], i, lead, parts, 1).to(dt))
        ig = matmul(up[i], _w(lp["w_i"], i, lead).to(dt))  # whole: m alike on every position
        fg = matmul(up[i], _w(lp["w_f"], i, lead).to(dt))
        gate[i] = F.silu(matmul(xin.pop(i), _w_parts(lp["w_gate"], i, lead, parts, 1).to(dt)))
        if caches is None:
            state = {"C": torch.zeros(rows[:-1] + (nh, hd, hv), device=x[i].device),
                     "n": torch.zeros(rows[:-1] + (nh, hd), device=x[i].device),
                     "m": torch.full(rows[:-1] + (nh,), xl.NEG_INIT, device=x[i].device)}
        else:
            state = {"C": caches["C"].blocks[i][lead], "n": n_whole[i],
                     "m": caches["m"].blocks[i][lead]}
        # the reference divides by sqrt(hd) rounded to the compute dtype
        root = torch.tensor(math.sqrt(hd), dtype=torch.float32, device=x[i].device).to(dt)
        out, new[i] = xl.mlstm_scan(q[i].reshape(rows + (nh, hd)),
                                    k[i].reshape(rows + (nh, hd)) / root,
                                    v.reshape(rows + (nh, hv)), ig, fg, state)
        hs[i] = out.reshape(rows + (nh * hv,))
    hs = _out_norm(grid, hs, lambda i, m: _w_parts(lp["out_norm"]["scale"], i, lead,
                                                   grid.value_cols(m), 0), members, p)
    part = {}
    for i, m in members:
        w_down = _w_parts(lp["w_down"], i, lead, grid.value_cols(m), 0)
        part[i] = matmul(hs.pop(i) * gate.pop(i), w_down.to(dt))
    if caches is not None:  # m is alike on every model position: each writes its copy
        for i, m in members:
            blk = {name: leaf.blocks[i][lead] for name, leaf in caches.items()}
            blk["C"].copy_(new[i]["C"])
            blk["n"].copy_(new[i]["n"][..., slice(*_cols(m, hv))])
            blk["m"].copy_(new[i]["m"])
    y = spmd.all_reduce(part, mesh, "model")
    return {i: x[i] + y[i] for i in x}


def _slstm(grid, lp, lead, x: dict, members, caches):
    """The sLSTM block (``models.xlstm.slstm_block``), head-parallel over
    ``model``: channels ``[m D/M, (m+1) D/M)`` (whole heads) a position,
    so the sequential scan needs no communication; ``m`` (whole on every
    model position) all-gathered once after the scan and written whole."""
    from repro_torch.models import xlstm as xl
    from repro_torch.models.modules import matmul, rmsnorm

    cfg, dt, mesh = grid.cfg, grid.dt, grid.mesh
    hl = cfg.n_heads // grid.model
    hs, new = {}, {}
    for i, m in members:
        c = _cols(m, grid.dl)
        xin = rmsnorm({"scale": _w(lp["norm"]["scale"], i, lead)}, x[i], cfg.norm_eps)
        xz, xi, xf, xo = (matmul(xin, _w(lp[name], i, lead, None, c).to(dt))
                          for name in ("w_z", "w_i", "w_f", "w_o"))
        rec = {f"r_{g}": _w(lp[f"r_{g}"], i, lead, _cols(m, hl)) for g in "zifo"}
        if caches is None:
            shape = tuple(x[i].shape[:-2]) + (grid.dl,)
            state = {name: torch.zeros(shape, device=x[i].device) for name in "cnh"}
            state["m"] = torch.full(shape, xl.NEG_INIT, device=x[i].device)
        else:
            state = {name: leaf.blocks[i][lead] for name, leaf in caches.items()}
            state["m"] = state["m"][..., slice(*c)]
        out, new[i] = xl.slstm_scan(rec, xz, xi, xf, xo, state, hl)
        hs[i] = out.to(dt)
    hs = _out_norm(grid, hs, lambda i, m: _w(lp["out_norm"]["scale"], i, lead,
                                             _cols(m, grid.dl)), members, cfg.d_model)
    part = {i: matmul(hs.pop(i), _w(lp["w_down"], i, lead, _cols(m, grid.dl), None).to(dt))
            for i, m in members}
    if caches is not None:
        m_whole = spmd.all_gather({i: new[i]["m"] for i, _ in members}, mesh, "model", -1)
        for i, _ in members:
            blk = {name: leaf.blocks[i][lead] for name, leaf in caches.items()}
            for name in "cnh":
                blk[name].copy_(new[i][name])
            blk["m"].copy_(m_whole[i])
    y = spmd.all_reduce(part, mesh, "model")
    return {i: x[i] + y[i] for i in x}


def _encode(grid, params_a, frames: dict, members) -> dict:
    """The encoder (``models.transformer.encode``): ``frames {i: [rows, F,
    D]}`` plus the sinusoid, ``encoder_layers`` non-causal ``enc_attn``
    blocks on the ``attn`` schedule without RoPE, then ``enc_norm`` (its
    scale whole): ``{i: [rows, F, D]}``, alike over ``model``."""
    from repro_torch.models.modules import rmsnorm
    from repro_torch.models.transformer import _sinusoidal

    cfg, dt = grid.cfg, grid.dt
    x, fpos = {}, {}
    for i, _ in members:
        fpos[i] = torch.arange(frames[i].shape[-2], device=frames[i].device)
        x[i] = frames[i].to(dt) + _sinusoidal(fpos[i], cfg.d_model).to(dt)
    for layer in range(cfg.encoder_layers):
        x = _apply_block(grid, "enc_attn", params_a["enc_stack"], (layer, 0), x, members, fpos,
                         None)
    return {i: rmsnorm({"scale": _w(params_a["enc_norm"]["scale"], i, ())}, x[i], cfg.norm_eps)
            for i, _ in members}


def _apply_block(grid, kind, lp, lead, x: dict, members, positions, caches, *,
                 window_override=None, enc_out=None, n_tokens=0, row_blocks=1,
                 aux=None) -> dict:
    """One layer of ``kind`` (``models.transformer.block_apply``) on every
    position holding the agent: ``x {i: [rows, S, D]}`` -> the same, its
    cache (``caches``, the kind's placed leaves, or ``None``) written in
    place.  ``enc_out``: a ``dec_attn`` block's cross-attended encoder
    output; ``n_tokens``, ``row_blocks``, ``aux``: ``_moe``'s."""
    if kind == "mlstm":
        return _mlstm(grid, lp, lead, x, members, caches)
    if kind == "slstm":
        return _slstm(grid, lp, lead, x, members, caches)
    if kind == "rglru":
        x = _recurrent(grid, lp["rec"], lead, x, members, caches)
    else:
        encdec = kind in ("enc_attn", "dec_attn")
        x = _attention_half(grid, lp, lead, x, members, positions, caches,
                            grid.window(kind, window_override), causal=kind != "enc_attn",
                            use_rope=not encdec)
        if kind == "dec_attn":
            x = _attention_half(grid, lp, lead, x, members, positions, None, 0, causal=False,
                                use_rope=False, norm="norm_x", attn="xattn", cross=enc_out)
    if kind == "moe":
        return _moe(grid, lp, lead, x, members, n_tokens, row_blocks, aux)
    return _ffn(grid, lp, lead, x, members)


def _members(grid, params_a):
    """(position, model index) of each position holding the agent."""
    emb = params_a["embed"]["emb"]
    return [(i, grid.coords[i][2]) for i, blk in enumerate(emb.blocks) if blk is not None]


def _forward(grid, params_a, tokens: dict, row_blocks: int, *, positions=None, caches_a=None,
             patches=None, frames=None, logits_tail=0, window_override=None, with_aux=False):
    """One agent's forward over its pod's positions: ``params_a`` its
    placed weights (``Placed.agent``), ``tokens {i: [rows, S]}`` (the
    batch in ``row_blocks`` blocks over ``data``), ``caches_a`` its placed
    cache or ``None``, ``patches {i: [rows, P, D]}``, ``frames {i: [rows,
    F, D]}`` (an enc-dec config's: the encoder runs over them on every
    call).  Returns the logits' column blocks ``{i: [rows, T, V/M]}``
    (float32) and, ``with_aux``, each position's router aux (``{i: 0-d}``,
    the agent's, alike on every position; ``None`` otherwise)."""
    from repro_torch.models.modules import matmul, rmsnorm
    from repro_torch.models.transformer import _sinusoidal

    cfg, dt = grid.cfg, grid.dt
    members = _members(grid, params_a)
    enc_out = None
    if cfg.is_encdec:
        if frames is None:
            raise ValueError(f"{cfg.name}: an enc-dec model needs frame embeddings")
        enc_out = _encode(grid, params_a, frames, members)
    emb = params_a["embed"]["emb"]
    x = {}
    for i, _ in members:
        x[i] = spmd.gather_rows(emb, i, tokens[i]).to(dt)
        if patches is not None:
            proj = _w(params_a["patch_proj"]["w"], i, ()).to(dt)
            x[i] = torch.cat([matmul(patches[i].to(dt), proj), x[i]], dim=-2)
    if positions is None:
        positions = {i: torch.arange(x[i].shape[-2], device=x[i].device) for i in x}
    if cfg.is_encdec:
        x = {i: x[i] + _sinusoidal(positions[i], cfg.d_model).to(dt) for i in x}
    n_tokens = row_blocks * x[members[0][0]].shape[:-1].numel()  # the agent's B S
    aux = {i: torch.zeros((), device=x[i].device) for i in x} if with_aux else None
    for kind, lp, lead, caches in _layers(cfg, params_a, caches_a):
        x = _apply_block(grid, kind, lp, lead, x, members, positions, caches,
                         window_override=window_override, enc_out=enc_out, n_tokens=n_tokens,
                         row_blocks=row_blocks, aux=aux)
    logits = {}
    for i, m in members:
        xi = x[i][..., -logits_tail:, :] if logits_tail else x[i]
        xi = rmsnorm({"scale": _w(params_a["final_norm"]["scale"], i, ())}, xi, cfg.norm_eps)
        v = _cols(m, grid.vl)
        if cfg.tie_embeddings:
            w = _w(emb, i, (), v, None).to(dt).transpose(-1, -2)
        else:
            w = _w(params_a["lm_head"]["w"], i, (), None, v).to(dt)
        logits[i] = matmul(xi, w).float()
    return logits, aux


def _row_blocks(tokens_a) -> int:
    """The blocks one agent's batch rows take over ``data``."""
    return tokens_a.grid()[0]


def _agent_blocks(x, a):
    """Agent ``a``'s blocks ``{i: block}`` of a placed batch leaf (``None``
    for none)."""
    return None if x is None else {i: b for i, b in enumerate(x.agent(a).blocks) if b is not None}


def _per_agent(params, cache, batch: dict, step) -> list:
    """``step(params_a, caches_a, blocks, row_blocks)`` for each agent a
    over its pod's positions (``blocks``: each placed leaf of ``batch`` as
    ``{i: block}`` of the agent's rows, ``None`` for none; ``row_blocks``
    the blocks its rows take over ``data``; it returns ``{i: [rows,
    ...]}``): each position's outputs stacked over its pod's agents, a list
    in position order."""
    lead = batch["tokens"]
    per_pos: list[list] = [[] for _ in lead.blocks]
    for a in range(lead.shape[0]):
        params_a = tree_map(lambda leaf: leaf.agent(a), params)
        caches_a = None if cache is None else tree_map(lambda leaf: leaf.agent(a), cache)
        blocks = {k: _agent_blocks(v, a) for k, v in batch.items()}
        for i, y in step(params_a, caches_a, blocks, _row_blocks(lead.agent(a))).items():
            per_pos[i].append(y)
    return [torch.stack(ys) for ys in per_pos]


def _serve(cfg, params, tokens, cache, *, patches=None, frames=None, position=None,
           logits_tail=0, window_override=None):
    """The data x model prefill (``position`` None) or decode step:
    (logits ``[A, B, T, V]`` on the first position's device, cache)."""
    grid = _Grid(cfg, tokens.mesh)

    def step(params_a, caches_a, blk, row_blocks):
        positions = None
        if position is not None:
            positions = {i: torch.as_tensor(position).reshape(1).to(device=b.device,
                                                                    dtype=torch.long)
                         for i, b in blk["tokens"].items()}
        return _forward(grid, params_a, blk["tokens"], row_blocks, positions=positions,
                        caches_a=caches_a, patches=blk["patches"], frames=blk["frames"],
                        logits_tail=logits_tail, window_override=window_override)[0]

    blocks = _per_agent(params, cache, {"tokens": tokens, "patches": patches, "frames": frames},
                        step)
    spec = tuple(tokens.sharding.spec)[:2] + (None, "model" if grid.model > 1 else None)
    return join_blocks(blocks, NamedSharding(grid.mesh, spec)), cache


def apply_layer(cfg, params, cache, layer: int, x, positions, enc_out=None):
    """Layer ``layer`` of the model alone, on the schedule ``prefill`` and
    ``decode`` run it (``_forward``'s layer step at that depth): ``x [A,
    B, T, D]`` the layer's input (a tensor, placed here as a batch is),
    ``positions [T]`` its token positions, ``cache`` placed (the layer's
    blocks written in place, as a step writes them) or ``None``;
    ``enc_out [A, B, F, D]`` a ``dec_attn`` layer's encoder output.
    Returns the layer's output ``[A, B, T, D]`` on the first position's
    device."""
    mesh = mesh_of(params)
    grid = _Grid(cfg, mesh)
    batch = _place_batch({"tokens": x, "enc_out": enc_out}, mesh)
    cache = _place_cache(cache, mesh)

    def step(params_a, caches_a, blk, row_blocks):
        xs = blk["tokens"]
        kind, lp, lead, caches = _layers(cfg, params_a, caches_a)[layer]
        n_tokens = row_blocks * next(iter(xs.values())).shape[:-1].numel()
        return _apply_block(grid, kind, lp, lead, xs, _members(grid, params_a),
                            {i: positions.to(b.device) for i, b in xs.items()}, caches,
                            enc_out=blk["enc_out"], n_tokens=n_tokens, row_blocks=row_blocks)

    spec = tuple(batch["tokens"].sharding.spec)[:2] + (None, None)
    return join_blocks(_per_agent(params, cache, batch, step), NamedSharding(mesh, spec))


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def prefill(cfg, params, batch: dict, cache, window_override=None):
    """``launch.steps.make_prefill_step`` on placed inputs."""
    mesh = mesh_of(params)
    batch, cache = _place_batch(batch, mesh), _place_cache(cache, mesh)
    if not sharded_schedule(cfg, mesh):
        from repro_torch.models import forward

        blocks = []
        for i in range(mesh.size):
            lg, _, _ = forward(spmd.blocks_at(params, i), cfg, batch["tokens"].blocks[i],
                               cache=None if cache is None else spmd.blocks_at(cache, i),
                               frames=_block(batch.get("frames"), i),
                               patches=_block(batch.get("patches"), i), logits_tail=1,
                               window_override=window_override)
            blocks.append(lg)
        return _join_pods(blocks, batch["tokens"]), cache
    return _serve(cfg, params, batch["tokens"], cache, patches=batch.get("patches"),
                  frames=batch.get("frames"), logits_tail=1, window_override=window_override)


def decode(cfg, params, token, position, cache, frames=None, window_override=None):
    """``launch.steps.make_decode_step`` on placed inputs."""
    mesh = mesh_of(params)
    token, cache = _place_batch({"t": token}, mesh)["t"], _place_cache(cache, mesh)
    frames = None if frames is None else _place_batch({"f": frames}, mesh)["f"]
    if not sharded_schedule(cfg, mesh):
        from repro_torch.models import decode_step

        blocks = [decode_step(spmd.blocks_at(params, i), cfg, token.blocks[i], position,
                              spmd.blocks_at(cache, i), enc_out_frames=_block(frames, i),
                              window_override=window_override)[0] for i in range(mesh.size)]
        return _join_pods(blocks, token), cache
    return _serve(cfg, params, token, cache, frames=frames, position=position,
                  window_override=window_override)


def _block(x, i):
    return None if x is None else x.blocks[i]


def _join_pods(blocks, tokens):
    """Pod-only outputs ``[A/pods, B, ...]`` joined on the agent axis."""
    spec = (tuple(tokens.sharding.spec) + (None,) * 4)[:blocks[0].ndim]
    return join_blocks(blocks, NamedSharding(tokens.mesh, spec))


def pod_consensus(post, W, wire_dtype=None):
    """Eq. (6) over ``pod`` on a placed posterior (flat or pytree): for each
    ``(data, model)`` position, its leaf blocks concatenated into one row
    block a pod position, gathered into ``[A, n]`` on the first pod
    position's device, ``consensus_fused_network`` once, and each pod
    position's rows copied back and split into its blocks.  At a bf16 / f16
    ``wire_dtype`` the kernel rounds the statistics and is handed W rounded
    through the wire too, as the reference's ``consensus_einsum`` rounds
    both."""
    from repro_torch.kernels.consensus import consensus_fused_network

    means, rhos = tree_leaves(post.mean), tree_leaves(post.rho)
    mesh = means[0].mesh
    wd = canonical_wire_dtype(wire_dtype)
    W = torch.as_tensor(W, dtype=torch.float32).to(wd).to(torch.float32)
    new = [[None] * mesh.size for _ in range(len(means) + len(rhos))]
    for group in spmd.axis_groups(mesh, "pod", range(mesh.size)):
        root = means[0].blocks[group[0]].device

        def rows(leaves, j):
            return torch.cat([x.blocks[j].reshape(x.blocks[j].shape[0], -1) for x in leaves], 1)

        m_rows = [rows(means, j) for j in group]
        r_rows = [rows(rhos, j) for j in group]
        per = m_rows[0].shape[0]
        nm, nr = consensus_fused_network(
            W.to(root), torch.cat([x.to(root) for x in m_rows]).contiguous(),
            torch.cat([x.to(root) for x in r_rows]).contiguous(), wire_dtype=wd)
        # in: the other pods' mean and rho row blocks; out: their new rows
        spmd.record("all_gather",
                    4 * (len(group) - 1) * m_rows[0].numel() * m_rows[0].element_size())
        for r, j in enumerate(group):
            dev = means[0].blocks[j].device
            for leaves, out, base in ((means, nm, 0), (rhos, nr, len(means))):
                col = 0
                for k, x in enumerate(leaves):
                    blk = x.blocks[j]
                    n = blk[0].numel()
                    new[base + k][j] = out[r * per:(r + 1) * per, col:col + n].to(dev).reshape(
                        blk.shape)
                    col += n
    leaves = [spmd.Placed(x.sharding, blocks, x.shape, x.dtype)
              for x, blocks in zip(means + rhos, new)]
    return dataclasses.replace(post, mean=tree_replace_leaves(post.mean, leaves[:len(means)]),
                               rho=tree_replace_leaves(post.rho, leaves[len(means):]))


def pod_ppermute(post, W, wire_dtype):
    """The ppermute consensus on a placed posterior, each position on the
    blocks it holds (``launch.consensus_opt.ring_blocks`` around ``pod``,
    W's row of its pod): a flat state's rows as
    ``consensus_ppermute_ring_flat`` mixes them (both ring directions, over
    the axis of the rows' spec), a pytree's leaves as
    ``consensus_ppermute_pod`` (one direction for two pods).  A row or leaf
    replicated over ``data`` x ``model`` is mixed on every position holding
    it, as each device of the reference's ``shard_map`` mixes its own."""
    from repro_torch.launch import consensus_opt as co

    flat = isinstance(post, FlatPosterior)
    means, rhos = tree_leaves(post.mean), tree_leaves(post.rho)
    mesh = means[0].mesh
    axis = (means[0].sharding.spec[0] if flat else None) or "pod"
    n = mesh.shape[axis]
    index, peer = co.axis_peers(mesh, axis)
    out_m, out_r = [], []
    for m, r in zip(means, rhos):
        out = co.ring_blocks(list(zip(m.blocks, r.blocks)), index, peer, n,
                             canonical_wire_dtype(wire_dtype), co.row_weights(W, n),
                             both_ways=flat)
        out_m.append(spmd.Placed(m.sharding, [x for x, _ in out], m.shape, m.dtype))
        out_r.append(spmd.Placed(r.sharding, [x for _, x in out], r.shape, r.dtype))
    return dataclasses.replace(post, mean=tree_replace_leaves(post.mean, out_m),
                               rho=tree_replace_leaves(post.rho, out_r))


class FlatRows:
    """A flat state's placed ``[A, P]`` rows (spec ``("pod", None)``:
    replicated over ``data`` x ``model``) seen as the parameter dict they
    flatten, under that dict's ``param_shardings``: ``tree`` gives each
    position its block of every leaf as a view of its own row (nothing
    moves); ``rows`` joins the blocks of such a tree back into a whole row
    on every position, an all-gather over ``data`` x ``model``."""

    def __init__(self, layout, rows: spmd.Placed):
        self.layout, self.mesh = layout, rows.mesh
        self.sharding, self.shape = rows.sharding, rows.shape
        self.skeleton = layout.unflatten(torch.empty(rows.shape, device="meta"))
        self.shardings = tree_leaves(param_shardings(self.skeleton, self.mesh,
                                                     agent_leading=True))
        self.positions = list(self.mesh.positions())

    def _block(self, x, spec, i):
        """Position ``i``'s block of ``x``, one pod's rows of a leaf."""
        return narrow_block(x, ((0, 1),) + block_index(spec, self.mesh, self.positions[i])[1:])

    def _leaf(self, row, spec):
        return row[:, spec.offset:spec.offset + spec.size].view(row.shape[0], *spec.shape)

    def tree(self, rows: spmd.Placed):
        """``rows`` as the placed parameter dict (views of each position's row)."""
        leaves = []
        for spec, sh in zip(self.layout.specs, self.shardings):
            blocks = [self._block(self._leaf(row, spec), sh.spec, i)
                      for i, row in enumerate(rows.blocks)]
            leaves.append(spmd.Placed(sh, blocks, (self.shape[0],) + spec.shape, rows.dtype))
        return tree_replace_leaves(self.skeleton, leaves)

    def rows(self, tree) -> spmd.Placed:
        """The placed leaves of ``tree`` joined into a whole row on every
        position, its own blocks copied in place and the others from their
        first holders in its pod: an all-gather over ``data`` x ``model``,
        counted as one ``all_gather`` of what each position lacks of its
        row (``rejoin_bytes``)."""
        leaves = tree_leaves(tree)
        blocks, moved = [], 0
        for i, blk in enumerate(leaves[0].blocks):
            pod = self.positions[i].get("pod", 0)
            row = blk.new_empty((blk.shape[0], self.shape[1]))
            for spec, sh, x in zip(self.layout.specs, self.shardings, leaves):
                whole, seen = self._leaf(row, spec), {x.block_id(i)}
                self._block(whole, sh.spec, i).copy_(x.blocks[i])
                for j, b in enumerate(x.blocks):
                    if self.positions[j].get("pod", 0) == pod and x.block_id(j) not in seen:
                        seen.add(x.block_id(j))
                        self._block(whole, sh.spec, j).copy_(b.to(row.device))
                        moved += b.numel() * b.element_size()
            blocks.append(row)
        spmd.record("all_gather", moved)
        return spmd.Placed(self.sharding, blocks, self.shape, leaves[0].dtype)

    def as_tree(self, node):
        """``node`` with every ``FlatPosterior`` of placed rows (the state's
        posterior, Adam's moments) as a ``GaussianPosterior`` of ``tree``."""
        from repro_torch.core.posterior import GaussianPosterior

        if isinstance(node, FlatPosterior):
            return GaussianPosterior(mean=self.tree(node.mean), rho=self.tree(node.rho))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{f.name: self.as_tree(getattr(node, f.name))
                                                for f in dataclasses.fields(node)})
        return node

    def as_rows(self, node, like):
        """The inverse of ``as_tree``: every ``FlatPosterior`` of ``like``
        taken from ``node``'s posterior of the same place, joined by ``rows``."""
        if isinstance(like, FlatPosterior):
            return dataclasses.replace(like, mean=self.rows(node.mean), rho=self.rows(node.rho))
        if dataclasses.is_dataclass(like) and not isinstance(like, type):
            return dataclasses.replace(like, **{f.name: self.as_rows(getattr(node, f.name),
                                                                     getattr(like, f.name))
                                                for f in dataclasses.fields(like)})
        return node


def rejoin_bytes(layout, mesh, n_agents: int, itemsize: int = 4) -> int:
    """``FlatRows.rows``' counted bytes for one buffer, as a formula: a leaf
    split into ``f`` distinct blocks over the ``k = data x model`` positions
    of a pod is lacked, ``1 - 1/f`` of it, by each of them, so a row of
    leaves all split ``k`` ways costs ``(k - 1)`` rows a pod."""
    skeleton = layout.unflatten(torch.empty((n_agents, layout.n_params), device="meta"))
    pods = mesh.shape.get("pod", 1)
    k = mesh.size // pods
    total = 0
    for spec, sh in zip(layout.specs, tree_leaves(param_shardings(skeleton, mesh,
                                                                  agent_leading=True))):
        f = spmd.shard_factor(sh) // pods
        total += k * (f - 1) * (n_agents * spec.size // f)
    return total * itemsize


def _nll(grid, theta_a, batch_a: dict, members):
    """One agent's summed next-token NLL on its placed batch and its
    router aux, both 0-d on one position: the logits' column blocks
    all-gathered over ``model``, each data block's NLL on its ``model``-0
    position, summed over ``data``."""
    def blocks(name):
        leaf = batch_a.get(name)
        return None if leaf is None else {i: leaf.blocks[i] for i, _ in members}

    row_blocks = _row_blocks(batch_a["tokens"])
    logits, aux = _forward(grid, theta_a, blocks("tokens"), row_blocks, patches=blocks("patches"),
                           frames=blocks("frames"), with_aux=True)
    logits = spmd.all_gather(logits, grid.mesh, "model", -1)
    nll = {}
    for i, m in members:
        if m or (row_blocks == 1 and grid.coords[i][1]):  # one position a distinct block
            continue
        lg, targets = logits[i], batch_a["targets"].blocks[i]
        if lg.shape[-2] != targets.shape[-1]:
            lg = lg[..., lg.shape[-2] - targets.shape[-1]:, :]
        gold = torch.gather(lg, -1, targets[..., None].long())[..., 0]
        per_tok = torch.logsumexp(lg, dim=-1) - gold
        mask = batch_a.get("loss_mask")
        if mask is not None:
            per_tok = per_tok * mask.blocks[i]
        nll[i] = torch.sum(per_tok)
    total = spmd.all_reduce(nll, grid.mesh, "data")
    i = min(total)
    return total[i], aux[i]


def _replicated_axes(sharding) -> list[str]:
    """The mesh axes (data, model) a per-agent sharding does not split over."""
    used = {a for e in sharding.spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    return [a for a in ("data", "model") if a in sharding.mesh.shape and a not in used]


def _sharded_local(grid, prior, opt, opt_state, batch, eps, lr, step, n_agents, kl_scale,
                   bayesian):
    """The data x model local step of a placed pytree posterior (module
    docstring).  Returns (posterior', opt_state', (loss, nll / ntok, KL)
    each ``[A]``)."""
    means, rhos = tree_leaves(prior.mean), tree_leaves(prior.rho)
    eps_leaves = tree_leaves(eps) if bayesian else [None] * len(means)
    size = grid.mesh.size
    grads = [[[] for _ in range(size)] for _ in range(2 * len(means))]
    metrics = []
    for a in range(n_agents):
        pm = [x.agent(a) for x in means]
        pr = [x.agent(a) for x in rhos]
        pe = [None if e is None else e.agent(a) for e in eps_leaves]
        members = [(i, grid.coords[i][2]) for i, b in enumerate(pm[0].blocks) if b is not None]
        qm = [{i: x.blocks[i].detach().requires_grad_(True) for i, _ in members} for x in pm]
        qr = [{i: x.blocks[i].detach().requires_grad_(bayesian) for i, _ in members} for x in pr]
        batch_a = {k: None if v is None else v.agent(a) for k, v in batch.items()}
        ntok = float(torch.Size(batch_a["targets"].shape).numel())
        root = pm[0].blocks[members[0][0]].device
        kl = torch.zeros((), dtype=torch.float32, device=root)
        with torch.enable_grad():
            theta = []
            for k, x in enumerate(pm):
                blocks = [None] * size
                for i, _ in members:
                    blocks[i] = (qm[k][i] + softplus(qr[k][i]) * pe[k].blocks[i] if bayesian
                                 else qm[k][i])
                theta.append(spmd.Placed(x.sharding, blocks, x.shape, x.dtype))
                for i in x.first_holders() if bayesian else ():  # each distinct block once
                    kl = kl + _leaf_kl(qm[k][i], qr[k][i], x.blocks[i].detach(),
                                       pr[k].blocks[i].detach()).to(root)
            nll, aux = _nll(grid, tree_replace_leaves(prior.mean, theta), batch_a, members)
            nll = nll.to(root)
            loss = ((nll + grid.cfg.router_aux_weight * aux.to(root) * ntok) / ntok
                    + kl_scale * kl / ntok)
            wrt = [q[i] for q in (qm + qr if bayesian else qm) for i, _ in members]
            got = iter(torch.autograd.grad(loss / n_agents, wrt))
        for k, x in enumerate(pm + pr):
            if k < len(pm) or bayesian:
                vals = {i: next(got) for i, _ in members}
            else:
                vals = {i: torch.zeros_like(qr[k - len(pm)][i]) for i, _ in members}
            for axis in _replicated_axes(x.sharding):  # a replicated leaf's gradient: summed
                vals = spmd.all_reduce(vals, grid.mesh, axis)
            for i, g in vals.items():
                grads[k][i].append(g)
        metrics.append((loss.detach(), (nll / ntok).detach(), kl.detach()))
    # Adam on each position's blocks
    post_leaves, opt_leaves = means + rhos, tree_leaves(opt_state)
    new_post = [[None] * size for _ in post_leaves]
    new_opt = [[None] * size for _ in opt_leaves]
    for i in range(size):
        g_i = [torch.stack(g[i]) for g in grads]
        g_tree = dataclasses.replace(prior, mean=tree_replace_leaves(prior.mean, g_i[:len(means)]),
                                     rho=tree_replace_leaves(prior.rho, g_i[len(means):]))
        post_i = spmd.blocks_at(prior, i)
        dev = means[0].blocks[i].device
        updates, opt_i = opt.update(g_tree, spmd.blocks_at(opt_state, i), step.blocks[i],
                                    lr.to(dev))
        for k, x in enumerate(tree_leaves(apply_updates(post_i, updates))):
            new_post[k][i] = x
        for k, x in enumerate(tree_leaves(opt_i)):
            new_opt[k][i] = x
    placed_post = [spmd.Placed(x.sharding, b, x.shape, x.dtype)
                   for x, b in zip(post_leaves, new_post)]
    placed_opt = [spmd.Placed(x.sharding, b, x.shape, x.dtype)
                  for x, b in zip(opt_leaves, new_opt)]
    post = dataclasses.replace(prior,
                               mean=tree_replace_leaves(prior.mean, placed_post[:len(means)]),
                               rho=tree_replace_leaves(prior.rho, placed_post[len(means):]))
    dev0 = means[0].blocks[0].device
    loss, nll, kl = (torch.stack([mt[j].to(dev0) for mt in metrics]) for j in range(3))
    return post, tree_replace_leaves(opt_state, placed_opt), (loss, nll, kl)


def _pod_local(cfg, prior, opt, opt_state, batch, eps, lr, step, n_agents, kl_scale, bayesian,
               remat):
    """The pod-only local step: ``blocked_update`` on each position's blocks."""
    from repro_torch.launch.steps import _lm_grad_fn
    from repro_torch.vi.bayes_by_backprop import blocked_update

    grad_fn = _lm_grad_fn(cfg, n_agents, kl_scale, bayesian, remat)
    mesh = mesh_of(prior.mean)
    outs = []
    for i in range(mesh.size):
        block = spmd.blocks_at(prior, i)
        dev = tree_leaves(block.mean)[0].device
        outs.append(blocked_update(block, block, opt, spmd.blocks_at(opt_state, i), grad_fn,
                                   {k: v.blocks[i] for k, v in batch.items() if v is not None},
                                   None if eps is None else spmd.blocks_at(eps, i), lr.to(dev),
                                   step.blocks[i]))

    def placed(template, per_pos):
        return tree_replace_leaves(template, [
            spmd.Placed(x.sharding, [tree_leaves(p)[k] for p in per_pos], x.shape, x.dtype)
            for k, x in enumerate(tree_leaves(template))])

    dev0 = tree_leaves(prior.mean)[0].blocks[0].device
    metrics = tuple(torch.cat([o[2][j].to(dev0) for o in outs]) for j in range(3))
    return placed(prior, [o[0] for o in outs]), placed(opt_state, [o[1] for o in outs]), metrics


def train_round(cfg, state, batch: dict, eps, generator, *, W, opt, lr_schedule, kl_scale,
                bayesian, remat, consensus_impl, wire_dtype):
    """``launch.steps.make_train_round_step`` on a placed state, flat or
    pytree, on a pod-only or a ``data`` x ``model`` mesh: eq. (6) by
    ``consensus_impl`` (``"einsum"``: ``pod_consensus`` at ``wire_dtype``,
    f32 when ``None``; ``"ppermute"``: ``pod_ppermute``, bf16 unless
    ``wire_dtype`` says otherwise; ``"none"``), then the local step.  A
    flat state under ``data`` x ``model`` runs as the parameter dict its
    rows flatten (``FlatRows``): the ppermute ring on each position's whole
    row, then ``pod_consensus`` and the local step on the dict's blocks,
    and its rows (mean, rho and Adam's moments) joined again on every
    position."""
    from repro_torch.launch.steps import BayesTrainState

    post = state.posterior
    mesh = mesh_of(post.mean)
    sharded = sharded_schedule(cfg, mesh)
    n_agents = tree_leaves(post.mean)[0].shape[0]
    batch = _place_batch(batch, mesh)
    prior = post
    if consensus_impl == "ppermute":
        prior = pod_ppermute(post, W, wire_dtype or torch.bfloat16)
    if bayesian:
        if eps is None:
            eps = tree_map(lambda m: torch.randn(m.shape, generator=generator,
                                                 device=m.blocks[0].device), post.mean)
        eps = spmd.device_put(eps, tree_map(lambda m: m.sharding, post.mean))
    else:
        eps = None
    rows = FlatRows(post.layout, post.mean) if isinstance(post, FlatPosterior) and sharded \
        else None
    opt_state = state.opt_state
    if rows is not None:
        prior, opt_state = rows.as_tree(prior), rows.as_tree(opt_state)
        eps = None if eps is None else rows.tree(eps)
    if consensus_impl == "einsum":
        prior = pod_consensus(prior, W, wire_dtype)
    lr = lr_schedule(state.step.blocks[0])
    if sharded:
        new_post, new_opt, (losses, nll, kl) = _sharded_local(
            _Grid(cfg, mesh), prior, opt, opt_state, batch, eps, lr, state.step, n_agents,
            kl_scale, bayesian)
    else:
        new_post, new_opt, (losses, nll, kl) = _pod_local(
            cfg, prior, opt, opt_state, batch, eps, lr, state.step, n_agents, kl_scale,
            bayesian, remat)
    del prior, eps  # a flat state's prior rows: freed before its rows are joined again
    if rows is not None:
        new_post, new_opt = rows.as_rows(new_post, post), rows.as_rows(new_opt, state.opt_state)
    step = spmd.Placed(state.step.sharding, [s + 1 for s in state.step.blocks], (), torch.int32)
    return (BayesTrainState(posterior=new_post, opt_state=new_opt, step=step),
            {"loss": losses.mean(), "nll": nll, "kl": kl})


# ---------------------------------------------------------------------------
# the schedule's traffic
# ---------------------------------------------------------------------------


def _taken(shape, spec, mesh, region) -> tuple[int, int]:
    """One ``spmd.gather`` by each position of a pod of a per-agent leaf of
    ``shape`` under ``spec``, position ``(d, m)`` taking ``region(m)`` (per
    dim ``(start, stop)``): (the elements the pod's positions copy in, the
    most one position assembles).  A position copies its region less the
    part its own block holds."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    moved = most = 0
    for pos in mesh.positions():
        if pos.get("pod", 0):
            continue
        vol = own = 1
        for (lo, hi), n, (b, nb) in zip(region(pos.get("model", 0)), shape,
                                        block_index(spec, mesh, pos)):
            size = n // nb
            vol *= hi - lo
            own *= max(0, min(hi, (b + 1) * size) - max(lo, b * size))
        moved, most = moved + vol - own, max(most, vol)
    return moved, most


def forward_gather_bytes(cfg, mesh, rows: int, seq: int, itemsize: int, n_agents: int,
                         patches: int = 0, frames: int = 0) -> dict:
    """The data x model forward's cross-position bytes, as a formula of the
    config and the reference's specs, for ``n_agents`` agents of ``rows``
    batch rows (``rows`` divisible by ``data``) and ``seq`` text positions
    (``patches`` more for a VLM; 1 for a decode step; ``frames`` the
    encoder's, which runs on every step of an enc-dec config), weights of
    ``itemsize`` bytes, in the prefill and decode steps (with a cache: the
    recurrent states' gathers below).  For a dim that divides its axis
    the sums below come to closed forms: a column block taken over
    ``data`` (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``, ``lm_head``,
    ``w_in``, ``w_r``, ``w_i``, ``conv_w``, ``w_z`` / ``w_f`` / ``w_o``, the
    experts ``[E/M, D, F]``) ``(d - 1) R C`` a pod, a row block (``wo``,
    ``w_down``, ``w_out``) ``R C (d - 1/m)``, a tied embedding's row region
    ``(d m - 1) V D / m``, a leaf taken whole (the router, a VLM's
    ``patch_proj``, the mLSTM's ``w_i`` / ``w_f``) ``(d m - 1) R C``; the
    mLSTM's value columns (``wv``, ``w_gate``, ``w_down``'s rows, one
    region a head) and the sLSTM's head block of ``r_*`` cross both axes'
    blocks; a norm scale, a slice of ``lam_raw`` / ``conv_b``, or a
    replicated tail leaf, what the positions lack of it.  Per layer and
    pod, for ``d x m`` positions:

    * gathers: each weight a position takes (``_taken``), as the schedule
      takes it;
    * the embedding rows: every row block is looked up for every token, so
      a position copies all of its pieces but its own, ``t D / m`` each
      (``t`` its text tokens);
    * all-reduces over ``model``, ``2 (m - 1)`` blocks a group, of ``[rows/d,
      T, D]`` (T = seq + patches, or the frames in the encoder): each
      attention half's ``wo`` (two in a ``dec_attn`` layer: the
      cross-attention's), the FFN, ``w_out`` and the xLSTM's ``w_down``,
      a ``moe`` layer's combine in float32; the xLSTM's partial sums of
      squares ``[rows/d, T, 1]`` float32;
    * all-gathers, ``m (m - 1)`` blocks a group over ``model``: an
      ``rglru`` layer's ``conv_out [rows/d, T, D/m]``, an ``mlstm`` layer's
      ``up``, ``q`` and ``k`` ``[rows/d, T, 2 D/m]`` and the key blocks of
      ``n [rows/d, H, hd/m]`` (float32), an ``slstm`` layer's ``m [rows/d,
      D/m]`` (float32); ``d (d - 1)`` over ``data``:
      a ``moe`` layer's per-expert counts (``E/m`` int32).

    ``gather_per_position_max`` bounds one position's gathers: all it
    assembles, its own parts included."""
    from repro_torch.launch.dryrun import param_shapes

    grid = _Grid(cfg, mesh)
    _, dd, mm = spmd.mesh_sizes(mesh)
    dm, hd = cfg.d_model, cfg.hd
    shapes = tree_map(lambda x: x.expand((1,) + tuple(x.shape)), param_shapes(cfg))
    leaves = tree_map(lambda x, sh: (tuple(x.shape[1:]), tuple(sh.spec)[1:]), shapes,
                      param_shardings(shapes, mesh, agent_leading=True))
    pod = most = 0

    def take(leaf, lead, ranges=lambda m: ()):  # one gather a position, as ``_w``'s
        nonlocal pod, most
        shape, spec = leaf
        body = shape[len(lead):]

        def region(m):
            rs = ranges(m) + (None,) * (len(body) - len(ranges(m)))
            return [(x, x + 1) for x in lead] + [(0, n) if r is None else r
                                                 for r, n in zip(rs, body)]

        moved, biggest = _taken(shape, spec, mesh, region)
        pod, most = pod + moved, most + biggest

    def take_parts(leaf, lead, dim):  # ``_w_parts``: the mLSTM's value columns
        for h in range(cfg.n_heads):
            take(leaf, lead, lambda m: (None,) * dim + (grid.value_cols(m)[h],))

    rows_local = rows // dd if rows % dd == 0 else rows
    reduce = gather_all = 0  # a pod's all-reduced and all-gathered bytes

    def all_reduce(n, nbytes):  # [rows/d, ..., n] a position
        nonlocal reduce
        reduce += dd * 2 * (mm - 1) * rows_local * n * nbytes

    def all_gather(n, nbytes):
        nonlocal gather_all
        gather_all += dd * mm * (mm - 1) * rows_local * n * nbytes

    def attention_half(lp, lead, t, norm="norm1", attn="attn"):
        ap = lp[attn]
        take(lp[norm]["scale"], lead)
        take(ap["wq"], lead, lambda m: (None, _cols(m, grid.hl * hd)))
        take(ap["wk"], lead, lambda m: (None, grid.kv_cols(m)))
        take(ap["wv"], lead, lambda m: (None, grid.kv_cols(m)))
        for name in ("q_norm", "k_norm"):
            if name in ap:
                take(ap[name]["scale"], lead)
        take(ap["wo"], lead, lambda m: (_cols(m, grid.hl * hd), None))
        all_reduce(t * dm, itemsize)

    def ffn(lp, lead, t):
        take(lp["norm2"]["scale"], lead)
        for name in ("w_gate", "w_up"):
            take(lp["mlp"][name], lead, lambda m: (None, _cols(m, grid.fl)))
        take(lp["mlp"]["w_down"], lead, lambda m: (_cols(m, grid.fl), None))
        all_reduce(t * dm, itemsize)

    t = seq + patches  # positions a row
    for kind, lp, lead, _ in _layers(cfg, leaves, None):
        if kind == "mlstm":
            take(lp["norm"]["scale"], lead)
            for name in ("w_up", "wq", "wk"):
                take(lp[name], lead, lambda m: (None, _cols(m, grid.pl)))
                all_gather(t * grid.pl, itemsize)  # up, q, k
            all_gather(cfg.n_heads * grid.hv, 4)  # n's key blocks
            for name in ("w_i", "w_f"):
                take(lp[name], lead)
            for name, dim in (("wv", 1), ("w_gate", 1), ("w_down", 0)):
                take_parts(lp[name], lead, dim)
            take_parts(lp["out_norm"]["scale"], lead, 0)
            all_reduce(t, 4)  # out_norm's sums of squares
            all_reduce(t * dm, itemsize)
            continue
        if kind == "slstm":
            take(lp["norm"]["scale"], lead)
            for name in ("w_z", "w_i", "w_f", "w_o"):
                take(lp[name], lead, lambda m: (None, _cols(m, grid.dl)))
            for name in ("r_z", "r_i", "r_f", "r_o"):
                take(lp[name], lead, lambda m: (_cols(m, cfg.n_heads // mm),))
            take(lp["out_norm"]["scale"], lead, lambda m: (_cols(m, grid.dl),))
            take(lp["w_down"], lead, lambda m: (_cols(m, grid.dl), None))
            all_reduce(t, 4)
            all_reduce(t * dm, itemsize)
            all_gather(grid.dl, 4)  # m
            continue
        if kind == "rglru":
            rp = lp["rec"]
            take(rp["norm"]["scale"], lead)
            for name in ("w_in", "w_gate", "conv_w", "w_r", "w_i"):
                take(rp[name], lead, lambda m: (None, _cols(m, grid.dl)))
            for name in ("conv_b", "lam_raw"):
                take(rp[name], lead, lambda m: (_cols(m, grid.dl),))
            take(rp["w_out"], lead, lambda m: (_cols(m, grid.dl), None))
            all_gather(t * grid.dl, itemsize)
            all_reduce(t * dm, itemsize)
        else:
            attention_half(lp, lead, t)
            if kind == "dec_attn":
                attention_half(lp, lead, t, "norm_x", "xattn")
        if kind == "moe":
            take(lp["norm2"]["scale"], lead)
            take(lp["moe"]["router"], lead)
            for name in ("w_gate", "w_up", "w_down"):
                take(lp["moe"][name], lead, lambda m: (_cols(m, grid.el),))
            all_reduce(t * dm, 4)  # the float32 combine
            if rows % dd == 0:
                gather_all += mm * dd * (dd - 1) * grid.el * 4
        else:
            ffn(lp, lead, t)
    for layer in range(cfg.encoder_layers if frames else 0):
        attention_half(leaves["enc_stack"], (layer, 0), frames)
        ffn(leaves["enc_stack"], (layer, 0), frames)
    if frames:
        take(leaves["enc_norm"]["scale"], ())
    take(leaves["final_norm"]["scale"], ())
    if cfg.tie_embeddings:
        take(leaves["embed"]["emb"], (), lambda m: (_cols(m, grid.vl), None))
    else:
        take(leaves["lm_head"]["w"], (), lambda m: (None, _cols(m, grid.vl)))
    if patches:
        take(leaves["patch_proj"]["w"], ())
    shape, spec = leaves["embed"]["emb"]
    n_r, n_c = (nb for _, nb in block_index(spec + (None,) * (2 - len(spec)), mesh,
                                            next(iter(mesh.positions()))))
    pieces = n_r * n_c
    pod += dd * mm * (pieces - 1) * rows_local * seq * dm // n_c
    most += pieces * rows_local * seq * dm // n_c
    gather = n_agents * pod * itemsize
    reduce, gather_all = n_agents * reduce, n_agents * gather_all
    return {"gather": gather, "all_reduce": reduce, "all_gather": gather_all,
            "bytes": gather + reduce + gather_all, "gather_per_position_max": most * itemsize}


__all__ = ["SHARDED_KINDS", "FlatRows", "apply_layer", "decode", "forward_gather_bytes",
           "moe_counts", "pod_consensus", "pod_ppermute", "prefill", "rejoin_bytes",
           "reset_moe_counts", "sharded_schedule", "train_round"]
