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
* **data x model > 1**: the ``attn`` kind only; the other kinds (``moe``,
  ``local_attn`` / ``rglru``, ``mlstm`` / ``slstm``, ``enc_attn`` /
  ``dec_attn``) and tied embeddings raise ``NotImplementedError`` naming
  ROADMAP 10h.  Position ``(p, d, m)`` computes for the agents of pod ``p``
  and the batch rows its token block holds (block ``d`` of B), over query
  heads ``[m H/M, (m+1) H/M)`` and the KV heads those use (all KV heads
  where ``n_kv_heads`` does not divide M: Granite-20B's one), and FFN
  columns ``[m F/M, (m+1) F/M)``.  Just before use it gathers
  (``spmd.gather``) what it computes with and no more: the column blocks
  of ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up`` / ``lm_head`` over
  ``data``, the head-row block of ``wo`` and the F-row block of
  ``w_down`` from the positions storing them, the norm scales whole, a
  VLM's ``patch_proj`` whole, and its tokens' embedding rows
  (``spmd.gather_rows``).  The o- and down-projections are row-parallel:
  an all-reduce over ``model`` (bf16 partials summed in float32) adds them
  to the residual stream.  The KV cache's ``(B over data, KV heads over
  model)`` blocks are the blocks a position attends with, written in place.
  Prefill launches ``flash_attention`` once a layer a position, on
  ``[B/data, H/M, S, hd]``; decode attends over the position's own cache
  block (plain ``chunked_attention``, as unsharded).  The logits come out
  ``[A, B, T, V]``, joined over ``data`` and ``model``.
  ``forward_gather_bytes`` is the schedule's traffic as a formula.

The train round (``consensus_impl="einsum"``, the reference's default):
eq. (6) gathers each ``(data, model)`` position's blocks over ``pod``,
concatenated over the leaves into ``[A, n]``, and runs
``kernels.consensus.consensus_fused_network`` on them (one launch a
``(data, model)`` position, on its first pod position's device; the plain
version on the CPU), each pod position taking its agents' rows back.  The
local step:

* pod-only: ``vi.bayes_by_backprop.blocked_update`` on each pod position's
  blocks, the unsharded step's own code (one agent a block where the
  unsharded step also runs one);
* data x model > 1 (a pytree state): for one agent at a time, each
  position samples its own blocks (``theta = mean + softplus(rho) eps``),
  the sharded forward runs on them (plain ``chunked_attention``:
  ``flash_attention`` has no backward), the logits' column blocks are
  all-gathered over ``model`` for the NLL, the KL counts each distinct
  block once (at its first holder), and autograd runs through the
  gathers' copies and sums.  The gradient of a leaf replicated over an
  axis is all-reduced over it.  Adam then runs on each position's blocks.
  The activations are kept (``remat`` is a memory choice that changes no
  bit; a position holds its share of them).  A flat state has the spec
  ``("pod", None)``: it runs pod-only.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.flat import FlatPosterior
from repro_torch.core.numerics import canonical_wire_dtype, softplus
from repro_torch.core.posterior import _leaf_kl
from repro_torch.core.tree import tree_leaves, tree_map, tree_replace_leaves
from repro_torch.launch import spmd
from repro_torch.launch.sharding import (
    NamedSharding,
    batch_pspec,
    cache_shardings,
    join_blocks,
    leaf_pspec,
)
from repro_torch.optim.optimizers import apply_updates

NEXT = "ROADMAP 10h"


# ---------------------------------------------------------------------------
# what runs where
# ---------------------------------------------------------------------------


def mesh_of(tree):
    return next(x for x in tree_leaves(tree) if isinstance(x, spmd.Placed)).mesh


def sharded_schedule(cfg, mesh) -> bool:
    """Whether ``cfg`` runs the data x model schedule on ``mesh`` (False:
    pod-only).  Raises ``NotImplementedError`` naming ROADMAP 10h for the
    kinds it does not run, ``ValueError`` where heads, FFN columns or the
    vocabulary do not split over ``model``."""
    _, dd, mm = spmd.mesh_sizes(mesh)
    if dd * mm == 1:
        return False
    kinds = set(cfg.pattern) | set(cfg.tail) | ({"enc_attn"} if cfg.is_encdec else set())
    other = sorted(kinds - {"attn"})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: the {', '.join(other)} block kind(s) do not run under data x model = "
            f"{dd} x {mm} yet ({NEXT}); a mesh whose data and model axes are 1 runs every kind")
    if cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: tied embeddings under data x model > 1 ({NEXT})")
    for what, n in (("query heads", cfg.n_heads), ("FFN columns", cfg.d_ff),
                    ("padded vocabulary", cfg.padded_vocab)):
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
        self.model = spmd.mesh_sizes(mesh)[2]
        self.coords = spmd.position_coords(mesh)
        self.dt = getattr(torch, cfg.dtype)
        mm, hd, kv = self.model, cfg.hd, cfg.n_kv_heads
        self.hl = cfg.n_heads // mm  # query heads a position
        self.fl = cfg.d_ff // mm
        self.vl = cfg.padded_vocab // mm
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


def _w(leaf, i, lead, *ranges):
    """Position ``i``'s gather of ``leaf`` at the layer index ``lead``
    (one entry a leading dim), ``ranges`` over the dims after it."""
    out = spmd.gather(leaf, i, tuple((x, x + 1) for x in lead) + ranges)
    return out.reshape(out.shape[len(lead):])


# ---------------------------------------------------------------------------
# the data x model forward of one agent
# ---------------------------------------------------------------------------


def _attention(grid, ap, lead, i, m, h, positions, cache, window):
    """Position ``i``'s attention (model index ``m``): its query heads over
    the KV heads they read, out ``[..., S, H/M * hd]`` before ``wo``."""
    from repro_torch.models import attention as att

    hd = grid.cfg.hd
    q0 = m * grid.hl * hd
    local = {"wq": _w(ap["wq"], i, lead, None, (q0, q0 + grid.hl * hd))}
    for name in ("wk", "wv"):
        local[name] = _w(ap[name], i, lead, None, grid.kv_cols(m))
    for name in ("q_norm", "k_norm"):
        if name in ap:
            local[name] = {"scale": _w(ap[name]["scale"], i, lead)}
    q, k, v = att.attention_qkv(local, h, grid.lcfg, positions)
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
            out = att.chunked_attention(q, k, v, causal=True, window=window)
        else:
            out = att.kernel_attention(q, att._repeat_kv(k, grid.hl), att._repeat_kv(v, grid.hl),
                                       causal=True, window=window)
    return out.reshape(tuple(h.shape[:-1]) + (grid.hl * hd,))


def _layer(grid, lp, lead, x: dict, members, positions, caches, window):
    """One ``attn`` block over the agent's positions: ``x {i: [rows, S,
    D]}`` -> the same after the attention and the FFN, each row-parallel
    product all-reduced over ``model``."""
    from repro_torch.models.modules import matmul, rmsnorm, swiglu

    cfg, dt = grid.cfg, grid.dt
    part = {}
    for i, m in members:
        h = rmsnorm({"scale": _w(lp["norm1"]["scale"], i, lead)}, x[i], cfg.norm_eps)
        cache = None if caches is None else {k: v.blocks[i][lead] for k, v in caches.items()}
        out = _attention(grid, lp["attn"], lead, i, m, h, positions[i], cache, window)
        rows = (m * grid.hl * cfg.hd, (m + 1) * grid.hl * cfg.hd)
        part[i] = matmul(out, _w(lp["attn"]["wo"], i, lead, rows, None).to(dt))
    y = spmd.all_reduce(part, grid.mesh, "model")
    x = {i: x[i] + y[i] for i in x}
    part = {}
    for i, m in members:
        h2 = rmsnorm({"scale": _w(lp["norm2"]["scale"], i, lead)}, x[i], cfg.norm_eps)
        f = (m * grid.fl, (m + 1) * grid.fl)
        mlp = lp["mlp"]
        part[i] = swiglu({"w_gate": _w(mlp["w_gate"], i, lead, None, f),
                          "w_up": _w(mlp["w_up"], i, lead, None, f),
                          "w_down": _w(mlp["w_down"], i, lead, f, None)}, h2, dt)
    y = spmd.all_reduce(part, grid.mesh, "model")
    return {i: x[i] + y[i] for i in x}


def _members(grid, params_a):
    """(position, model index) of each position holding the agent."""
    emb = params_a["embed"]["emb"]
    return [(i, grid.coords[i][2]) for i, blk in enumerate(emb.blocks) if blk is not None]


def _forward(grid, params_a, tokens: dict, *, positions=None, caches_a=None, patches=None,
             logits_tail=0, window=0):
    """One agent's forward over its pod's positions: ``params_a`` its
    placed weights (``Placed.agent``), ``tokens {i: [rows, S]}``,
    ``caches_a`` its placed cache or ``None``, ``patches {i: [rows, P,
    D]}``.  Returns the logits' column blocks ``{i: [rows, T, V/M]}``
    (float32)."""
    from repro_torch.models.modules import matmul, rmsnorm

    cfg, dt = grid.cfg, grid.dt
    members = _members(grid, params_a)
    x = {}
    for i, _ in members:
        x[i] = spmd.gather_rows(params_a["embed"]["emb"], i, tokens[i]).to(dt)
        if patches is not None:
            proj = _w(params_a["patch_proj"]["w"], i, ()).to(dt)
            x[i] = torch.cat([matmul(patches[i].to(dt), proj), x[i]], dim=-2)
    if positions is None:
        positions = {i: torch.arange(x[i].shape[-2], device=x[i].device) for i in x}
    layers = [(params_a["stacks"]["attn"], (p, o),
               None if caches_a is None else caches_a["stacks"]["attn"])
              for p in range(cfg.n_periods) for o in range(len(cfg.pattern))]
    layers += [(params_a["tail"][t], (), None if caches_a is None else caches_a["tail"][t])
               for t in range(len(cfg.tail))]
    for lp, lead, caches in layers:
        x = _layer(grid, lp, lead, x, members, positions, caches, window)
    logits = {}
    for i, m in members:
        xi = x[i][..., -logits_tail:, :] if logits_tail else x[i]
        xi = rmsnorm({"scale": _w(params_a["final_norm"]["scale"], i, ())}, xi, cfg.norm_eps)
        w = _w(params_a["lm_head"]["w"], i, (), None, (m * grid.vl, (m + 1) * grid.vl))
        logits[i] = matmul(xi, w.to(dt)).float()
    return logits


def _serve(cfg, params, tokens, cache, *, patches=None, position=None, logits_tail=0,
           window_override=None):
    """The data x model prefill (``position`` None) or decode step:
    (logits ``[A, B, T, V]`` on the first position's device, cache)."""
    grid = _Grid(cfg, tokens.mesh)
    window = 0 if window_override is None else window_override
    n_agents = tokens.shape[0]
    per_pos: list[list] = [[] for _ in tokens.blocks]
    for a in range(n_agents):
        params_a = tree_map(lambda leaf: leaf.agent(a), params)
        caches_a = None if cache is None else tree_map(lambda leaf: leaf.agent(a), cache)
        tok_a = tokens.agent(a)
        toks = {i: b for i, b in enumerate(tok_a.blocks) if b is not None}
        pat = None
        if patches is not None:
            pat_a = patches.agent(a)
            pat = {i: b for i, b in enumerate(pat_a.blocks) if b is not None}
        positions = None
        if position is not None:
            positions = {i: torch.as_tensor(position).reshape(1).to(device=b.device,
                                                                    dtype=torch.long)
                         for i, b in toks.items()}
        for i, lg in _forward(grid, params_a, toks, positions=positions, caches_a=caches_a,
                              patches=pat, logits_tail=logits_tail, window=window).items():
            per_pos[i].append(lg)
    spec = tuple(tokens.sharding.spec)[:2] + (None, "model" if grid.model > 1 else None)
    blocks = [torch.stack(lgs) for lgs in per_pos]
    return join_blocks(blocks, NamedSharding(grid.mesh, spec)), cache


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
                  logits_tail=1, window_override=window_override)


def decode(cfg, params, token, position, cache, frames=None, window_override=None):
    """``launch.steps.make_decode_step`` on placed inputs."""
    mesh = mesh_of(params)
    token, cache = _place_batch({"t": token}, mesh)["t"], _place_cache(cache, mesh)
    if not sharded_schedule(cfg, mesh):
        from repro_torch.models import decode_step

        frames = None if frames is None else _place_batch({"f": frames}, mesh)["f"]
        blocks = [decode_step(spmd.blocks_at(params, i), cfg, token.blocks[i], position,
                              spmd.blocks_at(cache, i), enc_out_frames=_block(frames, i),
                              window_override=window_override)[0] for i in range(mesh.size)]
        return _join_pods(blocks, token), cache
    return _serve(cfg, params, token, cache, position=position, window_override=window_override)


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
    position's rows copied back and split into its blocks."""
    from repro_torch.kernels.consensus import consensus_fused_network

    means, rhos = tree_leaves(post.mean), tree_leaves(post.rho)
    mesh = means[0].mesh
    W = torch.as_tensor(W, dtype=torch.float32)
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
            torch.cat([x.to(root) for x in r_rows]).contiguous(), wire_dtype=wire_dtype)
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


def _nll(grid, theta_a, batch_a: dict, members):
    """One agent's summed next-token NLL on its placed batch: the logits'
    column blocks all-gathered over ``model``, each data block's NLL on
    its ``model``-0 position, summed over ``data``."""
    toks = {i: batch_a["tokens"].blocks[i] for i, _ in members}
    pat = None
    if batch_a.get("patches") is not None:
        pat = {i: batch_a["patches"].blocks[i] for i, _ in members}
    logits = spmd.all_gather(_forward(grid, theta_a, toks, patches=pat), grid.mesh, "model", -1)
    nll = {}
    for i, m in members:
        if m:
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
    return total[min(total)]


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
            nll = _nll(grid, tree_replace_leaves(prior.mean, theta), batch_a, members).to(root)
            loss = nll / ntok + kl_scale * kl / ntok
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
    """``launch.steps.make_train_round_step`` on a placed state."""
    from repro_torch.launch.steps import BayesTrainState

    if (consensus_impl not in ("einsum", "none")
            or canonical_wire_dtype(wire_dtype) != torch.float32):
        raise NotImplementedError(
            f"the placed train round runs consensus_impl='einsum' at the f32 wire ({NEXT}), "
            f"asked for {consensus_impl!r} at {wire_dtype}")
    post = state.posterior
    mesh = mesh_of(post.mean)
    flat = isinstance(post, FlatPosterior)
    sharded = sharded_schedule(cfg, mesh)
    if flat and sharded:
        raise NotImplementedError(f"a flat state's spec ('pod', None) replicates it over data x "
                                  f"model; it runs on a pod-only mesh ({NEXT})")
    n_agents = tree_leaves(post.mean)[0].shape[0]
    batch = _place_batch(batch, mesh)
    prior = post if consensus_impl == "none" else pod_consensus(post, W)
    if bayesian:
        if eps is None:
            eps = tree_map(lambda m: torch.randn(m.shape, generator=generator,
                                                 device=m.blocks[0].device), post.mean)
        eps = spmd.device_put(eps, tree_map(lambda m: m.sharding, post.mean))
    else:
        eps = None
    lr = lr_schedule(state.step.blocks[0])
    if sharded:
        new_post, opt_state, (losses, nll, kl) = _sharded_local(
            _Grid(cfg, mesh), prior, opt, state.opt_state, batch, eps, lr, state.step,
            n_agents, kl_scale, bayesian)
    else:
        new_post, opt_state, (losses, nll, kl) = _pod_local(
            cfg, prior, opt, state.opt_state, batch, eps, lr, state.step, n_agents, kl_scale,
            bayesian, remat)
    step = spmd.Placed(state.step.sharding, [s + 1 for s in state.step.blocks], (), torch.int32)
    return (BayesTrainState(posterior=new_post, opt_state=opt_state, step=step),
            {"loss": losses.mean(), "nll": nll, "kl": kl})


# ---------------------------------------------------------------------------
# the schedule's traffic
# ---------------------------------------------------------------------------


def forward_gather_bytes(cfg, mesh, rows: int, seq: int, itemsize: int, n_agents: int,
                         patches: int = 0) -> dict:
    """The data x model forward's cross-position bytes, as a formula of the
    config, for ``n_agents`` agents of ``rows`` batch rows (``rows``
    divisible by ``data``) and ``seq`` text positions (``patches`` more for
    a VLM; 1 for a decode step), weights of ``itemsize`` bytes, every
    weight dim dividing its axis under the reference's specs (a layer
    stack ``[L, c, R, C]``: R over ``data``, C over ``model``; a norm scale
    ``[L, c, n]``: n over ``model``, c over ``data`` where it divides).
    Per layer and pod, for d x m positions:

    * column blocks (wq, wk, wv, w_gate, w_up; lm_head once): each position
      copies the ``d - 1`` row blocks of its column block it lacks,
      ``(d - 1) R C`` a pod;
    * row blocks (wo, w_down): ``R C (d - 1/m)`` a pod (of the row block a
      position needs, its own block holds ``R/d x C/m`` of one position's);
    * a norm scale of ``n`` taken whole: ``d m n - o n / m``, ``o`` the
      positions owning one of its ``m`` pieces (``m`` where c splits over
      ``data``, else ``d m``); where ``n_kv_heads`` does not divide ``m``,
      ``wk`` and ``wv`` whole, ``d m (1 - 1/f) D kv hd`` (``f`` their shard
      factor); a VLM's ``patch_proj``, once, ``(d m - 1) D^2``;
    * the embedding rows: every row block is looked up for every token, so
      a position copies ``d m - 1`` pieces of ``t D / m`` (``t`` its text
      tokens);
    * all-reduces: two a layer of ``[rows/d, seq + patches, D]`` over
      ``model``, ``2 (m - 1)`` blocks a group.

    ``gather_per_position_max`` bounds one position's gathers: all it
    assembles, its own parts included."""
    _, dd, mm = spmd.mesh_sizes(mesh)
    n_pos = dd * mm
    dm, hd, h, kv, f = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    t = rows // dd * seq  # text tokens a position
    owners = mm if len(cfg.pattern) % dd == 0 else n_pos

    def norm(n):  # (a pod's bytes, one position's most)
        return n_pos * n - owners * n / mm, n

    pod, most = 0.0, 0.0
    parts = [((dd - 1) * r * c, r * c / mm) for r, c in ((dm, h * hd), (dm, f), (dm, f))]
    parts += [(r * c * (dd - 1 / mm), r * c / mm) for r, c in ((h * hd, dm), (f, dm))]
    parts += [norm(dm), norm(dm)] + ([norm(hd), norm(hd)] if cfg.qk_norm else [])
    if kv % mm:
        wk = torch.empty((1, dm, kv * hd), device="meta")
        share = 1 - 1 / spmd.shard_factor(
            NamedSharding(mesh, leaf_pspec((), wk, mesh, agent_leading=True)[1:]))
        parts += [(n_pos * share * dm * kv * hd, dm * kv * hd)] * 2
    else:
        parts += [((dd - 1) * dm * kv * hd, dm * kv * hd / mm)] * 2
    for a, b in parts:
        pod, most = pod + cfg.n_layers * a, most + cfg.n_layers * b
    pod += (dd - 1) * dm * cfg.padded_vocab + n_pos * (n_pos - 1) * t * dm / mm
    most += dm * cfg.padded_vocab / mm + n_pos * t * dm / mm
    if patches:
        pod, most = pod + (n_pos - 1) * dm * dm, most + dm * dm
    gather = n_agents * pod * itemsize
    reduce = n_agents * dd * 2 * cfg.n_layers * 2 * (mm - 1) * (t + rows // dd * patches) \
        * dm * itemsize
    return {"gather": gather, "all_reduce": reduce, "bytes": gather + reduce,
            "gather_per_position_max": most * itemsize}


__all__ = ["decode", "forward_gather_bytes", "pod_consensus", "prefill", "sharded_schedule",
           "train_round"]
