"""Eq. (6) kernels over the flat [N, P] network posterior, each beside its
plain PyTorch version (port of the ``repro.kernels.consensus`` kernels on the
synchronous round's and the gossip windows' paths).

* ``consensus_fused_network``: eq. (6) for all N agents in one pass,

      prec_j = softplus(rho_j)^-2
      prec_x, pm_x = wire(prec_j), wire(prec_j * mean_j)
      new_prec = W @ prec_x,  new_pm = W @ pm_x         (fp32 accumulation)
      mean' = new_pm / new_prec,  rho' = softplus^-1(new_prec^-1/2)

  CUDA source: ``csrc/consensus_network.cu`` (N <= 16 keeps every row of
  a thread's 2 lanes in registers; larger N lists W's nonzeros on the card
  and walks only those, over each source's terms computed once a tile).
* ``consensus_fused``: eq. (6) for ONE agent, ``w_row [N]`` over the
  stacked neighbour rows ``[N, P]`` -> ``[P]``, in that kernel's own op
  order (``wp = w * prec`` then ``sum(wp * mean)`` at f32; ``sum(w *
  wire(prec))`` and ``sum(w * wire(prec * mean))`` at other wires), the
  kernel behind ``ops.consensus_posterior``.  CUDA source:
  ``csrc/consensus_row.cu`` (N <= 16 loads every row of a thread's lane
  into registers before the arithmetic; larger N runs the first port's
  kernel).
* ``consensus_fused_masked``: the same pass on one gossip window's W-tilde
  with an ``[N]`` activity mask.  Active rows are bitwise the network
  kernel's rows (the same kernel instance); inactive rows pass (mean, rho)
  through untouched.  CUDA source: ``csrc/consensus_network.cu``.
* ``consensus_fused_sparse`` / ``consensus_fused_masked_sparse``: eq. (6)
  over CSR neighbour tables (``neighbors [N, D]`` self-padded ids,
  ``weights [N, D]`` zero-padded): each agent gathers only its deg(i) rows;
  the masked form copies an inactive agent's own row.  Any N: the kernel
  walks (agent, lane group) by a flat index.  The plain versions rebuild
  the small dense W from the tables, as the JAX package's reference path
  does.  CUDA source: ``csrc/consensus_sparse.cu`` (N <= 24 computes each
  row's per-lane terms once per tile in shared memory; larger N gathers
  from L2).
* ``consensus_fused_segments``: eq. (6) over a ragged, destination-sorted
  term list (``launch_plan.RaggedTerms``), the one kernel of the gossip
  runtime's delayed delivery and edge-native segment windows.  A term's
  source index addresses a row of ``x`` ([N_x, P] float32) below N_x and a
  row of ``h`` (the [K N, P] history ring in float32, bf16 or f16, or a
  second float32 buffer) above; ``wp_first`` picks the delayed path's f32
  association ``(w * prec) * mean``.  No TPU kernel exists for it (the
  reference scatters with XLA); the sums run in a fixed order, so the bits
  are the same every run.  CUDA source: ``csrc/consensus_segments.cu``
  ((row, tile) items, a row's terms staged in chunks and every load of a
  chunk issued before its arithmetic, idle rows copied by whole blocks).
* ``consensus_shard_encode`` / ``consensus_fused_shard``: the two halves of
  one shard of a sharded gossip window (``launch.consensus_opt``): encode a
  shard's own rows into its ``[N, P]`` wire-dtype statistic buffers, then,
  once the rotations have copied the other shards' rows in, reduce its rows
  of W-tilde over them.  Active rows are bitwise ``consensus_fused_masked``'s
  rows; no TPU kernel exists for it (the reference's shard body is XLA).
  CUDA source: ``csrc/consensus_shard.cu``.  The plain versions run the
  network's shapes, so that on the CPU they are bitwise
  ``consensus_masked_plain``'s rows.
* ``payload_validity_fused``: per agent, every wire-rounded ``prec`` and
  ``prec * mean`` lane finite, ``prec > 0`` and both within ``bound``.
  CUDA source: ``csrc/payload_validity.cu``, one launch planned by
  ``stream_plan``.

Masks: the kernels read an ``[N]`` mask as bytes, nonzero = active.  A
``bool`` tensor on the card goes to the kernel as it is, so a masked call
runs one device kernel; other dtypes (and host masks) become ``mask > 0``
first.  Launch plans (instance, load width, grid of at most one wave):
``launch_plan``.

Each wrapper takes its plain version only for tensors on the CPU.  A CUDA
tensor launches the kernel on the current stream or raises: there is no
fallback.  A launch adds one to the wrapper's counter in ``dispatch``.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import (
    canonical_wire_dtype,
    softplus,
    softplus_inv,
    wire_cast_pair,
    wire_roundtrip,
)
from repro_torch.kernels import dispatch, launch_plan, stream_plan

_WIRE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_flat(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: expects float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expects contiguous tensors")
    shape = tensors[0].shape
    if len(shape) != 2 or shape[0] == 0 or shape[1] == 0:
        raise ValueError(f"{what}: expects non-empty [N, P] buffers, got {tuple(shape)}")
    for t in tensors[1:]:
        if t.shape != shape:
            raise ValueError(f"{what}: shape {tuple(t.shape)} != {tuple(shape)}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -- eq. (6) over the whole network -----------------------------------------


def consensus_network_plain(W, mean, rho, wire_dtype=None):
    """The plain PyTorch version of ``consensus_fused_network``."""
    wd = canonical_wire_dtype(wire_dtype)
    prec = 1.0 / torch.square(softplus(rho))
    prec_x = wire_roundtrip(prec, wd)
    pm_x = wire_roundtrip(prec * mean, wd)
    W = W.to(torch.float32)
    new_prec = torch.matmul(W, prec_x)
    new_pm = torch.matmul(W, pm_x)
    return new_pm / new_prec, softplus_inv(torch.rsqrt(new_prec))


def _outputs_and_vec(mean, rho):
    """Empty outputs like (mean, rho) and the load width every row of the
    four buffers is aligned to."""
    mean_out, rho_out = torch.empty_like(mean), torch.empty_like(rho)
    vec = launch_plan.row_vector_width(mean.shape[1], mean.data_ptr(), rho.data_ptr(),
                                       mean_out.data_ptr(), rho_out.data_ptr())
    return mean_out, rho_out, vec


def _network_launch(name, W, active, mean, rho, wire_dtype, instance=None):
    """One call of ``csrc/consensus_network.cu``: ``active`` None or an
    ``[N]`` mask; ``instance`` the small instance ``dense_instance(N)``
    (the default) or 0, the generic path, which runs N up to
    ``launch_plan.GENERIC_N_MAX``: two kernels, W's nonzero lists built on
    the card, then the walk over them."""
    if mean.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {mean.device}")
    _check_flat(name, mean, rho)
    n, p = mean.shape
    if W.shape != (n, n) or W.device != mean.device or W.dtype != torch.float32:
        raise ValueError(f"{name}: W must be float32 [{n}, {n}] on {mean.device}, got "
                         f"{W.dtype} {tuple(W.shape)} on {W.device}")
    W = W.contiguous()
    act = None if active is None else _as_mask(active, n, mean.device)
    mean_out, rho_out, vec = _outputs_and_vec(mean, rho)
    wire = _WIRE_CODE[canonical_wire_dtype(wire_dtype)]
    lib = dispatch.library()
    instance = launch_plan.dense_instance(n) if instance is None else instance
    if not instance:
        launch_plan.generic_tile(n)  # refuses N past GENERIC_N_MAX before the card is asked
    wave = dispatch.wave(mean.device, "consensus_network", lib.consensus_network_blocks_per_sm,
                         wire, instance, 0 if instance else n)
    plan = launch_plan.dense_plan(n, p, vec, instance, wave)
    entries = walked = None
    if not instance:
        entries = torch.empty(launch_plan.nonzero_words(n), dtype=torch.int32,
                              device=mean.device)
        walked = dispatch.walk_counter(mean.device)
    with torch.cuda.device(mean.device):  # the launch runs on the tensors' card
        err = lib.consensus_network_launch(
            W.data_ptr(), None if act is None else act.data_ptr(), mean.data_ptr(),
            rho.data_ptr(), mean_out.data_ptr(), rho_out.data_ptr(), n, p, wire,
            plan.instance, plan.vec, plan.grid, plan.tile,
            *(None if t is None else t.data_ptr() for t in (entries, walked)),
            _stream(mean.device),
        )
    dispatch.check_cuda(err, name)
    dispatch.count_launch(name)
    if not instance:
        dispatch.count_dense_walk(n * n)
    return mean_out, rho_out


def consensus_fused_network(W, mean, rho, *, wire_dtype=None):
    """Eq. (6) for every agent: ``W [N, N]`` row-stochastic, ``mean``/``rho``
    ``[N, P]`` float32.  Returns the new (mean, rho), both ``[N, P]``."""
    if mean.device.type == "cpu":
        return consensus_network_plain(W, mean, rho, wire_dtype)
    return _network_launch("consensus_fused_network", W, None, mean, rho, wire_dtype)


# -- eq. (6) for one agent ---------------------------------------------------


def consensus_row_plain(w_row, mean, rho, wire_dtype=None):
    """The plain PyTorch version of ``consensus_fused``."""
    wd = canonical_wire_dtype(wire_dtype)
    sigma = softplus(rho)
    prec = 1.0 / (sigma * sigma)
    w = w_row.to(torch.float32)[:, None]
    if wd == torch.float32:
        wp = w * prec
        prec_out = torch.sum(wp, dim=0)
        mean_out = torch.sum(wp * mean, dim=0) / prec_out
    else:
        prec_out = torch.sum(w * wire_roundtrip(prec, wd), dim=0)
        mean_out = torch.sum(w * wire_roundtrip(prec * mean, wd), dim=0) / prec_out
    return mean_out, softplus_inv(torch.rsqrt(prec_out))


def _row_launch(w_row, mean, rho, wire_dtype, instance=None):
    """One launch of ``csrc/consensus_row.cu``: ``instance`` the plan's
    ``row_instance(N)`` (the default) or 0, the generic kernel, which runs
    any N with the same bits."""
    name = "consensus_fused"
    if mean.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {mean.device}")
    _check_flat(name, mean, rho)
    n, p = mean.shape
    if w_row.shape != (n,) or w_row.device != mean.device or w_row.dtype != torch.float32:
        raise ValueError(f"{name}: w_row must be float32 [{n}] on {mean.device}, got "
                         f"{w_row.dtype} {tuple(w_row.shape)} on {w_row.device}")
    w_row = w_row.contiguous()
    mean_out = torch.empty(p, dtype=torch.float32, device=mean.device)
    rho_out = torch.empty_like(mean_out)
    wire = _WIRE_CODE[canonical_wire_dtype(wire_dtype)]
    lib = dispatch.library()
    instance = launch_plan.row_instance(n) if instance is None else instance
    wave = dispatch.wave(mean.device, "consensus_row", lib.consensus_row_blocks_per_sm,
                         wire, instance)
    plan = launch_plan.row_plan(n, p, instance, wave)
    err = lib.consensus_row_launch(
        w_row.data_ptr(), mean.data_ptr(), rho.data_ptr(), mean_out.data_ptr(),
        rho_out.data_ptr(), n, p, wire, plan.instance, plan.grid, _stream(mean.device),
    )
    dispatch.check_cuda(err, name)
    dispatch.count_launch(name)
    return mean_out, rho_out


def consensus_fused(w_row, mean, rho, *, wire_dtype=None):
    """Eq. (6) for one agent: ``w_row [N]`` its row of W, ``mean``/``rho``
    ``[N, P]`` float32 the stacked neighbour posteriors.  Returns the
    agent's new (mean, rho), both ``[P]``."""
    if mean.device.type == "cpu":
        return consensus_row_plain(w_row, mean, rho, wire_dtype)
    return _row_launch(w_row, mean, rho, wire_dtype)


def _as_mask(active, n: int, device: torch.device) -> torch.Tensor:
    """``[N]`` bool on ``device`` from a bool/int/float mask (> 0 = active).
    A bool tensor already there is used as it is (the kernels read its
    bytes, nonzero = active), so a masked call runs one device kernel."""
    act = torch.as_tensor(active, device=device)
    if act.shape != (n,):
        raise ValueError(f"active mask of shape {tuple(act.shape)}, expected ({n},)")
    return (act if act.dtype == torch.bool else act > 0).contiguous()


def consensus_masked_plain(W, active, mean, rho, wire_dtype=None):
    """The plain PyTorch version of ``consensus_fused_masked``."""
    new_mean, new_rho = consensus_network_plain(W, mean, rho, wire_dtype)
    act = _as_mask(active, mean.shape[0], mean.device)[:, None]
    return torch.where(act, new_mean, mean), torch.where(act, new_rho, rho)


def consensus_fused_masked(W, active, mean, rho, *, wire_dtype=None):
    """Eq. (6) on one gossip window: ``W [N, N]`` the window's W-tilde,
    ``active [N]`` its activity mask.  Active rows are bitwise
    ``consensus_fused_network``'s; inactive rows are (mean, rho) untouched."""
    if mean.device.type == "cpu":
        return consensus_masked_plain(W, active, mean, rho, wire_dtype)
    return _network_launch("consensus_fused_masked", W, active, mean, rho, wire_dtype)


# -- eq. (6) over CSR neighbour tables ---------------------------------------


def csr_tables(what: str, neighbors, weights, n: int, device: torch.device):
    """int32 ids and float32 weights ``[N, D]`` on ``device``.  Ids of tables
    that come from the host are checked to lie in [0, N); tables already on
    the card are not (that would stall the host), and the kernel sets an
    agent's row to NaN where an id is out of range."""
    nbr = torch.as_tensor(neighbors)
    if nbr.device.type == "cpu" and bool(((nbr < 0) | (nbr >= n)).any()):
        raise ValueError(f"{what}: neighbour ids outside [0, {n})")
    nbr = nbr.to(device=device, dtype=torch.int32).contiguous()
    wts = torch.as_tensor(weights, device=device).to(torch.float32).contiguous()
    if nbr.ndim != 2 or nbr.shape[0] != n or nbr.shape[1] == 0 or wts.shape != nbr.shape:
        raise ValueError(f"{what}: tables {tuple(nbr.shape)} / {tuple(wts.shape)} "
                         f"are not both [{n}, D]")
    return nbr, wts


def tables_to_dense(neighbors, weights, n: int) -> torch.Tensor:
    """The ``[N, N]`` W of CSR tables: ``W[i, nbr[i, d]] += wts[i, d]``, one
    slot column at a time (each column touches every row once, so no sum
    depends on a scatter order)."""
    W = torch.zeros((n, n), dtype=torch.float32, device=weights.device)
    rows = torch.arange(n, device=weights.device)
    for d in range(neighbors.shape[1]):
        cols = neighbors[:, d].long()
        W[rows, cols] = W[rows, cols] + weights[:, d]
    return W


def consensus_sparse_plain(neighbors, weights, mean, rho, wire_dtype=None):
    """The plain PyTorch version of ``consensus_fused_sparse``."""
    nbr, wts = csr_tables("consensus_sparse_plain", neighbors, weights,
                       mean.shape[0], mean.device)
    return consensus_network_plain(tables_to_dense(nbr, wts, mean.shape[0]),
                                   mean, rho, wire_dtype)


def consensus_masked_sparse_plain(neighbors, weights, active, mean, rho, wire_dtype=None):
    """The plain PyTorch version of ``consensus_fused_masked_sparse``."""
    nbr, wts = csr_tables("consensus_masked_sparse_plain", neighbors, weights,
                       mean.shape[0], mean.device)
    return consensus_masked_plain(tables_to_dense(nbr, wts, mean.shape[0]), active,
                                  mean, rho, wire_dtype)


def _sparse_launch(name, neighbors, weights, active, mean, rho, wire_dtype, staged=None):
    """One launch of ``csrc/consensus_sparse.cu``: ``staged`` None (the
    plan's choice for N), True (N <= ``launch_plan.STAGE_N_MAX``) or False
    (the gather path, any N)."""
    if mean.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {mean.device}")
    _check_flat(name, mean, rho)
    n, p = mean.shape
    nbr, wts = csr_tables(name, neighbors, weights, n, mean.device)
    act = None if active is None else _as_mask(active, n, mean.device)
    mean_out, rho_out, vec = _outputs_and_vec(mean, rho)
    wire = _WIRE_CODE[canonical_wire_dtype(wire_dtype)]
    lib = dispatch.library()
    staged = launch_plan.sparse_staged(n) if staged is None else staged
    wave = dispatch.wave(mean.device, "consensus_sparse", lib.consensus_sparse_blocks_per_sm,
                         wire, int(staged), n if staged else 0)
    plan = launch_plan.sparse_plan(n, p, vec, staged, wave)
    err = lib.consensus_sparse_launch(
        nbr.data_ptr(), wts.data_ptr(), None if act is None else act.data_ptr(),
        mean.data_ptr(), rho.data_ptr(), mean_out.data_ptr(), rho_out.data_ptr(), n,
        nbr.shape[1], p, wire, plan.instance, plan.vec, plan.grid, _stream(mean.device),
    )
    dispatch.check_cuda(err, name)
    dispatch.count_launch(name)
    return mean_out, rho_out


def consensus_fused_sparse(neighbors, weights, mean, rho, *, wire_dtype=None):
    """Eq. (6) where each agent gathers only its ``deg(i) <= D`` neighbour
    rows: ``neighbors [N, D]`` ids padded with the agent's own id,
    ``weights [N, D]`` padded with 0.0.  Returns the new (mean, rho)."""
    if mean.device.type == "cpu":
        return consensus_sparse_plain(neighbors, weights, mean, rho, wire_dtype)
    return _sparse_launch("consensus_fused_sparse", neighbors, weights, None,
                          mean, rho, wire_dtype)


def consensus_fused_masked_sparse(neighbors, weights, active, mean, rho, *,
                                  wire_dtype=None):
    """``consensus_fused_sparse`` on one gossip window's tables with an
    ``[N]`` activity mask: an inactive agent copies its own row."""
    if mean.device.type == "cpu":
        return consensus_masked_sparse_plain(neighbors, weights, active, mean, rho,
                                             wire_dtype)
    return _sparse_launch("consensus_fused_masked_sparse", neighbors, weights, active,
                          mean, rho, wire_dtype)


# -- eq. (6) over a ragged term list ------------------------------------------

_HIST_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SEGMENT_GATHER_ELEMS = 1 << 24  # the plain version's [T, block] gather cap (elements)


def _source_rows(idx, x, h):
    """Rows ``idx`` of the stacked (x, h) index space as float32 (two
    gathers and a select: no host sync on the card)."""
    n_x = x.shape[0]
    rows = x.index_select(0, idx.clamp(max=n_x - 1))
    if h is None:
        return rows
    h_rows = h.index_select(0, (idx - n_x).clamp(min=0)).to(torch.float32)
    return torch.where((idx < n_x)[:, None], rows, h_rows)


def consensus_segments_plain(terms, x_mean, x_rho, h_mean=None, h_rho=None, wire_dtype=None,
                             wp_first=False, block=None):
    """The plain PyTorch version of ``consensus_fused_segments``: per block
    of lanes, gather every term's source rows and ``index_add_`` the terms
    into their rows (on the CPU in term order), as the reference blocks its
    scatter."""
    wd = canonical_wire_dtype(wire_dtype)
    dev = x_mean.device
    t = terms.to(dev)
    n, p = terms.n_rows, x_mean.shape[1]
    counts = t.row_ptr[1:] - t.row_ptr[:-1]
    rows = torch.searchsorted(t.row_ptr[1:], torch.arange(terms.n_terms, device=dev,
                                                         dtype=torch.int32), right=True)
    src = t.src.long()
    w = t.weight[:, None]
    idle = (counts == 0)[:, None]
    pass_src = torch.arange(n, device=dev) if t.pass_src is None else t.pass_src.long()
    if block is None:
        block = max(128, _SEGMENT_GATHER_ELEMS // max(terms.n_terms, 1))
    mean_out = torch.empty((n, p), dtype=torch.float32, device=dev)
    rho_out = torch.empty_like(mean_out)
    for s in range(0, p, block):
        e = min(s + block, p)
        m = _source_rows(src, x_mean[:, s:e], None if h_mean is None else h_mean[:, s:e])
        r = _source_rows(src, x_rho[:, s:e], None if h_rho is None else h_rho[:, s:e])
        prec = 1.0 / torch.square(softplus(r))
        if wd == torch.float32 and wp_first:
            t_prec = w * prec
            t_pm = t_prec * m
        else:
            t_prec = w * wire_roundtrip(prec, wd)
            t_pm = w * wire_roundtrip(prec * m, wd)
        acc_prec = torch.zeros((n, e - s), dtype=torch.float32, device=dev)
        acc_pm = torch.zeros_like(acc_prec)
        acc_prec.index_add_(0, rows, t_prec)
        acc_pm.index_add_(0, rows, t_pm)
        pm = _source_rows(pass_src, x_mean[:, s:e], None if h_mean is None else h_mean[:, s:e])
        pr = _source_rows(pass_src, x_rho[:, s:e], None if h_rho is None else h_rho[:, s:e])
        mean_out[:, s:e] = torch.where(idle, pm, acc_pm / acc_prec)
        rho_out[:, s:e] = torch.where(idle, pr, softplus_inv(torch.rsqrt(acc_prec)))
    return mean_out, rho_out


def _check_terms(terms, n_x: int, n_h: int) -> None:
    """Host terms read rows of the sources only, and their order puts the
    rows with terms first.  Terms already on the card are not checked (that
    would stall the host); the kernel sets a row whose source index is out
    of range to NaN, and a row with terms that the order puts among the
    idle ones."""
    if isinstance(terms.src, torch.Tensor) and terms.src.device.type != "cpu":
        return
    n_src = n_x + n_h
    src = torch.as_tensor(terms.src)
    if terms.n_terms and int(src.max()) >= n_src:
        raise ValueError(f"consensus_fused_segments: a term reads row {int(src.max())} "
                         f"of {n_src}")
    if terms.pass_src is None and terms.n_rows > n_x:
        raise ValueError(f"consensus_fused_segments: {terms.n_rows} rows pass through from "
                         f"x of {n_x} rows")
    if terms.pass_src is not None and int(torch.as_tensor(terms.pass_src).max()) >= n_src:
        raise ValueError("consensus_fused_segments: a pass-through row outside the sources")
    if terms.order is not None:
        order = torch.as_tensor(terms.order).long()
        busy = torch.as_tensor(terms.row_ptr[1:] != terms.row_ptr[:-1])
        a = terms.n_active
        if (a is None or not torch.equal(order.sort().values, torch.arange(terms.n_rows))
                or not bool(busy[order[:a]].all()) or bool(busy[order[a:]].any())):
            raise ValueError("consensus_fused_segments: the order does not put the "
                             f"{a} rows with terms first")


def _segments_launch(terms, x_mean, x_rho, h_mean, h_rho, wire_dtype, wp_first, instance=None):
    """One launch of ``csrc/consensus_segments.cu``: ``instance`` None (the
    tile kernel at ``launch_plan.segments_instance`` lanes a thread), 1 or 4
    (the tile kernel at that many), or 0 (PR 19's lane kernel: the same
    bits)."""
    name = "consensus_fused_segments"
    if x_mean.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x_mean.device}")
    _check_flat(name, x_mean, x_rho)
    dev = x_mean.device
    n_x, p = x_mean.shape
    n_h = 0
    if h_mean is not None:
        if (h_rho is None or h_mean.dtype not in _HIST_CODE or h_rho.dtype != h_mean.dtype
                or h_mean.shape != h_rho.shape or h_mean.ndim != 2 or h_mean.shape[1] != p
                or h_mean.device != dev or h_rho.device != dev
                or not (h_mean.is_contiguous() and h_rho.is_contiguous())):
            raise ValueError(f"{name}: h must be two contiguous [n_h, {p}] float32, bf16 or "
                             f"f16 buffers on {dev}")
        n_h = h_mean.shape[0]
    _check_terms(terms, n_x, n_h)
    n = terms.n_rows
    t = terms.to(dev)
    if not (t.row_ptr.dtype == t.src.dtype == torch.int32 and t.weight.dtype == torch.float32
            and all(a is None or a.dtype == torch.int32 for a in (t.pass_src, t.order))):
        raise TypeError(f"{name}: int32 offsets, sources and rows, float32 weights")
    mean_out = torch.empty((n, p), dtype=torch.float32, device=dev)
    rho_out = torch.empty_like(mean_out)
    wire = _WIRE_CODE[canonical_wire_dtype(wire_dtype)]
    hist = _HIST_CODE[torch.float32 if h_mean is None else h_mean.dtype]
    wp = int(bool(wp_first) and wire == 0)
    ptr = (lambda x: None if x is None else x.data_ptr())
    if instance is None:
        instance = launch_plan.segments_instance(
            p, (x_mean.data_ptr(), x_rho.data_ptr(), mean_out.data_ptr(), rho_out.data_ptr()),
            () if h_mean is None else (h_mean.data_ptr(), h_rho.data_ptr()),
            4 if h_mean is None else h_mean.element_size())
    lib = dispatch.library()
    wave = dispatch.wave(dev, "consensus_segments", lib.consensus_segments_blocks_per_sm,
                         hist, wire, wp, instance)
    order = t.order if instance and t.order is not None else None
    n_active = n if order is None else t.n_active
    plan = launch_plan.segments_plan(n, p, instance, wave, n_active)
    err = lib.consensus_segments_launch(
        t.row_ptr.data_ptr(), ptr(t.src), ptr(t.weight), ptr(t.pass_src), ptr(order),
        x_mean.data_ptr(), x_rho.data_ptr(), ptr(h_mean), ptr(h_rho), mean_out.data_ptr(),
        rho_out.data_ptr(), n_x, n_h, n, n_active, p, hist, wire, wp, plan.instance, plan.grid,
        _stream(dev),
    )
    dispatch.check_cuda(err, name)
    dispatch.count_launch(name)
    return mean_out, rho_out


def consensus_fused_segments(terms, x_mean, x_rho, h_mean=None, h_rho=None, *,
                             wire_dtype=None, wp_first=False, block=None):
    """Eq. (6) over the ragged term list ``terms`` (``launch_plan.
    RaggedTerms``): row i of the output sums its terms in order, each
    ``weight * (prec, prec * mean)`` of its source row, with sources below
    ``x_mean.shape[0]`` rows of ``x`` and the rest rows of ``h`` (decoded to
    float32); a row without terms copies its pass-through row bitwise.
    ``wp_first`` (f32 wire only) multiplies ``(w * prec) * mean``, else
    ``w * wire(prec * mean)``; ``block`` (lanes) blocks the plain version's
    gather.  Returns the new (mean, rho), ``[N, P]``."""
    if x_mean.device.type == "cpu":
        _check_terms(terms, x_mean.shape[0], 0 if h_mean is None else h_mean.shape[0])
        return consensus_segments_plain(terms, x_mean, x_rho, h_mean, h_rho, wire_dtype,
                                        wp_first, block)
    return _segments_launch(terms, x_mean, x_rho, h_mean, h_rho, wire_dtype, wp_first)


# -- eq. (6) for one shard of the agent axis ---------------------------------


def _frame(block, row0: int, n: int) -> torch.Tensor:
    """``block [rows, P]`` at rows ``row0`` of an ``[n, P]`` frame (zeros
    elsewhere); the block itself when it is the whole network."""
    if block.shape[0] == n:
        return block
    frame = torch.zeros((n,) + tuple(block.shape[1:]), dtype=block.dtype, device=block.device)
    frame[row0:row0 + block.shape[0]] = block
    return frame


def consensus_shard_encode_plain(mean, rho, n: int, row0: int = 0, wire_dtype=None):
    """The plain PyTorch version of ``consensus_shard_encode``: the rows'
    ``(prec_x, pm_x)`` in the wire dtype.  The softplus runs on the rows
    placed in an ``[n, P]`` frame: on the CPU a lane's exp and log1p take
    the vector or the scalar path by its place in the buffer, so the rows
    get the bits they get inside the whole network's buffer (what
    ``consensus_network_plain`` computes)."""
    rows = slice(row0, row0 + mean.shape[0])
    prec = 1.0 / torch.square(softplus(_frame(rho, row0, n)))
    prec_x, pm_x = wire_cast_pair(prec[rows], prec[rows] * mean,
                                  canonical_wire_dtype(wire_dtype))
    return prec_x, pm_x


def consensus_shard_plain(W_rows, active, prec_x, pm_x, mean, rho, row0: int = 0):
    """The plain PyTorch version of ``consensus_fused_shard``: bitwise
    ``consensus_masked_plain``'s rows ``row0 ..`` where the other shards'
    rows of the statistics are the ones it reads.  It runs the network's
    shape, ``[N, N] @ [N, P]`` with the other shards' rows of W zero, and
    the epilogue on ``[N, P]``: a row of a ``[rows, N]`` product may take
    other bits from CPU BLAS than the same row of the ``[N, N]`` one, and a
    lane's transcendental ops other bits by its place in the buffer."""
    n_rows, n = W_rows.shape
    rows = slice(row0, row0 + n_rows)
    W = _frame(W_rows.to(torch.float32), row0, n)
    new_prec = torch.matmul(W, prec_x.to(torch.float32))
    new_pm = torch.matmul(W, pm_x.to(torch.float32))
    new_mean = (new_pm / new_prec)[rows]
    new_rho = softplus_inv(torch.rsqrt(new_prec))[rows]
    if active is None:
        return new_mean, new_rho
    act = _as_mask(active, n_rows, mean.device)[:, None]
    return torch.where(act, new_mean, mean), torch.where(act, new_rho, rho)


def _check_shard(what, prec_x, pm_x, mean, rho, row0: int) -> tuple[int, int, int]:
    """(rows, n, p) of a shard's call; raises on what the kernel does not take."""
    _check_flat(what, mean, rho)
    rows, p = mean.shape
    n = prec_x.shape[0]
    if (prec_x.dtype not in _WIRE_CODE or pm_x.dtype != prec_x.dtype
            or prec_x.shape != (n, p) or pm_x.shape != (n, p)
            or prec_x.device != mean.device or pm_x.device != mean.device
            or not (prec_x.is_contiguous() and pm_x.is_contiguous())):
        raise ValueError(f"{what}: prec_x/pm_x must be two contiguous [N, {p}] float32, bf16 "
                         f"or f16 buffers on {mean.device}")
    if not 0 <= row0 <= n - rows:
        raise ValueError(f"{what}: rows {row0}..{row0 + rows} outside the {n} agents")
    return rows, n, p


def consensus_shard_encode(mean, rho, prec_x, pm_x, *, row0: int = 0):
    """Encode a shard's own rows: ``mean``/``rho [rows, P]`` float32 become
    ``(prec_x, pm_x)`` in the buffers' wire dtype (float32, bf16 or f16),
    written into rows ``row0 .. row0 + rows`` of ``prec_x``/``pm_x [N,
    P]``, the shard's statistic buffers.  The CUDA kernel on the card
    (``csrc/consensus_shard.cu``), its plain version on the CPU."""
    name = "consensus_shard_encode"
    rows, n, p = _check_shard(name, prec_x, pm_x, mean, rho, row0)
    out = (prec_x[row0:row0 + rows], pm_x[row0:row0 + rows])
    if mean.device.type == "cpu":
        for dst, src in zip(out, consensus_shard_encode_plain(mean, rho, n, row0,
                                                              prec_x.dtype)):
            dst.copy_(src)
        return
    if mean.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {mean.device}")
    wire = _WIRE_CODE[prec_x.dtype]
    with torch.cuda.device(mean.device):
        lib = dispatch.library()
        wave = dispatch.wave(mean.device, "consensus_shard", lib.consensus_shard_blocks_per_sm,
                             0, wire)
        grid = launch_plan._grid(-(-rows * p // launch_plan.GENERIC_TILE), wave)
        err = lib.consensus_shard_encode_launch(
            mean.data_ptr(), rho.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), rows * p,
            wire, grid, _stream(mean.device),
        )
    dispatch.check_cuda(err, name)
    dispatch.count_launch(name)


def consensus_fused_shard(W_rows, active, prec_x, pm_x, mean, rho, *, row0: int = 0,
                          out=None):
    """Eq. (6) for one shard of a gossip window: ``W_rows [rows, N]`` its
    rows of W-tilde (float32), ``active [rows]`` their activity (None: all
    merge), ``prec_x``/``pm_x [N, P]`` the assembled wire statistics (rows
    of shards no rotation brought are zeros), ``mean``/``rho [rows, P]``
    its own rows, which are agents ``row0 ..``.  Returns the rows' new
    (mean, rho), into ``out`` if given.  Active rows are bitwise
    ``consensus_fused_masked``'s rows for the same statistics; idle rows
    are (mean, rho) untouched.  The CUDA kernel on the card, its plain
    version on the CPU."""
    name = "consensus_fused_shard"
    rows, n, p = _check_shard(name, prec_x, pm_x, mean, rho, row0)
    if W_rows.shape != (rows, n) or W_rows.device != mean.device \
            or W_rows.dtype != torch.float32:
        raise ValueError(f"{name}: W_rows must be float32 [{rows}, {n}] on {mean.device}, "
                         f"got {W_rows.dtype} {tuple(W_rows.shape)} on {W_rows.device}")
    if mean.device.type == "cpu":
        got = consensus_shard_plain(W_rows, active, prec_x, pm_x, mean, rho, row0)
        if out is None:
            return got
        for dst, src in zip(out, got):
            dst.copy_(src)
        return out
    if mean.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {mean.device}")
    act = None if active is None else _as_mask(active, rows, mean.device)
    if out is None:
        out = (torch.empty_like(mean), torch.empty_like(rho))
    _check_flat(name, mean, *out)
    wire = _WIRE_CODE[prec_x.dtype]
    W_rows = W_rows.contiguous()
    with torch.cuda.device(mean.device):
        lib = dispatch.library()
        wave = dispatch.wave(mean.device, "consensus_shard", lib.consensus_shard_blocks_per_sm,
                             1, wire)
        grid = launch_plan._grid(-(-p // launch_plan.GENERIC_TILE), wave)
        err = lib.consensus_shard_reduce_launch(
            W_rows.data_ptr(), None if act is None else act.data_ptr(),
            prec_x.data_ptr(), pm_x.data_ptr(), mean.data_ptr(), rho.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), rows, n, p, wire, grid, _stream(mean.device),
        )
    dispatch.check_cuda(err, name)
    dispatch.count_launch(name)
    return out


# -- exchange-payload validity ----------------------------------------------


def payload_validity_plain(mean, rho, *, bound, wire_dtype=None):
    """The plain PyTorch version of ``payload_validity_fused``."""
    wd = canonical_wire_dtype(wire_dtype)
    prec = 1.0 / torch.square(softplus(rho))
    prec_x = wire_roundtrip(prec, wd)
    pm_x = wire_roundtrip(prec * mean, wd)
    ok = (
        torch.isfinite(prec_x)
        & (prec_x > 0.0)
        & (prec_x <= bound)
        & torch.isfinite(pm_x)
        & (torch.abs(pm_x) <= bound)
    )
    return torch.all(ok, dim=-1)


def payload_validity_fused(mean, rho, *, bound, wire_dtype=None):
    """``[N]`` bool: is each agent's wire-rounded (prec, prec*mean) payload
    finite, positive and within ``bound``?  Bit-equal to the plain version.
    One device kernel per call, for any N with N * P < 2^63."""
    if mean.device.type == "cpu":
        return payload_validity_plain(mean, rho, bound=bound, wire_dtype=wire_dtype)
    if mean.device.type != "cuda":
        raise ValueError(f"payload_validity_fused: no kernel for {mean.device}")
    _check_flat("payload_validity_fused", mean, rho)
    n, p = mean.shape
    wire = _WIRE_CODE[canonical_wire_dtype(wire_dtype)]
    lib = dispatch.library()
    vec = stream_plan.vector_width(mean.data_ptr(), rho.data_ptr())
    wave = dispatch.wave(mean.device, "payload_validity", lib.payload_validity_blocks_per_sm,
                         wire, vec)
    plan = stream_plan.plan(n * p, stream_plan.VALIDITY, vec, wave)
    out = torch.empty(n + 2 * plan.chunks, dtype=torch.uint8, device=mean.device)
    err = lib.payload_validity_launch(
        mean.data_ptr(), rho.data_ptr(), out.data_ptr(), out.data_ptr() + n,
        dispatch.arrival_counter(mean.device).data_ptr(), n, p, float(bound), wire, plan.vec,
        plan.chunk, plan.grid, _stream(mean.device),
    )
    dispatch.check_cuda(err, "payload_validity_fused")
    dispatch.count_launch("payload_validity_fused")
    return out[:n].view(torch.bool)
