"""Eq. (6) kernels over the flat [N, P] network posterior, each beside its
plain PyTorch version (port of the ``repro.kernels.consensus`` kernels on the
synchronous round's and the gossip windows' paths).

* ``consensus_fused_network``: eq. (6) for all N agents in one pass,

      prec_j = softplus(rho_j)^-2
      prec_x, pm_x = wire(prec_j), wire(prec_j * mean_j)
      new_prec = W @ prec_x,  new_pm = W @ pm_x         (fp32 accumulation)
      mean' = new_pm / new_prec,  rho' = softplus^-1(new_prec^-1/2)

  CUDA source: ``csrc/consensus_network.cu``.
* ``consensus_fused_masked``: the same pass on one gossip window's W-tilde
  with an ``[N]`` activity mask.  Active rows are bitwise the network
  kernel's rows (one template, one accumulation loop); inactive rows pass
  (mean, rho) through untouched.  CUDA source: ``csrc/consensus_network.cu``.
* ``consensus_fused_sparse`` / ``consensus_fused_masked_sparse``: eq. (6)
  over CSR neighbour tables (``neighbors [N, D]`` self-padded ids,
  ``weights [N, D]`` zero-padded): each agent gathers only its deg(i) rows;
  the masked form copies an inactive agent's own row.  The plain versions
  rebuild the small dense W from the tables, as the JAX package's reference
  path does.  CUDA source: ``csrc/consensus_sparse.cu``.
* ``payload_validity_fused``: per agent, every wire-rounded ``prec`` and
  ``prec * mean`` lane finite, ``prec > 0`` and both within ``bound``.
  CUDA source: ``csrc/payload_validity.cu``.

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
    wire_roundtrip,
)
from repro_torch.kernels import dispatch

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


def consensus_fused_network(W, mean, rho, *, wire_dtype=None):
    """Eq. (6) for every agent: ``W [N, N]`` row-stochastic, ``mean``/``rho``
    ``[N, P]`` float32.  Returns the new (mean, rho), both ``[N, P]``."""
    if mean.device.type == "cpu":
        return consensus_network_plain(W, mean, rho, wire_dtype)
    if mean.device.type != "cuda":
        raise ValueError(f"consensus_fused_network: no kernel for {mean.device}")
    _check_flat("consensus_fused_network", mean, rho)
    n, p = mean.shape
    if W.shape != (n, n) or W.device != mean.device or W.dtype != torch.float32:
        raise ValueError(
            f"consensus_fused_network: W must be float32 [{n}, {n}] on "
            f"{mean.device}, got {W.dtype} {tuple(W.shape)} on {W.device}"
        )
    W = W.contiguous()
    mean_out = torch.empty_like(mean)
    rho_out = torch.empty_like(rho)
    err = dispatch.library().consensus_network_launch(
        W.data_ptr(), mean.data_ptr(), rho.data_ptr(),
        mean_out.data_ptr(), rho_out.data_ptr(), n, p,
        _WIRE_CODE[canonical_wire_dtype(wire_dtype)], _stream(mean.device),
    )
    dispatch.check_cuda(err, "consensus_fused_network")
    dispatch.count_launch("consensus_fused_network")
    return mean_out, rho_out


def _as_mask(active, n: int, device: torch.device) -> torch.Tensor:
    """``[N]`` bool from a bool/int/float mask (nonzero = active)."""
    act = torch.as_tensor(active, device=device)
    if act.shape != (n,):
        raise ValueError(f"active mask of shape {tuple(act.shape)}, expected ({n},)")
    return act > 0


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
    if mean.device.type != "cuda":
        raise ValueError(f"consensus_fused_masked: no kernel for {mean.device}")
    _check_flat("consensus_fused_masked", mean, rho)
    n, p = mean.shape
    if W.shape != (n, n) or W.device != mean.device or W.dtype != torch.float32:
        raise ValueError(
            f"consensus_fused_masked: W must be float32 [{n}, {n}] on "
            f"{mean.device}, got {W.dtype} {tuple(W.shape)} on {W.device}"
        )
    W = W.contiguous()
    act = _as_mask(active, n, mean.device).to(torch.int32)
    mean_out = torch.empty_like(mean)
    rho_out = torch.empty_like(rho)
    err = dispatch.library().consensus_masked_launch(
        W.data_ptr(), act.data_ptr(), mean.data_ptr(), rho.data_ptr(),
        mean_out.data_ptr(), rho_out.data_ptr(), n, p,
        _WIRE_CODE[canonical_wire_dtype(wire_dtype)], _stream(mean.device),
    )
    dispatch.check_cuda(err, "consensus_fused_masked")
    dispatch.count_launch("consensus_fused_masked")
    return mean_out, rho_out


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


def _sparse_launch(name, neighbors, weights, active, mean, rho, wire_dtype):
    if mean.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {mean.device}")
    _check_flat(name, mean, rho)
    n, p = mean.shape
    if n > 65535:
        raise ValueError(f"{name}: N={n} exceeds 65535 agents")
    nbr, wts = csr_tables(name, neighbors, weights, n, mean.device)
    mean_out = torch.empty_like(mean)
    rho_out = torch.empty_like(rho)
    args = [nbr.data_ptr(), wts.data_ptr()]
    if active is not None:
        act = _as_mask(active, n, mean.device).to(torch.int32)
        args.append(act.data_ptr())
    launch = getattr(dispatch.library(),
                     "consensus_masked_sparse_launch" if active is not None
                     else "consensus_sparse_launch")
    err = launch(
        *args, mean.data_ptr(), rho.data_ptr(), mean_out.data_ptr(), rho_out.data_ptr(),
        n, nbr.shape[1], p, _WIRE_CODE[canonical_wire_dtype(wire_dtype)],
        _stream(mean.device),
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
    finite, positive and within ``bound``?  Bit-equal to the plain version."""
    if mean.device.type == "cpu":
        return payload_validity_plain(mean, rho, bound=bound, wire_dtype=wire_dtype)
    if mean.device.type != "cuda":
        raise ValueError(f"payload_validity_fused: no kernel for {mean.device}")
    _check_flat("payload_validity_fused", mean, rho)
    n, p = mean.shape
    if n > 65535:
        raise ValueError(f"payload_validity_fused: N={n} exceeds 65535 agents")
    ok = torch.ones(n, dtype=torch.int32, device=mean.device)
    err = dispatch.library().payload_validity_launch(
        mean.data_ptr(), rho.data_ptr(), ok.data_ptr(), n, p, float(bound),
        _WIRE_CODE[canonical_wire_dtype(wire_dtype)], _stream(mean.device),
    )
    dispatch.check_cuda(err, "payload_validity_fused")
    dispatch.count_launch("payload_validity_fused")
    return ok.bool()
