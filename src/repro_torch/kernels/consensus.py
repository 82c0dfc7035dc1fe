"""Eq. (6) kernels over the flat [N, P] network posterior, each beside its
plain PyTorch version (port of the two ``repro.kernels.consensus`` kernels on
the synchronous round's path).

* ``consensus_fused_network``: eq. (6) for all N agents in one pass,

      prec_j = softplus(rho_j)^-2
      prec_x, pm_x = wire(prec_j), wire(prec_j * mean_j)
      new_prec = W @ prec_x,  new_pm = W @ pm_x         (fp32 accumulation)
      mean' = new_pm / new_prec,  rho' = softplus^-1(new_prec^-1/2)

  CUDA source: ``csrc/consensus_network.cu``.
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
