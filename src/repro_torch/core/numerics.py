"""Shared numerical primitives for Gaussian posteriors (port of
``repro.core.numerics``).

``softplus`` is the ``logaddexp(x, 0)`` form and ``softplus_inv`` the
``y + log(-expm1(-y))`` form, the same pair the JAX package uses everywhere:

* tiny y (sigma -> 0): the naive ``y + log1p(-exp(-y))`` form rounds
  ``-exp(-y)`` to -1 and returns -inf one ulp too early; the ``expm1`` form
  keeps full precision down to y ~ 1e-38.
* huge y (sigma >> 1): exp(-y) underflows to 0 and the result is exactly y,
  the correct asymptote.

Wire dtypes: the consensus round exchanges the sufficient statistics
(prec, prec*mu), optionally rounded through bf16 or f16 at the exchange
boundary and accumulated in fp32.  ``"f32"`` is a STRUCTURAL no-op:
``wire_roundtrip`` returns its input tensor itself.
"""
from __future__ import annotations

import math

import torch

# canonical compute dtype for flat posterior buffers and kernel wrappers
COMPUTE_DTYPE = torch.float32

WIRE_DTYPES = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
    "f16": torch.float16,
}

# unit roundoff u = eps/2 of round-to-nearest into the wire dtype: one cast
# perturbs each exchanged scalar by a relative error <= u
WIRE_UNIT_ROUNDOFF = {
    "f32": 0.0,
    "bf16": 2.0 ** -8,  # bf16: 7 stored mantissa bits, eps = 2^-7
    "f16": 2.0 ** -11,  # f16: 10 stored mantissa bits, eps = 2^-10
}


def canonical_wire_dtype(wire_dtype) -> torch.dtype:
    """Normalize a wire-dtype spec (``None`` | ``"f32"|"bf16"|"f16"`` | a
    ``torch.dtype``) to the torch dtype.  ``None`` means uncompressed (f32);
    any other dtype is rejected like an unknown name."""
    if wire_dtype is None:
        return torch.float32
    if isinstance(wire_dtype, str):
        if wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"unknown wire_dtype {wire_dtype!r}; known: {sorted(WIRE_DTYPES)}"
            )
        return WIRE_DTYPES[wire_dtype]
    if wire_dtype in WIRE_DTYPES.values():
        return wire_dtype
    raise ValueError(
        f"unsupported wire_dtype {wire_dtype!r}; known: "
        f"{sorted(WIRE_DTYPES)} (or their dtypes)"
    )


def wire_dtype_name(wire_dtype) -> str:
    """The spec-string name of a wire dtype (inverse of
    ``canonical_wire_dtype``)."""
    dt = canonical_wire_dtype(wire_dtype)
    return next(name for name, cand in WIRE_DTYPES.items() if cand == dt)


def wire_itemsize(wire_dtype) -> int:
    """Bytes per exchanged scalar at this wire dtype."""
    return canonical_wire_dtype(wire_dtype).itemsize


def wire_error_bound(wire_dtype) -> float:
    """Unit roundoff u of one cast into the wire dtype (0.0 for f32)."""
    return WIRE_UNIT_ROUNDOFF[wire_dtype_name(wire_dtype)]


def wire_roundtrip(x: torch.Tensor, wire_dtype) -> torch.Tensor:
    """Round ``x`` through the wire dtype (round to nearest even) and decode
    back to its own dtype.  STRUCTURAL no-op for f32: returns ``x`` itself."""
    wd = canonical_wire_dtype(wire_dtype)
    if wd == x.dtype:
        return x
    return x.to(wd).to(x.dtype)


def wire_cast_pair(prec: torch.Tensor, pm: torch.Tensor, wire_dtype):
    """Cast the (prec, prec*mu) sufficient-statistic pair to the wire dtype
    for a real exchange (the payload stays compressed on the wire; the
    receiver casts back and accumulates in fp32).  Identity for f32: returns
    its inputs themselves."""
    wd = canonical_wire_dtype(wire_dtype)
    if wd == prec.dtype:
        return prec, pm
    return prec.to(wd), pm.to(wd)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)`` against a broadcast 0-d zero: the same bits as a
    full zero tensor, without one more [N, P] buffer (autograd saves the
    second operand)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softplus_inv(y: torch.Tensor) -> torch.Tensor:
    """Inverse of softplus for y > 0, in the stable ``expm1`` form."""
    return y + torch.log(-torch.expm1(-y))


def softplus_inv_py(y: float) -> float:
    """Pure-Python softplus^-1 (same formulation), for host-side constants."""
    return y + math.log(-math.expm1(-y))
