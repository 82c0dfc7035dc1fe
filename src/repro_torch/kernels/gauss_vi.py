"""Fused Bayes-by-Backprop sample + KL over flat ``[P]`` buffers, beside its
plain PyTorch version (port of ``repro.kernels.gauss_vi``).

One pass over the posterior (mu, rho), the prior (mu_p, rho_p) and the
standard-normal noise eps gives both

    theta = mu + softplus(rho) * eps                (reparameterized sample)
    kl    = sum [ log(sp/sq) + (sq^2+(mq-mp)^2)/(2 sp^2) - 1/2 ]

``softplus`` is the ``logaddexp(x, 0)`` form of ``core.numerics``.  The CUDA
kernel (``csrc/gauss_vi.cu``) writes one KL partial per block, summed here
outside the kernel, as the JAX wrapper sums the Pallas kernel's partials.
Forward only, as the TPU kernel is.

The wrapper takes the plain version only for tensors on the CPU.  A CUDA
tensor launches the kernel on the current stream or raises: there is no
fallback.  A launch adds one to ``sample_and_kl_fused``'s counter in
``dispatch``.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import softplus
from repro_torch.kernels import dispatch


def sample_and_kl_plain(mu, rho, eps, mu_p, rho_p):
    """The plain PyTorch version of ``sample_and_kl_fused``."""
    sq = softplus(rho)
    sp = softplus(rho_p)
    theta = mu + sq * eps
    d = mu - mu_p
    kl = torch.log(sp / sq) + (sq * sq + d * d) / (2.0 * sp * sp) - 0.5
    return theta, torch.sum(kl)


def sample_and_kl_fused(mu, rho, eps, mu_p, rho_p):
    """``(theta [P], kl scalar)`` from five float32 ``[P]`` buffers."""
    if mu.device.type == "cpu":
        return sample_and_kl_plain(mu, rho, eps, mu_p, rho_p)
    if mu.device.type != "cuda":
        raise ValueError(f"sample_and_kl_fused: no kernel for {mu.device}")
    for t in (mu, rho, eps, mu_p, rho_p):
        if t.device != mu.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("sample_and_kl_fused: expects contiguous float32 tensors on "
                             f"{mu.device}, got {t.dtype} on {t.device}")
        if t.ndim != 1 or t.shape != mu.shape or t.numel() == 0:
            raise ValueError(f"sample_and_kl_fused: expects five non-empty [P] buffers, "
                             f"got {tuple(t.shape)} and {tuple(mu.shape)}")
    lib = dispatch.library()
    p = mu.shape[0]
    theta = torch.empty_like(mu)
    parts = torch.empty(lib.sample_and_kl_grid(p), dtype=torch.float32, device=mu.device)
    err = lib.sample_and_kl_launch(
        mu.data_ptr(), rho.data_ptr(), eps.data_ptr(), mu_p.data_ptr(), rho_p.data_ptr(),
        theta.data_ptr(), parts.data_ptr(), p,
        torch.cuda.current_stream(mu.device).cuda_stream,
    )
    dispatch.check_cuda(err, "sample_and_kl_fused")
    dispatch.count_launch("sample_and_kl_fused")
    return theta, torch.sum(parts)
