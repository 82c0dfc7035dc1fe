"""Fused Bayes-by-Backprop sample + KL over flat ``[P]`` buffers, beside its
plain PyTorch version (port of ``repro.kernels.gauss_vi``).

One pass over the posterior (mu, rho), the prior (mu_p, rho_p) and the
standard-normal noise eps gives both

    theta = mu + softplus(rho) * eps                (reparameterized sample)
    kl    = sum [ log(sp/sq) + (sq^2+(mq-mp)^2)/(2 sp^2) - 1/2 ]

``softplus`` is the ``logaddexp(x, 0)`` form of ``core.numerics``.  The CUDA
kernel (``csrc/gauss_vi.cu``) is one launch, planned by ``stream_plan``: it
writes theta and one KL partial per chunk, and its last block sums the
partials in a fixed order (the JAX wrapper sums the Pallas kernel's
partials outside the kernel).  Forward only, as the TPU kernel is.

The wrapper takes the plain version only for tensors on the CPU.  A CUDA
tensor launches the kernel on the current stream or raises: there is no
fallback.  A launch adds one to ``sample_and_kl_fused``'s counter in
``dispatch``.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import softplus
from repro_torch.kernels import dispatch, stream_plan


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
    ptrs = [t.data_ptr() for t in (mu, rho, eps, mu_p, rho_p, theta)]
    vec = stream_plan.vector_width(*ptrs)
    wave = dispatch.wave(mu.device, "sample_and_kl", lib.sample_and_kl_blocks_per_sm, vec)
    plan = stream_plan.plan(p, stream_plan.SAMPLE_KL, vec, wave)
    out = torch.empty(1 + plan.chunks, dtype=torch.float32, device=mu.device)  # KL, partials
    err = lib.sample_and_kl_launch(
        *ptrs, out.data_ptr(), out.data_ptr() + 4, dispatch.arrival_counter(mu.device).data_ptr(),
        p, plan.vec, plan.chunk, plan.grid, torch.cuda.current_stream(mu.device).cuda_stream,
    )
    dispatch.check_cuda(err, "sample_and_kl_fused")
    dispatch.count_launch("sample_and_kl_fused")
    return theta, out[0]
