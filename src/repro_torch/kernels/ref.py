"""Plain PyTorch oracles of the kernels behind ``kernels.ops`` (port of
``repro.kernels.ref``), in the reference's exact op forms.

These are the allclose references of the tests, not the kernels' plain
versions: ``consensus_ref`` writes softplus^-1 as ``s + log1p(-exp(-s))``
with ``s = 1 / sqrt(prec)``, where the kernels use ``rsqrt`` and the
``expm1`` form, and ``attention_ref`` gives a row with no key left the
uniform average over its ``-1e30`` scores, where the kernel gives 0.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.numerics import softplus


def consensus_ref(w_row, mean_stack, rho_stack):
    """Eq. (6) for one agent over a flat block: ``w_row [N]``,
    ``mean_stack``/``rho_stack [N, P]`` -> (mean, rho) ``[P]``."""
    sigma = softplus(rho_stack)
    prec = 1.0 / torch.square(sigma)
    wp = w_row[:, None] * prec
    prec_out = torch.sum(wp, dim=0)
    mean_out = torch.sum(wp * mean_stack, dim=0) / prec_out
    sigma_out = 1.0 / torch.sqrt(prec_out)
    rho_out = sigma_out + torch.log1p(-torch.exp(-sigma_out))
    return mean_out, rho_out


def sample_and_kl_ref(mu, rho, eps, mu_p, rho_p):
    """Reparameterized sample + closed-form Gaussian KL (see gauss_vi)."""
    sq = softplus(rho)
    sp = softplus(rho_p)
    theta = mu + sq * eps
    d = mu - mu_p
    kl = torch.sum(
        torch.log(sp / sq) + (torch.square(sq) + torch.square(d)) / (2.0 * torch.square(sp))
        - 0.5
    )
    return theta, kl


def attention_ref(q, k, v, *, causal=True, window=0):
    """Naive full-materialization attention.  q: [B,H,S,hd], k/v: [B,H,Sk,hd]."""
    s, hd = q.shape[2], q.shape[3]
    sk = k.shape[2]
    s_mat = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    q_idx = torch.arange(s, device=q.device)[:, None]
    k_idx = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_idx <= q_idx)
    if window:
        mask = mask & (k_idx > q_idx - window)
    s_mat = torch.where(mask[None, None], s_mat, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s_mat, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
