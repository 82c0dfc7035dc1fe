"""Plain reference of the ``repro-100m`` configuration: a dense pre-norm
decoder (RMSNorm, multi-head attention with RoPE and a causal mask,
SwiGLU MLP, untied output head), each agent a mean-field
Bayes-by-Backprop posterior over its float32 weights, trained with Adam
on the next-token loss plus ``kl_scale`` KL to the round's prior, and
merged by eq. (6).

Plain PyTorch, one agent at a time, autograd for the backward; it imports
nothing of the program.  Compute in bfloat16 as the configuration states:
matrix products of bfloat16 operands, norms, RoPE and the attention's
scores, softmax and sums in float32.  ``fp8=True`` is the control (the
nearest precision below): each product's operands rounded to float8 e4m3
with a per-tensor scale first.

The weights are the benchmark's: ``make_params`` draws one agent's
parameters from a seeded generator in one call.  The flat noise ``eps
[A, P]`` lays the leaves out in sorted key-path order, each leaf
row-major (``leaf_slices``).
"""
from __future__ import annotations

import math

import torch

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
FP8_MAX = 448.0  # float8 e4m3's largest finite value


def shapes(cfg: dict) -> dict:
    """Leaf path -> shape, the stacked layers as ``[n_layers, 1, ...]``."""
    d, f, v, L = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"], cfg["n_layers"]
    hq, hk = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    lead = (L, 1)
    return {
        "embed.emb": (v, d),
        "final_norm.scale": (d,),
        "lm_head.w": (d, v),
        "stacks.attn.attn.wk": lead + (d, hk),
        "stacks.attn.attn.wo": lead + (hq, d),
        "stacks.attn.attn.wq": lead + (d, hq),
        "stacks.attn.attn.wv": lead + (d, hk),
        "stacks.attn.mlp.w_down": lead + (f, d),
        "stacks.attn.mlp.w_gate": lead + (d, f),
        "stacks.attn.mlp.w_up": lead + (d, f),
        "stacks.attn.norm1.scale": lead + (d,),
        "stacks.attn.norm2.scale": lead + (d,),
    }


def leaf_slices(cfg: dict) -> dict:
    out, off = {}, 0
    for k, shp in sorted(shapes(cfg).items()):
        n = math.prod(shp)
        out[k] = (off, off + n, shp)
        off += n
    return out


def n_params(cfg: dict) -> int:
    return sum(math.prod(s) for s in shapes(cfg).values())


def make_params(cfg: dict, generator: torch.Generator, device) -> dict:
    """One agent's weights, a flat dict by leaf path: 0.02 N(0, 1) for the
    embedding, N(0, 1) / sqrt(fan_in) for each matrix, ones for the norm
    scales; one draw for all of them."""
    flat = torch.randn(n_params(cfg), generator=generator, device=device)
    out = {}
    for k, (a, b, shp) in leaf_slices(cfg).items():
        leaf = flat[a:b].reshape(shp)
        if k.endswith("scale"):
            leaf = torch.ones_like(leaf)
        elif k == "embed.emb":
            leaf = leaf * 0.02
        else:
            leaf = leaf / math.sqrt(shp[-2])
        out[k] = leaf
    return out


def nest(flat: dict) -> dict:
    """A flat dict by leaf path -> the nested parameter dict."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softplus_inv(y):
    return y + torch.log(-torch.expm1(-y))


def _fp8(x):
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.float()).detach().to(x.dtype)  # rounded forward, straight-through backward


def _mm(x, w, fp8: bool):
    w = w.to(torch.bfloat16)
    if fp8:
        x, w = _fp8(x), _fp8(w)
    return x @ w


def _rmsnorm(x, scale, eps):
    x32 = x.float()
    out = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def _rope(x, theta: float):
    s, half = x.shape[-3], x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def nll_sum(theta: dict, cfg: dict, tokens, targets, fp8: bool = False):
    """Summed next-token cross-entropy of one agent's batch
    (``tokens``/``targets [B, S]``) at the weights ``theta`` (flat dict)."""
    dt, eps = torch.bfloat16, cfg["norm_eps"]
    b, s = tokens.shape
    h, hd = cfg["n_heads"], cfg["head_dim"]
    x = theta["embed.emb"][tokens.long()].to(dt)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    for layer in range(cfg["n_layers"]):
        p = {k.removeprefix("stacks.attn."): v[layer, 0] for k, v in theta.items()
             if k.startswith("stacks.attn.")}
        a = _rmsnorm(x, p["norm1.scale"], eps)
        q = _rope(_mm(a, p["attn.wq"], fp8).reshape(b, s, h, hd), cfg["rope_theta"])
        k = _rope(_mm(a, p["attn.wk"], fp8).reshape(b, s, -1, hd), cfg["rope_theta"])
        v = _mm(a, p["attn.wv"], fp8).reshape(b, s, -1, hd)
        qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
        scores = (qf @ kf.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        o = (probs @ vf).transpose(1, 2).to(dt).reshape(b, s, h * hd)
        x = x + _mm(o, p["attn.wo"], fp8)
        a2 = _rmsnorm(x, p["norm2.scale"], eps)
        mlp = torch.nn.functional.silu(_mm(a2, p["mlp.w_gate"], fp8)) * _mm(a2, p["mlp.w_up"], fp8)
        x = x + _mm(mlp, p["mlp.w_down"], fp8)
    x = _rmsnorm(x, theta["final_norm.scale"], eps)
    logits = _mm(x, theta["lm_head.w"], fp8).float()
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


class Agents:
    """A agents' posteriors (mean, rho) and Adam moments, flat dicts by leaf."""

    def __init__(self, cfg: dict, params: dict, n: int):
        sig = cfg["init_sigma"]
        rho0 = sig + math.log(-math.expm1(-sig))
        self.cfg, self.n = cfg, n
        self.mean = [{k: v.clone() for k, v in params.items()} for _ in range(n)]
        self.rho = [{k: torch.full_like(v, rho0) for k, v in params.items()} for _ in range(n)]
        self.m = [{(part, k): torch.zeros_like(v) for part in ("mean", "rho")
                   for k, v in params.items()} for _ in range(n)]
        self.v = [{key: torch.zeros_like(t) for key, t in m.items()} for m in self.m]
        self.step = 0


def local_step(ag: Agents, prior, tokens, eps, lr: float, fp8=False, faults=()):
    """One Bayes-by-Backprop step of every agent against ``prior`` (lists
    of flat dicts), on ``tokens [A, B, S + 1]`` and the flat noise ``eps
    [A, P]``: the objective is the mean over agents of (NLL / tokens +
    kl_scale KL(q || prior) / tokens); Adam.  Returns the objective."""
    cfg = ag.cfg
    spans = leaf_slices(cfg)
    total = 0.0
    ag.step += 1
    bc1, bc2 = 1.0 - B1 ** ag.step, 1.0 - B2 ** ag.step
    for a in range(ag.n):
        inp, tgt = tokens[a, :, :-1], tokens[a, :, 1:]
        if "half_batch" in faults:  # a planted fault: half the rows, their mean
            inp, tgt = inp[: inp.shape[0] // 2], tgt[: tgt.shape[0] // 2]
        ntok = float(inp.numel())
        q_mean = {k: t.detach().requires_grad_(True) for k, t in ag.mean[a].items()}
        q_rho = {k: t.detach().requires_grad_(True) for k, t in ag.rho[a].items()}
        with torch.enable_grad():
            theta = {k: q_mean[k] + softplus(q_rho[k]) * eps[a, s0:s1].reshape(shp)
                     for k, (s0, s1, shp) in spans.items()}
            kl = 0.0
            for k in theta:
                sq, sp = softplus(q_rho[k]), softplus(prior[a][1][k])
                kl = kl + torch.sum(torch.log(sp / sq) + (sq * sq + (q_mean[k] - prior[a][0][k])
                                                          ** 2) / (2 * sp * sp) - 0.5)
            loss = nll_sum(theta, cfg, inp, tgt, fp8) / ntok + cfg["kl_scale"] * kl / ntok
            keys = list(spans)
            grads = torch.autograd.grad(loss / ag.n, [q_mean[k] for k in keys]
                                        + [q_rho[k] for k in keys])
        total += float(loss.detach()) / ag.n
        if "unchanged" in faults:
            continue
        for (part, k), g in zip([("mean", k) for k in keys] + [("rho", k) for k in keys], grads):
            m = B1 * ag.m[a][(part, k)] + (1 - B1) * g
            v = B2 * ag.v[a][(part, k)] + (1 - B2) * g * g
            ag.m[a][(part, k)], ag.v[a][(part, k)] = m, v
            buf = ag.mean[a] if part == "mean" else ag.rho[a]
            buf[k] = buf[k] + (-lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
    return total


def consensus(ag: Agents, W):
    """Eq. (6): each agent's W-weighted sum of the agents' precisions and
    precision-weighted means (float32)."""
    new_mean = [dict() for _ in range(ag.n)]
    new_rho = [dict() for _ in range(ag.n)]
    for k in ag.mean[0]:
        prec = [1.0 / softplus(ag.rho[j][k]) ** 2 for j in range(ag.n)]
        for i in range(ag.n):
            tp = sum(float(W[i][j]) * prec[j] for j in range(ag.n))
            tpm = sum(float(W[i][j]) * prec[j] * ag.mean[j][k] for j in range(ag.n))
            new_mean[i][k] = tpm / tp
            new_rho[i][k] = softplus_inv(torch.sqrt(1.0 / tp))
    ag.mean, ag.rho = new_mean, new_rho
