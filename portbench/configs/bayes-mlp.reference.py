"""Plain reference of the ``bayes-mlp`` configuration: the paper's
784-200-200-10 ReLU MLP trained per agent as a mean-field Bayes-by-Backprop
posterior (Blundell et al.; the paper's Remark 1, eq. (5)) with Adam, and
merged by eq. (6) over a dense W or over an edge list with quarantine.

Plain PyTorch on dicts of per-leaf tensors with a leading agent axis,
written from the paper's equations; it imports nothing of the program.
Float32 with TF32 off, as the configuration states; ``tf32=True`` is the
control (the nearest precision below).

The weights are the benchmark's: ``make_params`` draws one agent's
parameters from a seeded generator in one call, and both the program and
this reference start every agent from them.  The flat noise ``eps [N, u,
1, P]`` both sides are handed lays the leaves out in sorted key order
(``b1, b2, b3, w1, w2, w3``), each leaf row-major: ``leaf_slices``.
"""
from __future__ import annotations

import contextlib
import math

import torch

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def shapes(config: dict) -> dict:
    sizes = [config["dim"]] + [config["hidden"]] * config["depth"] + [config["n_classes"]]
    out = {}
    for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:]), 1):
        out[f"w{i}"] = (fi, fo)
        out[f"b{i}"] = (fo,)
    return out


def leaf_slices(config: dict) -> dict:
    """Column span of each leaf in the flat noise, sorted key order."""
    out, off = {}, 0
    for k, shp in sorted(shapes(config).items()):
        n = math.prod(shp)
        out[k] = (off, off + n, shp)
        off += n
    return out


def n_params(config: dict) -> int:
    return sum(math.prod(s) for s in shapes(config).values())


def make_params(config: dict, generator: torch.Generator, device) -> dict:
    """One agent's weights: N(0, 1) / sqrt(fan_in) for each matrix, drawn
    in one call; zero biases."""
    shp = shapes(config)
    mats = [k for k in sorted(shp) if k.startswith("w")]
    total = sum(math.prod(shp[k]) for k in mats)
    flat = torch.randn(total, generator=generator, device=device)
    params, off = {}, 0
    for k in mats:
        n = math.prod(shp[k])
        params[k] = flat[off:off + n].reshape(shp[k]) / math.sqrt(shp[k][0])
        off += n
    for k in shp:
        if k.startswith("b"):
            params[k] = torch.zeros(shp[k], device=device)
    return params


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softplus_inv(y):
    return y + torch.log(-torch.expm1(-y))


@contextlib.contextmanager
def precision(tf32: bool):
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


class Network:
    """N agents' posteriors (mean, rho) and Adam moments, leaf by leaf."""

    def __init__(self, config: dict, params: dict, n: int, device):
        sig = config["init_sigma"]
        rho0 = sig + math.log(-math.expm1(-sig))
        self.config = config
        self.mean = {k: v.expand((n,) + tuple(v.shape)).clone() for k, v in params.items()}
        self.rho = {k: torch.full_like(v, rho0) for k, v in self.mean.items()}
        self.m = {("mean", k): torch.zeros_like(v) for k, v in self.mean.items()}
        self.m.update({("rho", k): torch.zeros_like(v) for k, v in self.mean.items()})
        self.v = {k: torch.zeros_like(v) for k, v in self.m.items()}
        self.step = torch.zeros(n, dtype=torch.int64, device=device)
        self.n = n

    def leaves(self):
        for k in sorted(self.mean):
            yield k


def _logits(theta: dict, x, depth: int):
    h = x
    for i in range(1, depth + 1):
        h = torch.relu(torch.bmm(h, theta[f"w{i}"]) + theta[f"b{i}"].unsqueeze(1))
    return torch.bmm(h, theta[f"w{depth + 1}"]) + theta[f"b{depth + 1}"].unsqueeze(1)


def _free_energy(mean, rho, prior_mean, prior_rho, x, y, eps: dict, config, half_batch=False):
    """Per-agent kl_scale * KL(q || prior) + the summed cross-entropy of
    the batch at theta = mean + softplus(rho) eps."""
    theta = {k: mean[k] + softplus(rho[k]) * eps[k] for k in mean}
    if half_batch:  # a planted fault: half the batch, the sum scaled up
        x, y = x[:, : x.shape[1] // 2], y[:, : y.shape[1] // 2]
    logits = _logits(theta, x, config["depth"])
    nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, y.long().unsqueeze(-1))[..., 0]
    nll = nll.sum(-1) * (2.0 if half_batch else 1.0)
    kl = 0.0
    for k in mean:
        sq, sp = softplus(rho[k]), softplus(prior_rho[k])
        t = torch.log(sp / sq) + (sq ** 2 + (mean[k] - prior_mean[k]) ** 2) / (2 * sp ** 2) - 0.5
        kl = kl + t.reshape(t.shape[0], -1).sum(-1)
    return config["kl_scale"] * kl + nll


def local_steps(net: Network, batches, eps_round, lr: float, train, block: int = 512,
                faults=()):
    """The round's u Bayes-by-Backprop steps of every agent in ``train``
    ([N] bool), each against the round-start posterior.  ``batches``:
    ``x [N, u, B, dim]``, ``y [N, u, B]``; ``eps_round [N, u, 1, P]`` the
    flat noise.  Returns the per-agent mean loss over the steps (NaN where
    an agent does not train)."""
    cfg = net.config
    spans = leaf_slices(cfg)
    prior_mean = {k: v.clone() for k, v in net.mean.items()}
    prior_rho = {k: v.clone() for k, v in net.rho.items()}
    u = batches["x"].shape[1]
    losses = torch.zeros((net.n, u), dtype=torch.float64, device=batches["x"].device)
    for t in range(u):
        for s in range(0, net.n, block):
            rows = slice(s, min(s + block, net.n))
            q_mean = {k: net.mean[k][rows].detach().requires_grad_(True) for k in net.leaves()}
            q_rho = {k: net.rho[k][rows].detach().requires_grad_(True) for k in net.leaves()}
            e = eps_round[rows, t, 0]
            eps = {k: e[:, a:b].reshape((e.shape[0],) + shp) for k, (a, b, shp) in spans.items()}
            with torch.enable_grad():
                f = _free_energy(q_mean, q_rho, {k: v[rows] for k, v in prior_mean.items()},
                                 {k: v[rows] for k, v in prior_rho.items()},
                                 batches["x"][rows, t], batches["y"][rows, t], eps, cfg,
                                 half_batch="half_batch" in faults)
                keys = list(net.leaves())
                grads = torch.autograd.grad(f.sum(), [q_mean[k] for k in keys]
                                            + [q_rho[k] for k in keys])
            losses[rows, t] = f.detach().double()
            tr = train[rows]
            tt = (net.step[rows] + 1).double()
            bc1 = (1.0 - B1 ** tt).float()
            bc2 = (1.0 - B2 ** tt).float()
            for (part, k), g in zip([("mean", k) for k in keys] + [("rho", k) for k in keys],
                                    grads):
                m = B1 * net.m[(part, k)][rows] + (1 - B1) * g
                v = B2 * net.v[(part, k)][rows] + (1 - B2) * g * g
                lead = (-1,) + (1,) * (g.ndim - 1)
                upd = -lr * (m / bc1.reshape(lead)) / (torch.sqrt(v / bc2.reshape(lead))
                                                       + ADAM_EPS)
                sel = tr.reshape(lead)
                buf = net.mean if part == "mean" else net.rho
                net.m[(part, k)][rows] = torch.where(sel, m, net.m[(part, k)][rows])
                net.v[(part, k)][rows] = torch.where(sel, v, net.v[(part, k)][rows])
                buf[k][rows] = torch.where(sel, buf[k][rows] + upd, buf[k][rows])
            net.step[rows] += tr.long()
    out = losses.mean(dim=1)
    out[~train] = float("nan")
    return out


def consensus_dense(net: Network, W: torch.Tensor):
    """Eq. (6) at every agent: the W-weighted sum of the neighbours'
    precisions and precision-weighted means (float32 products, as the
    configuration states)."""
    W = W.float()
    for k in net.leaves():
        m, r = net.mean[k], net.rho[k]
        shp = m.shape
        prec = 1.0 / softplus(r.reshape(shp[0], -1)) ** 2
        pm = prec * m.reshape(shp[0], -1)
        new_prec = W @ prec
        new_pm = W @ pm
        net.mean[k] = (new_pm / new_prec).reshape(shp)
        net.rho[k] = softplus_inv(torch.sqrt(1.0 / new_prec)).reshape(shp)


def consensus_edges(net: Network, window, corrupt, chunk: int = 8192) -> int:
    """Eq. (6) over one window's fired edges at the rows that merge; a
    corrupted sender's edges are dropped (quarantine) and their weight
    moves to the receiver's self term.  Sums in float64, ``chunk``
    columns at a time.  Returns the number of dropped edges."""
    dev = net.step.device
    valid = ~corrupt[window.src]
    w = torch.as_tensor(window.weights.astype("float64"), device=dev)
    dst = torch.as_tensor(window.dst, device=dev)
    src = torch.as_tensor(window.src, device=dev)
    vmask = torch.as_tensor(valid, device=dev)
    drop = torch.zeros(net.n, dtype=torch.float64, device=dev)
    drop.index_add_(0, dst[~vmask], w[~vmask])
    w_self = torch.as_tensor(window.self_weight, device=dev).float().double() + drop
    act = torch.as_tensor(window.active, device=dev)
    dst, src, w = dst[vmask], src[vmask], w[vmask]
    for k in net.leaves():
        shp = net.mean[k].shape
        m2, r2 = net.mean[k].reshape(shp[0], -1), net.rho[k].reshape(shp[0], -1)
        for c in range(0, m2.shape[1], chunk):
            cols = slice(c, c + chunk)
            prec = (1.0 / softplus(r2[:, cols]) ** 2).double()
            pm = prec * m2[:, cols].double()
            new_prec = w_self[:, None] * prec
            new_pm = w_self[:, None] * pm
            new_prec.index_add_(0, dst, w[:, None] * prec[src])
            new_pm.index_add_(0, dst, w[:, None] * pm[src])
            nm = (new_pm / new_prec).float()
            nr = softplus_inv(torch.sqrt(1.0 / new_prec).float())
            m2[:, cols] = torch.where(act[:, None], nm, m2[:, cols])
            r2[:, cols] = torch.where(act[:, None], nr, r2[:, cols])
    return int((~valid).sum())
