"""Theory-vs-measured convergence tracking (paper Theorem 1, live; port of
``repro.obs.convergence``).

The paper's headline result is a RATE: beliefs concentrate like
``exp(-n K)`` with ``K`` a pure function of the graph (``core.theory``).
This module measures the live network's convergence every round and
overlays it against that prediction:

* ``network_stats(mean, rho)`` — one reduction over the flat ``[N, P]``
  posterior buffers, in fp32 on the buffers' own device, producing:

  - ``disagreement``: RMS deviation of the per-agent mean vectors from the
    network average — the consensus residual whose decay slope is the
    measured contraction rate;
  - ``rho_disagreement``: same reduction over the rho buffer;
  - ``kl_to_mean``: mean over agents of ``KL(q_i || q_bar)`` where
    ``q_bar`` is the moment-matched network-average diagonal Gaussian —
    the distribution-level distance the paper's consensus claim is about.

  Every quantity is a per-column statistic (the network averages are over
  agents, column by column) summed over columns, so the reduction walks P
  in column chunks of at most ``CHUNK_BYTES`` a buffer: its extra memory is
  a few ``[N, chunk]`` temporaries, not the reference formula's six
  ``[N, P]`` ones (3.35 GB each at N = 4,200 and full width).  Each chunk's
  sums are fp32 torch reductions; the chunks' partial sums add up in fp64.
  That is another order of the sums than the reference's, which agrees
  with it to rtol 1e-5 (``tests/test_torch_obs.py``).

* ``ConvergenceTracker`` — accumulates the per-round stats and reports the
  measured log-linear decay slope next to the theoretical rate: an
  explicit ``K`` (e.g. ``core.theory.rate_K`` from divergence gaps) or,
  for a static W, the spectral consensus rate
  ``core.theory.consensus_contraction_rate(W)``.  ``report()`` returns the
  ``predicted_decay_curve`` overlay anchored at the first measured point
  and the ``rate_attainment`` ratio (measured / theory; ~1.0 means the
  live network contracts exactly as fast as the graph says it must).

The tracker is a pure observer: it only READS the posterior buffers, writes
nothing the training step reads and draws nothing from any generator, so
enabling it cannot perturb the training math (pinned by
``tests/test_torch_obs.py`` and, on the card, ``chip_smoke.py``'s
``obs_on==obs_off`` rung).
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.core.numerics import COMPUTE_DTYPE, softplus
from repro_torch.core.theory import consensus_contraction_rate, predicted_decay_curve

_TINY = 1e-30
CHUNK_BYTES = 64 << 20  # one [N, chunk] fp32 temporary of the chunked reduction


def _chunks(n_agents: int, n_cols: int):
    """Column ranges of at most ``CHUNK_BYTES`` of fp32 a buffer."""
    width = max(1, CHUNK_BYTES // (4 * max(n_agents, 1)))
    return [(c, min(c + width, n_cols)) for c in range(0, n_cols, width)]


@torch.no_grad()
def _gaussian_stats(mean: torch.Tensor, rho: torch.Tensor):
    """Disagreement + KL reduction over the [N, P] buffers, column chunk by
    column chunk.  -> (disagreement, rho_disagreement, kl_to_mean) as 0-d
    fp64 tensors on the buffers' device."""
    n, p = mean.shape
    f64 = dict(dtype=torch.float64, device=mean.device)
    sq_dev, sq_rho = torch.zeros((), **f64), torch.zeros((), **f64)
    kl_per_agent = torch.zeros((n,), **f64)
    for a, b in _chunks(n, p):
        m = mean[:, a:b].to(COMPUTE_DTYPE)
        r = rho[:, a:b].to(COMPUTE_DTYPE)
        dev = m - m.mean(dim=0, keepdim=True)  # [N, c]
        dev_sq = dev.square_()
        sq_dev += dev_sq.sum().double()
        sq_rho += (r - r.mean(dim=0, keepdim=True)).square_().sum().double()
        # moment-matched network-average Gaussian: var_bar = mean_i var_i
        var = softplus(r).square_()  # [N, c]
        var_bar = var.mean(dim=0, keepdim=True)  # [1, c]
        ratio = var.div_(var_bar)
        # KL(q_i || q_bar) for diagonal Gaussians, summed over the columns
        terms = ratio - 1.0 - torch.log(ratio) + dev_sq.div_(var_bar)
        kl_per_agent += terms.sum(dim=-1).double()
    count = float(n * p)
    return (torch.sqrt(sq_dev / count), torch.sqrt(sq_rho / count),
            (0.5 * kl_per_agent).mean())


@torch.no_grad()
def _mean_stats(mean: torch.Tensor):
    """Disagreement-only reduction (posteriors without a rho buffer)."""
    mean = mean.reshape(mean.shape[0], -1)
    n, p = mean.shape
    sq_dev = torch.zeros((), dtype=torch.float64, device=mean.device)
    for a, b in _chunks(n, p):
        m = mean[:, a:b].to(COMPUTE_DTYPE)
        sq_dev += (m - m.mean(dim=0, keepdim=True)).square_().sum().double()
    return torch.sqrt(sq_dev / float(n * p))


def network_stats(mean, rho=None) -> dict:
    """Per-round network convergence stats from flat buffers (tensors on any
    device, or numpy arrays; see the module docstring for the three
    quantities)."""
    mean = torch.as_tensor(mean)
    if rho is not None:
        d, rd, kl = _gaussian_stats(mean, torch.as_tensor(rho))
        return {
            "disagreement": float(d),
            "rho_disagreement": float(rd),
            "kl_to_mean": float(kl),
        }
    return {"disagreement": float(_mean_stats(mean))}


class ConvergenceTracker:
    """Accumulate per-round network stats; overlay measured decay against
    the theoretical rate.

    ``W``: static mixing matrix — theory rate is
    ``consensus_contraction_rate(W)``.  ``K``: explicit rate (wins over
    ``W``; pass ``core.theory.rate_K(...)`` here for the belief-decay
    overlay).  ``eps``: the Theorem-1 slack forwarded to
    ``predicted_decay_curve``.
    """

    def __init__(self, W=None, K: float | None = None, eps: float = 0.0):
        if K is not None:
            self.theory_rate: float | None = float(K)
        elif W is not None:
            self.theory_rate = consensus_contraction_rate(np.asarray(W))
        else:
            self.theory_rate = None
        self.eps = float(eps)
        self.rounds: list[int] = []
        self.stats: list[dict] = []

    # -- accumulation --------------------------------------------------------

    def update(self, posterior: Any, round_idx: int | None = None) -> dict:
        """Record one round.  ``posterior`` is anything with a flat
        ``[N, P]`` ``.mean`` buffer (``FlatPosterior`` also contributes its
        ``.rho`` for the KL stat) or a raw ``[N, P]`` buffer; returns the
        stats dict recorded."""
        mean = getattr(posterior, "mean", None)
        if mean is None or callable(mean):  # raw [N, P] buffer (Tensor.mean
            mean = posterior                # is a method, not a field)
        rho = getattr(posterior, "rho", None)
        rec = network_stats(mean, rho)
        self.rounds.append(
            len(self.rounds) if round_idx is None else int(round_idx)
        )
        self.stats.append(rec)
        return rec

    def series(self) -> dict:
        """Column view: ``{"round": [...], "disagreement": [...], ...}``."""
        out: dict[str, list] = {"round": list(self.rounds)}
        for k in ("disagreement", "rho_disagreement", "kl_to_mean"):
            if self.stats and k in self.stats[0]:
                out[k] = [s[k] for s in self.stats]
        return out

    # -- theory overlay ------------------------------------------------------

    def measured_rate(self, metric: str = "disagreement") -> float | None:
        """Log-linear decay slope of ``metric`` (per round), least-squares
        over the recorded points; None with < 2 usable points or a
        flat/degenerate series."""
        pts = [
            (r, s[metric]) for r, s in zip(self.rounds, self.stats)
            if metric in s and math.isfinite(s[metric]) and s[metric] > _TINY
        ]
        if len(pts) < 2:
            return None
        t = np.asarray([p[0] for p in pts], np.float64)
        logd = np.log(np.asarray([p[1] for p in pts], np.float64))
        slope = np.polyfit(t, logd, 1)[0]
        return float(-slope)

    def overlay(self, metric: str = "disagreement") -> list[dict]:
        """Measured vs predicted rows: the ``predicted_decay_curve`` of the
        theory rate, anchored at the first measured point."""
        if self.theory_rate is None or not self.stats:
            return []
        pts = [
            (r, s[metric]) for r, s in zip(self.rounds, self.stats)
            if metric in s
        ]
        if not pts:
            return []
        t0, d0 = pts[0]
        rows = []
        for r, d in pts:
            pred = d0 * float(
                predicted_decay_curve(self.theory_rate, r - t0, self.eps)
            )
            rows.append({"round": r, "measured": d, "predicted": pred})
        return rows

    def report(self, metric: str = "disagreement") -> dict:
        """The convergence verdict: measured rate, theory rate, their ratio
        (``rate_attainment``), the overlay rows, and the latest stats."""
        measured = self.measured_rate(metric)
        attainment = None
        if (measured is not None and self.theory_rate is not None
                and math.isfinite(self.theory_rate) and self.theory_rate > 0):
            attainment = measured / self.theory_rate
        return {
            "metric": metric,
            "n_rounds": len(self.rounds),
            "measured_rate": measured,
            "theory_rate": self.theory_rate,
            "rate_attainment": attainment,
            "overlay": self.overlay(metric),
            "latest": self.stats[-1] if self.stats else None,
        }
