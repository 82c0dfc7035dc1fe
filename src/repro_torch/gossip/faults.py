"""Deterministic agent-level fault model for the gossip runtime.

A copy of the JAX package's ``gossip/faults.py`` (numpy only), so that a
faults doc gives the same crash and corruption streams in both packages.

The clock layer (``gossip.clocks``) already models *link*-level faults:
``failure_injected`` drops fired edges i.i.d. and ``delayed`` delivers them
late.  This module adds the *agent*-level failure regime — churn (crash /
recover) and payload corruption — as a deterministic, checkpoint-embeddable
layer that composes with every clock kind.

Determinism contract (mirrors the EventWindow contract): every fault
decision for window ``r`` is a pure function of ``(spec.seed, r)`` drawn
from salted counter streams, so

* windows remain pure functions of ``(seed, round)`` — a crashed-and-resumed
  session regenerates the identical crash/corruption schedule;
* the crash stream ``[seed, 0xC7A54, r]``, the corruption stream
  ``[seed, 0xBADBAD, r]``, the link-drop stream ``[seed, 0xFA11ED, r]``
  and the delay stream ``[seed, 0xDE1A7, r]`` are pairwise independent
  (distinct salt words on independent Philox streams).

Churn is a per-agent two-state Markov chain: an UP agent crashes with
probability ``crash_rate`` per window, a DOWN agent recovers with
probability ``recover_rate`` per window; all agents start UP at window 0.
The chain is replayed from window 0 on demand (memoized prefix), so
``up(r)`` is independent of access order.

A crashed agent skips local training, fires no out-edges, receives
nothing (its in-edge W-tilde mass moves to self via the ``"conserve"``
rule — rows stay row-stochastic), and its resident posterior is frozen.

Corruption models a flaky/adversarial *sender*: a corrupted-but-up agent's
exchanged ``(prec, prec*mu)`` statistics are replaced by NaN / Inf /
huge-magnitude garbage at the exchange boundary while its resident state
stays intact.  The quarantine guard (``core.flat.payload_validity``) is the
defense; ``fault_policy="strict"`` shows the undefended failure mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

# Salt words for the per-concern counter streams.  CRASH_SALT is fixed by
# the issue contract; the link-drop (0xFA11ED) and delay (0xDE1A7) salts
# live in gossip.clocks.  All four must stay pairwise distinct — the
# property tests assert pairwise independence of the streams.
CRASH_SALT = 0xC7A54
CORRUPT_SALT = 0xBADBAD

_CORRUPT_KINDS = ("nan", "inf", "huge", "mix")

# Garbage magnitudes injected by kind "huge": far above any sane posterior
# statistic yet still finite — caught only by the magnitude bound, not the
# finiteness check.
HUGE_FILL = 1.0e30


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Checkpoint-embeddable agent-fault configuration.

    Rides inside the clock doc as ``clock={"kind": ..., "faults": {...}}``
    so it lands in the self-describing session checkpoint next to the clock
    parameters and resumes bit-identically.
    """

    crash_rate: float = 0.0
    recover_rate: float = 0.5
    corrupt_rate: float = 0.0
    corrupt_kind: str = "mix"
    seed: int = 0

    def validate(self) -> None:
        if not (0.0 <= self.crash_rate < 1.0):
            raise ValueError(
                f"crash_rate must be in [0, 1), got {self.crash_rate}"
            )
        if not (0.0 <= self.corrupt_rate <= 1.0):
            raise ValueError(
                f"corrupt_rate must be in [0, 1], got {self.corrupt_rate}"
            )
        if self.crash_rate > 0.0 and not (0.0 < self.recover_rate <= 1.0):
            raise ValueError(
                "recover_rate must be in (0, 1] when crash_rate > 0 "
                f"(agents must be able to rejoin), got {self.recover_rate}"
            )
        if not (0.0 <= self.recover_rate <= 1.0):
            raise ValueError(
                f"recover_rate must be in [0, 1], got {self.recover_rate}"
            )
        if self.corrupt_kind not in _CORRUPT_KINDS:
            raise ValueError(
                f"corrupt_kind must be one of {_CORRUPT_KINDS}, "
                f"got {self.corrupt_kind!r}"
            )

    def to_doc(self) -> Dict[str, Any]:
        return {
            "crash_rate": float(self.crash_rate),
            "recover_rate": float(self.recover_rate),
            "corrupt_rate": float(self.corrupt_rate),
            "corrupt_kind": str(self.corrupt_kind),
            "seed": int(self.seed),
        }

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "FaultSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(doc) - known
        if extra:
            raise ValueError(f"unknown FaultSpec keys: {sorted(extra)}")
        spec = cls(**doc)
        spec.validate()
        return spec


class FaultModel:
    """Replayable realization of a :class:`FaultSpec` over ``n_agents``.

    All queries are pure functions of ``(spec.seed, r)``: the Markov up/down
    chain is replayed from window 0 (memoized prefix, O(1) amortized for
    sequential access), and the corruption draws are per-window salted
    streams, so any access order — including a resume from an arbitrary
    round — yields the identical schedule.
    """

    def __init__(self, spec: FaultSpec, n_agents: int):
        spec.validate()
        self.spec = spec
        self.n_agents = int(n_agents)
        # memoized up/down prefix; index r holds the state DURING window r
        self._up: list = [np.ones(self.n_agents, dtype=bool)]

    # -- churn ------------------------------------------------------------
    def up(self, r: int) -> np.ndarray:
        """[n_agents] bool: agent is up during window ``r`` (all up at 0)."""
        if r < 0:
            raise ValueError(f"round index must be >= 0, got {r}")
        while len(self._up) <= r:
            t = len(self._up)  # transition INTO window t
            rng = np.random.default_rng([self.spec.seed, CRASH_SALT, t])
            u = rng.random(self.n_agents)
            prev = self._up[t - 1]
            nxt = np.where(prev, u >= self.spec.crash_rate,
                           u < self.spec.recover_rate)
            self._up.append(nxt)
        return self._up[r].copy()

    def crashed(self, r: int) -> np.ndarray:
        """[n_agents] bool: agent is down during window ``r``."""
        return ~self.up(r)

    # -- corruption -------------------------------------------------------
    def corrupted(self, r: int) -> np.ndarray:
        """[n_agents] bool: agent emits garbage statistics in window ``r``.

        Only UP agents corrupt — a crashed agent emits nothing at all.
        """
        if self.spec.corrupt_rate <= 0.0:
            return np.zeros(self.n_agents, dtype=bool)
        rng = np.random.default_rng([self.spec.seed, CORRUPT_SALT, r])
        draw = rng.random(self.n_agents) < self.spec.corrupt_rate
        return draw & self.up(r)

    def fills(self, r: int):
        """Per-agent garbage fill values for window ``r``.

        Returns ``(fill_mean, fill_rho)`` float32 [n_agents] arrays: the
        values a corrupted agent's (mean, rho) wire payload is replaced
        with.  ``nan`` poisons via non-finite prec*mu, ``inf`` via
        non-finite mean, ``huge`` stays finite but blows the magnitude
        bound; ``mix`` cycles all three deterministically (second draw of
        the same salted stream as :meth:`corrupted`).
        """
        kind = self.spec.corrupt_kind
        n = self.n_agents
        if kind == "mix":
            rng = np.random.default_rng([self.spec.seed, CORRUPT_SALT, r])
            rng.random(n)  # skip the corrupted() draw
            pick = rng.integers(0, 3, n)
        else:
            pick = np.full(n, _CORRUPT_KINDS.index(kind), dtype=np.int64)
        # kind 0 = nan, 1 = inf, 2 = huge.  rho stays benign (0.0 →
        # prec ~ 2.08) for inf/huge so the poison arrives via the mean.
        fill_mean = np.choose(pick, [np.nan, np.inf, HUGE_FILL])
        fill_rho = np.choose(pick, [np.nan, 0.0, 0.0])
        return (fill_mean.astype(np.float32), fill_rho.astype(np.float32))

    # -- telemetry --------------------------------------------------------
    def uptime(self, n_rounds: int) -> np.ndarray:
        """[n_agents] int: windows each agent was up in [0, n_rounds)."""
        total = np.zeros(self.n_agents, dtype=np.int64)
        for r in range(int(n_rounds)):
            total += self.up(r)
        return total

    def to_doc(self) -> Dict[str, Any]:
        return self.spec.to_doc()


def build_faults(doc: Optional[Dict[str, Any]],
                 n_agents: int) -> Optional[FaultModel]:
    """Build a FaultModel from a clock-doc ``"faults"`` entry (or None)."""
    if doc is None:
        return None
    return FaultModel(FaultSpec.from_doc(dict(doc)), n_agents)


def edge_keep_mask(
    model: FaultModel, r: int, dst: np.ndarray, src: np.ndarray,
    lags: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[E] bool: which fired edges survive the crash filter for window ``r``.

    The vectorized edge-list form of ``GossipClock._filter_crashed`` (the
    only form usable at population scale — no per-event Python loop): an
    edge survives iff its dst is up at DELIVERY time ``r`` and its src was
    up at FIRE time ``r - lag`` (``lags=None`` = instant delivery, fire
    time == delivery time).  Fancy-indexing the memoized up/down chain keeps
    the whole filter O(fired) host work.
    """
    dst = np.asarray(dst)
    src = np.asarray(src)
    up_now = model.up(r)
    keep = up_now[dst]
    if lags is None:
        return keep & up_now[src]
    lags = np.asarray(lags)
    for lag in np.unique(lags):
        sel = lags == lag
        keep[sel] &= model.up(r - int(lag))[src[sel]]
    return keep
