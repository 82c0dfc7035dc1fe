"""Snapshot isolation for the posterior serving tier (port of
``repro.serve.snapshot``).

The paper's end product is each agent's predictive distribution, served
from its consensus posterior (Sec. 4.2).  Serving never interferes with
training and training never changes what a reader serves: a double buffer
over ``core.flat.FlatPosterior``.

* ``SnapshotStore.publish`` copies the live [N, P] (mean, rho) buffers into
  a new, immutable ``PosteriorSnapshot`` (the back buffer), finishes the
  copy (on the card: synchronises the copying stream), and only then swaps
  it in as the served front buffer with one reference assignment.  Readers
  holding the previous snapshot keep serving it; new reads see the new one.
  Publishing only reads training state, so a run with a serving reader
  attached is bitwise the run without one.
* A snapshot may be resident in a narrower dtype (``"bf16"``, the
  ``core.numerics`` wire-dtype names): half the bytes, widened to fp32
  inside the server's apply program.
* Every snapshot carries its provenance: the training window it was taken
  at, a monotone version, and the engine's staleness telemetry when the
  engine has a ``snapshot_meta`` hook; the server's staleness SLO reads the
  window.

``PosteriorSnapshot.save``/``load`` persist a snapshot in the JAX package's
document format (``checkpoint.io.save_snapshot``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.flat import FlatPosterior
from repro_torch.core.numerics import COMPUTE_DTYPE, canonical_wire_dtype, wire_dtype_name


@dataclasses.dataclass(frozen=True, eq=False)
class PosteriorSnapshot:
    """One immutable published posterior and its provenance: ``window`` is
    the training round it was taken at, ``version`` the store's publish
    counter, ``dtype`` the resident dtype's name, ``telemetry`` the engine's
    staleness block at publish time (plain data)."""

    posterior: FlatPosterior
    window: int
    version: int
    dtype: str  # "f32" | "bf16" | "f16"
    telemetry: dict = dataclasses.field(default_factory=dict)

    @property
    def n_agents(self) -> int:
        return int(self.posterior.mean.shape[0])

    def nbytes(self) -> int:
        """Resident bytes of both buffers: a bf16 snapshot's are exactly half
        an f32 one's."""
        post = self.posterior
        return int(post.mean.numel() * post.mean.element_size()
                   + post.rho.numel() * post.rho.element_size())

    def decode(self) -> FlatPosterior:
        """The fp32 view (``self.posterior`` itself when f32-resident)."""
        return self.posterior.astype(COMPUTE_DTYPE)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        from repro_torch.checkpoint.io import save_snapshot

        save_snapshot(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "PosteriorSnapshot":
        """Restore onto ``device`` (default: the card; ``"cpu"`` to opt
        out)."""
        from repro_torch.checkpoint.io import restore_snapshot

        return restore_snapshot(path, device=device)


def take_snapshot(post: FlatPosterior, *, window: int, version: int = 0, dtype=None,
                  telemetry: dict | None = None) -> PosteriorSnapshot:
    """Copy ``post`` into an immutable snapshot (``FlatPosterior.snapshot``)
    resident in ``dtype`` (a wire-dtype name or dtype; ``None`` is f32)."""
    dt = canonical_wire_dtype(dtype)
    return PosteriorSnapshot(
        posterior=post.snapshot(dt),
        window=int(window),
        version=int(version),
        dtype=wire_dtype_name(dt),
        telemetry=dict(telemetry or {}),
    )


class SnapshotStore:
    """The double buffer: one served front snapshot, swapped atomically.

    ``clock`` supplies "now" in training windows (the Session wires it to
    its round counter), so ``age()``, the windows since the served snapshot
    was taken, is what the staleness SLO bounds."""

    def __init__(self, clock: Callable[[], int] | None = None):
        self._front: PosteriorSnapshot | None = None
        self._version = 0
        self.clock = clock
        self.n_published = 0

    def publish(self, post: FlatPosterior, *, window: int, dtype=None,
                telemetry: dict | None = None) -> PosteriorSnapshot:
        self._version += 1
        snap = take_snapshot(post, window=window, version=self._version, dtype=dtype,
                             telemetry=telemetry)
        # the copy must be finished before the swap: a reader that picks up
        # the new front serves finished buffers
        if snap.posterior.mean.is_cuda:
            torch.cuda.current_stream(snap.posterior.mean.device).synchronize()
        self._front = snap  # the atomic swap
        self.n_published += 1
        return snap

    def current(self) -> PosteriorSnapshot:
        if self._front is None:
            raise RuntimeError(
                "no snapshot published yet — call Session.snapshot() (or "
                "SnapshotStore.publish) before serving"
            )
        return self._front

    @property
    def version(self) -> int:
        return self._version

    def age(self, now: int | None = None) -> int:
        """Windows since the served snapshot was taken (>= 0)."""
        snap = self.current()
        if now is None:
            if self.clock is None:
                raise ValueError("SnapshotStore.age() needs `now` or a wired clock")
            now = self.clock()
        return max(int(now) - snap.window, 0)

    def telemetry(self) -> dict:
        """Plain-data store block (merged into the serving telemetry)."""
        if self._front is None:
            return {"published": 0}
        snap = self._front
        out = {
            "published": self.n_published,
            "snapshot_window": snap.window,
            "snapshot_version": snap.version,
            "snapshot_dtype": snap.dtype,
            "snapshot_bytes": snap.nbytes(),
        }
        if self.clock is not None:
            out["snapshot_age"] = self.age()
        return out
