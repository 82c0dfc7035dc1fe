"""``PredictiveServer``: batched MC-predictive inference over a snapshot
(port of ``repro.serve.server``).

Serves the paper's Monte-Carlo predictive distribution (Sec. 4.2)

    P(y | x) = (1/L) sum_k Softmax(f_{theta_k}(x)),   theta_k ~ snapshot

from the ``SnapshotStore``'s front buffer, with three guarantees:

* **A compiled-once apply cache.**  Request rows are coalesced per agent
  and cut into padding buckets (``bucket_sizes``, ascending): full slabs of
  the largest bucket, then the smallest bucket that covers the rest,
  zero-padded (pad rows are sliced off before any value leaves).  Each key
  ``(bucket, row_shape, mc, layout, resident dtype)`` gets one program: on
  the card one CUDA-graph capture over static buffers (the slab, the
  agent's mean and rho rows in their resident dtype, the ``[mc, P]``
  noise), on the CPU the same function run eagerly.  A slab copies its rows
  into the static buffers, the server draws the noise into its buffer
  (outside the graph, from its own ``torch.Generator`` seeded by ``seed``),
  and the graph replays: republishing a snapshot or switching agents never
  captures again.  ``n_traces`` counts the programs built (captures on the
  card); a capture that fails raises.
* **fp32 probability accumulation** whatever the snapshot's resident dtype
  (a bf16 row is widened inside the program); ``mc_samples=0`` is one
  softmax at the posterior mean.
* **A staleness SLO**: ``max_staleness=k`` refuses (``"strict"``:
  ``StalenessSLOError``) or flags (``"flag"``: ``slo_ok=False`` in the
  response meta) answers from a snapshot more than k training windows old,
  and counts every breach.

The server never touches training state; it reads the immutable snapshot
the store fronts.  With an ``Observability`` bundle attached (``obs``, set
by ``Session.attach_server``) each ``serve()`` call adds to the
``serve.requests``, ``serve.rows`` and ``serve.slo_breaches`` counters and
the ``serve.latency_us`` histogram (labelled by ``mc``), and records one
``serve.request`` span: the interval ``serve()`` already measures, which
ends after its CUDA synchronise.  ``noise_fn(counter, mc, P) -> [mc, P]`` injects each
slab's noise in place of the generator's draw (``counter`` is the server's
monotone slab count), so a test can feed another implementation's draws.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.flat import FlatLayout
from repro_torch.core.numerics import COMPUTE_DTYPE, softplus
from repro_torch.obs.trace import Span
from repro_torch.serve.snapshot import PosteriorSnapshot, SnapshotStore

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


class StalenessSLOError(RuntimeError):
    """The served snapshot is older than the ``max_staleness`` SLO allows."""


def _check_buckets(bucket_sizes) -> tuple[int, ...]:
    buckets = tuple(int(b) for b in bucket_sizes)
    if not buckets or any(b <= 0 for b in buckets):
        raise ValueError(f"bucket_sizes must be positive and non-empty, got {bucket_sizes!r}")
    if list(buckets) != sorted(set(buckets)):
        raise ValueError(f"bucket_sizes must be strictly ascending, got {bucket_sizes!r}")
    return buckets


class _Program:
    """The MC-predictive apply of one cache key over static buffers: on the
    card captured once into a CUDA graph and replayed, on the CPU run
    eagerly."""

    def __init__(self, logits_fn, layout: FlatLayout, bucket: int, row_shape: tuple,
                 mc: int, resident: torch.dtype, device: torch.device):
        p = layout.n_params
        self.logits_fn, self.layout, self.mc = logits_fn, layout, mc
        self.x = torch.zeros((bucket,) + row_shape, dtype=COMPUTE_DTYPE, device=device)
        self.mean = torch.zeros(p, dtype=resident, device=device)
        self.rho = torch.zeros(p, dtype=resident, device=device)
        self.noise = torch.zeros((mc, p), dtype=COMPUTE_DTYPE, device=device) if mc else None
        self.graph = None
        if device.type == "cuda":
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self._apply()  # cuBLAS handles and workspaces, before the capture
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._apply()

    @torch.no_grad()
    def _apply(self) -> torch.Tensor:
        mean = self.mean.to(COMPUTE_DTYPE)
        if self.mc == 0:  # the point estimate: one softmax at the mean
            theta = mean.unsqueeze(0)
        else:
            theta = mean + softplus(self.rho.to(COMPUTE_DTYPE)) * self.noise  # [mc, P]
        x = self.x.unsqueeze(0).expand((theta.shape[0],) + tuple(self.x.shape))
        logits = self.logits_fn(self.layout.unflatten(theta), x)
        probs = torch.softmax(logits.to(COMPUTE_DTYPE), dim=-1)
        return probs[0] if self.mc == 0 else probs.mean(dim=0)  # fp32 accumulation

    def __call__(self, slab, mean_row, rho_row) -> torch.Tensor:
        self.x.copy_(slab)
        self.mean.copy_(mean_row)
        self.rho.copy_(rho_row)
        if self.graph is None:
            return self._apply()
        self.graph.replay()
        return self.out


class PredictiveServer:
    """Batched MC-predictive serving against a ``SnapshotStore``.

    ``logits_fn(params, x) -> logits`` is the model apply
    (``api.models.ModelFns.logits_fn``, batched over a leading sample axis);
    the flat theta crosses to the parameter dict inside the program through
    the snapshot's layout.  ``seed`` seeds the server's own noise generator,
    so two servers built with the same seed and fed the same stream sample
    the same noise, and successive slabs of one server draw fresh noise."""

    def __init__(self, store: SnapshotStore, logits_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                 *, mc_samples: int = 8, bucket_sizes: Sequence[int] = DEFAULT_BUCKETS,
                 max_staleness: int | None = None, staleness_policy: str = "strict",
                 seed: int = 0,
                 noise_fn: Callable[[int, int, int], Any] | None = None):
        if mc_samples < 0:
            raise ValueError("mc_samples must be >= 0 (0 = point estimate)")
        if staleness_policy not in ("strict", "flag"):
            raise ValueError(
                f"unknown staleness_policy {staleness_policy!r}; known: strict | flag")
        if max_staleness is not None and max_staleness < 0:
            raise ValueError("max_staleness must be >= 0 windows (or None)")
        self.store = store
        self.logits_fn = logits_fn
        self.mc_samples = int(mc_samples)
        self.bucket_sizes = _check_buckets(bucket_sizes)
        self.max_staleness = max_staleness
        self.staleness_policy = staleness_policy
        self.seed = int(seed)
        self.noise_fn = noise_fn
        self._generator: torch.Generator | None = None
        self._programs: dict = {}
        # serving telemetry (Session.evaluate merges it)
        self.n_traces = 0
        self.n_requests = 0
        self.n_rows = 0
        self.n_padded_rows = 0
        self.n_batches = 0
        self.n_slo_breaches = 0
        self._batch_counter = 0
        self._lat_us: list[float] = []
        # host-side observability hook (repro_torch.obs.Observability),
        # attached by Session.attach_server: counters and spans only
        self.obs = None

    # -- staleness SLO -------------------------------------------------------

    def check_slo(self, snap: PosteriorSnapshot | None = None) -> tuple[bool, int]:
        """(slo_ok, age).  Counts a breach and, under the strict policy,
        refuses by raising ``StalenessSLOError``.  With no
        ``max_staleness`` every snapshot is within the SLO."""
        snap = self.store.current() if snap is None else snap
        age = self.store.age() if self.store.clock is not None else 0
        if self.max_staleness is None or age <= self.max_staleness:
            return True, age
        self.n_slo_breaches += 1
        if self.staleness_policy == "strict":
            raise StalenessSLOError(
                f"snapshot of window {snap.window} is {age} windows stale "
                f"(> max_staleness={self.max_staleness}); publish a fresh "
                "snapshot (Session.snapshot()) or serve with staleness_policy='flag'"
            )
        return False, age

    # -- the compiled-once apply cache ---------------------------------------

    def _program_for(self, post, bucket: int, row_shape: tuple, mc: int) -> _Program:
        """The program of one key; the layout and the resident dtype are
        part of the key, the buffers' values are not, so republishing a
        snapshot or switching agents never builds another."""
        dev = post.mean.device
        key = (bucket, row_shape, mc, id(post.layout), post.mean.dtype, str(dev))
        prog = self._programs.get(key)
        if prog is None:
            prog = _Program(self.logits_fn, post.layout, bucket, row_shape, mc,
                            post.mean.dtype, dev)
            self._programs[key] = prog
            self.n_traces += 1
        return prog

    def _bucket_plan(self, total: int) -> list[int]:
        """Cut ``total`` rows into slabs: full slabs of the largest bucket,
        then the smallest bucket covering the remainder."""
        if total <= 0:
            return []
        top = self.bucket_sizes[-1]
        plan = [top] * (total // top)
        rem = total % top
        if rem:
            plan.append(next(b for b in self.bucket_sizes if b >= rem))
        return plan

    def _draw_noise(self, prog: _Program) -> None:
        """The slab's ``[mc, P]`` noise into the program's static buffer."""
        if self.noise_fn is not None:
            prog.noise.copy_(torch.as_tensor(
                self.noise_fn(self._batch_counter, prog.mc, prog.noise.shape[1])))
            return
        dev = prog.noise.device
        if self._generator is None or self._generator.device != dev:
            self._generator = torch.Generator(device=dev).manual_seed(self.seed)
        torch.randn(prog.noise.shape, generator=self._generator, device=dev, out=prog.noise)

    # -- serving -------------------------------------------------------------

    def query(self, x, agent: int = 0, *, mc_samples: int | None = None):
        """One request: class probabilities for ``x`` (``[n, ...features]``
        or one ``[...features]`` row) under ``agent``'s snapshot posterior.
        Returns ``(probs, meta)``."""
        x = torch.as_tensor(x)
        single = x.ndim == 1
        outs, meta = self.serve([x[None] if single else x], agents=[agent],
                                mc_samples=mc_samples)
        return (outs[0][0] if single else outs[0]), meta

    def serve(self, requests, agents=None, *, mc_samples: int | None = None):
        """Serve a micro-batch of requests in one pass: ``requests`` is a
        list of ``[n_i, ...features]`` arrays (ragged sizes welcome),
        ``agents`` one agent id each (default 0).  Rows are coalesced per
        agent, run through the bucket programs, and handed back per request
        in order.  Returns ``(outputs, meta)``."""
        snap = self.store.current()
        slo_ok, age = self.check_slo(snap)
        mc = self.mc_samples if mc_samples is None else int(mc_samples)
        if mc < 0:
            raise ValueError("mc_samples must be >= 0")
        post = snap.posterior
        dev = post.mean.device
        reqs = [torch.as_tensor(r, dtype=COMPUTE_DTYPE, device=dev) for r in requests]
        if any(r.ndim < 2 for r in reqs):
            raise ValueError("each request must be [n, ...features]; wrap single rows "
                             "with x[None] (or use query())")
        agents = [0] * len(reqs) if agents is None else list(agents)
        if len(agents) != len(reqs):
            raise ValueError(f"{len(reqs)} requests but {len(agents)} agent ids")
        for a in agents:
            if not 0 <= int(a) < snap.n_agents:
                raise ValueError(f"agent {a} out of range for a {snap.n_agents}-agent snapshot")
        t0 = time.perf_counter()

        # coalesce rows per agent (one posterior row per slab), request order
        # kept within each agent's group
        by_agent: dict[int, list[int]] = {}
        for i, a in enumerate(agents):
            by_agent.setdefault(int(a), []).append(i)
        results: list = [None] * len(reqs)
        for a, idxs in by_agent.items():
            rows = torch.cat([reqs[i] for i in idxs], dim=0)
            row_shape = tuple(rows.shape[1:])
            chunks, off = [], 0
            for bucket in self._bucket_plan(rows.shape[0]):
                n = min(bucket, rows.shape[0] - off)
                slab = rows[off:off + n]
                if n < bucket:  # zero-pad to the bucket; sliced off below
                    slab = torch.cat([slab, slab.new_zeros((bucket - n,) + row_shape)])
                    self.n_padded_rows += bucket - n
                prog = self._program_for(post, bucket, row_shape, mc)
                if mc:
                    self._draw_noise(prog)
                self._batch_counter += 1
                chunks.append(prog(slab, post.mean[a], post.rho[a])[:n].clone())
                off += n
                self.n_batches += 1
            agent_probs = (torch.cat(chunks) if chunks
                           else torch.zeros((0, 0), dtype=COMPUTE_DTYPE, device=dev))
            off = 0
            for i in idxs:
                n = reqs[i].shape[0]
                results[i] = agent_probs[off:off + n]
                off += n
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        lat_us = (time.perf_counter() - t0) * 1e6
        self._lat_us.append(lat_us)
        self.n_requests += len(reqs)
        n_rows = sum(int(r.shape[0]) for r in reqs)
        self.n_rows += n_rows
        if self.obs is not None:
            reg = self.obs.registry
            reg.counter("serve.requests", "requests served").inc(len(reqs))
            reg.counter("serve.rows", "rows served").inc(n_rows)
            reg.histogram("serve.latency_us", "per-call serve latency").observe(
                lat_us, mc=str(mc))
            if not slo_ok:
                reg.counter("serve.slo_breaches").inc()
            tr = self.obs.tracer
            if tr.enabled:
                # the call already synchronised: record the measured
                # [t0, t0 + lat] interval as one span
                tr.spans.append(Span(
                    name="serve.request", t0_us=(t0 - tr._epoch) * 1e6, dur_us=lat_us,
                    depth=tr._depth, attrs={"rows": n_rows, "mc": mc, "slo_ok": slo_ok},
                    t0_s=t0, device_us=lat_us))
        meta = {
            "snapshot_window": snap.window,
            "snapshot_version": snap.version,
            "snapshot_age": age,
            "slo_ok": slo_ok,
            "mc_samples": mc,
            "latency_us": lat_us,
        }
        return results, meta

    # -- telemetry -----------------------------------------------------------

    def latency_percentiles(self) -> dict:
        if not self._lat_us:
            return {}
        lat = np.asarray(self._lat_us)
        return {
            "p50_us": float(np.percentile(lat, 50)),
            "p99_us": float(np.percentile(lat, 99)),
            "mean_us": float(lat.mean()),
            "n": int(lat.size),
        }

    def telemetry(self) -> dict:
        """Plain-data serving block (merged into ``Session.evaluate``):
        snapshot provenance and age, request, slab and padding counters, the
        SLO breach count, and the programs built (``traces``)."""
        out = {
            "requests": self.n_requests,
            "rows": self.n_rows,
            "batches": self.n_batches,
            "padded_rows": self.n_padded_rows,
            "traces": self.n_traces,
            "mc_samples": self.mc_samples,
            "bucket_sizes": list(self.bucket_sizes),
            "slo": {
                "max_staleness": self.max_staleness,
                "policy": self.staleness_policy,
                "breaches": self.n_slo_breaches,
            },
        }
        out.update(self.store.telemetry())
        lat = self.latency_percentiles()
        if lat:
            out["latency"] = lat
        return out
