"""Roofline attainment: measured wall-clock vs the analytic bytes models
(port of ``repro.obs.roofline``, over the port's cost model and the card's
constants).

``launch.costmodel`` predicts what one consensus round / gossip window /
serve batch MUST cost on the memory-bound roofline (modeled bytes over
``HBM_BW``/``ICI_BW``).  This module closes the loop: given a MEASURED
wall-clock (a tracer span, a bench median), it reports

    attainment = modeled_roofline_seconds / measured_seconds

— the fraction of the roofline the live run achieves (1.0 = running at the
model, << 1 = leaving bandwidth on the table, > 1 = the model's bandwidth
assumption is conservative for this host).  The constants are the H100's,
so on a CPU host attainment is tiny and only a run on the card gives a
share of the card's roofline.

Pure functions of plain numbers; nothing here touches a tensor.  The cost
model is imported where it is used: ``launch`` imports the local step,
which opens its spans through ``obs.trace``.
"""
from __future__ import annotations

from typing import Any


def attainment(measured_us: float, modeled_seconds: float) -> float:
    """``modeled_seconds / measured_seconds`` (0.0 for degenerate inputs)."""
    if measured_us <= 0 or modeled_seconds <= 0:
        return 0.0
    return modeled_seconds / (measured_us * 1e-6)


def consensus_attainment(
    measured_us: float,
    n_agents: int,
    n_params: int,
    n_leaves: int = 1,
    strategy: str = "flat_fused",
    **model_kwargs: Any,
) -> dict:
    """Measured consensus-round time vs ``consensus_roofline``.

    ``strategy`` picks the modeled execution (``leaf_loop | flat_fused |
    flat_sparse``); extra kwargs forward to the model (``max_degree``,
    ``wire_dtype``)."""
    from repro_torch.launch.costmodel import consensus_roofline

    model = consensus_roofline(n_agents, n_params, n_leaves, **model_kwargs)
    modeled = model["roofline_seconds"][strategy]
    return {
        "measured_us": float(measured_us),
        "modeled_us": modeled * 1e6,
        "modeled_bytes": model["hbm_bytes"][strategy],
        "strategy": strategy,
        "attainment": attainment(measured_us, modeled),
    }


def window_attainment(
    measured_us: float,
    n_agents: int,
    n_params: int,
    n_participating: int,
    strategy: str = "window_masked",
    **model_kwargs: Any,
) -> dict:
    """Measured gossip-window time vs ``gossip_window_roofline``.

    ``strategy`` is a ``roofline_seconds`` key of the window model
    (``window_masked | dense_fused``, plus ``history`` /
    ``ici_window_ppermute`` when the model is built with ``delay_depth`` /
    ``n_shards``); extra kwargs forward to the model."""
    from repro_torch.launch.costmodel import gossip_window_roofline

    model = gossip_window_roofline(
        n_agents, n_params, n_participating, **model_kwargs
    )
    secs = model["roofline_seconds"]
    if strategy not in secs:
        raise ValueError(
            f"unknown window strategy {strategy!r}; model offers "
            f"{sorted(secs)} (shard/delay strategies need the matching "
            "model kwargs)"
        )
    modeled = secs[strategy]
    return {
        "measured_us": float(measured_us),
        "modeled_us": modeled * 1e6,
        "strategy": strategy,
        "participating_fraction": model["participating_fraction"],
        "attainment": attainment(measured_us, modeled),
    }
