"""Tiny CPU runs of the MLP cells' drivers with the program's spans on, as
``--trace 1`` builds them: every phase of the round or window is a span,
the spans the driver hands the readers (``obs_spans``) cover the rounds
after the set-up, and every span has its device time once resolved (on
the CPU, its host time).  The untraced run opens none."""
from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.tests import tiny

PHASES = {
    "mlp_gossip_ws4200": {"gossip.window_build", "gossip.window", "gossip.local_phase",
                          "gossip.consensus", "local.forward", "local.backward",
                          "local.optimizer"},
    "mlp_sync_grid1024": {"round.local_phase", "round.consensus", "local.forward",
                          "local.backward", "local.optimizer"},
}


def _driver(cell, trace):
    ctx = run.Ctx(cell, 20240601, trace, torch.device("cpu"), tiny.CELLS[cell])
    driver = ctx.driver_module.Driver(ctx)
    driver.setup()
    return driver


@pytest.mark.parametrize("cell", sorted(PHASES))
def test_traced_session_opens_a_span_at_every_phase(cell):
    driver = _driver(cell, True)
    for _ in range(2):
        driver.round()
    names = [name for name, _ in driver.obs_spans()]
    assert PHASES[cell] <= set(names)
    assert names.count("session.round") == 2
    tracer = driver.session.obs.tracer
    tracer.resolve()
    assert all(sp.device_us == sp.dur_us for sp in tracer.spans)


@pytest.mark.parametrize("cell", sorted(PHASES))
def test_untraced_session_opens_no_span(cell):
    driver = _driver(cell, False)
    driver.round()
    assert driver.session.obs is None and driver.obs_spans() == []
