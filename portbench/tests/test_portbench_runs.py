"""Tiny CPU rehearsals of every cell: the drivers run the program and the
reference end to end, the result line keeps its schema, nothing of JAX is
loaded, and a run with the timed path broken underneath comes out not
correct, once for each fault a training cell can have."""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import run
from portbench.tests import tiny

ROOT = run.ROOT
# limits for the tiny sizes, set from their sound readings on the CPU
# (loss 1e-6 / 3e-4, leaves <= 1.2e-4 / 2.6e-4 for the MLP / LM cells)
TINY_LIMITS = {
    "mlp_gossip_ws4200": {"loss_gap": 1e-4, "moment_gap": 1e-3, "change_gap": 1e-3,
                          "quarantined_gap": 0.0},
    "mlp_sync_grid1024": {"loss_gap": 1e-4, "moment_gap": 1e-3, "change_gap": 1e-3},
    "lm_repro100m_train_u4": {"loss_gap_first": 3e-3, "loss_gap": 3e-3, "moment_gap": 1e-2,
                              "change_gap": 1e-2, "merge_gap": 1e-2},
}


def tiny_run(cell, seed=20240601, trace=False, seconds=0.5):
    ov = dict(tiny.CELLS[cell], workload={"limits": TINY_LIMITS[cell]})
    return run.run_cell(cell, seed, seconds, trace, device="cpu", overrides=ov)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(cell):
    res = tiny_run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == set(TINY_LIMITS[cell])


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_result_line_schema(cell):
    res = tiny_run(cell, trace=False)
    res.pop("timing"), res.pop("forbidden")
    line, check_lines = run.result_line(res)
    obj = json.loads(line)
    assert list(obj)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(obj)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(obj["device"])
    names = {m["name"] for m in run.common.cell_metrics(cell, "end_to_end")}
    assert set(obj["metrics"]) == names and "setup_s" in names
    for m in obj["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert len(check_lines) == len(obj["checks"])
    assert all(line.startswith("check ") and " limit " in line for line in check_lines)


def test_traced_run_reads_spans_and_no_device_metric_on_the_cpu():
    res = tiny_run("mlp_gossip_ws4200", trace=True)
    assert res["correct"]
    assert "window_build_ms.gossip" in res["metrics"]
    # no device operation on the CPU: the device readers find nothing
    assert not any(k.startswith(("device_idle", "round_mfu", "eq6")) for k in res["metrics"])
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_nothing_of_jax_is_loaded():
    code = ("import sys, json; sys.path[:0] = [%r, %r]\n"
            "from portbench import run\nfrom portbench.tests import tiny\n"
            "res = run.run_cell('mlp_sync_grid1024', 3, 0.2, False, device='cpu', "
            "overrides=tiny.SYNC)\n"
            "print(json.dumps(res['forbidden']))\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'repro'))))" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True).stdout.splitlines()
    assert json.loads(out[-2]) == [] and json.loads(out[-1]) == []
    assert "repro_torch" in subprocess.run(
        [sys.executable, "-c", code.replace("json.dumps(res['forbidden'])",
                                            "' '.join(sorted(sys.modules))")],
        capture_output=True, text=True, timeout=600, check=True).stdout


def _draws_of_each_call(cell, monkeypatch):
    """Whether each of the run's round (MLP) or local-step (LM) calls was
    handed the benchmark's draws, in order."""
    handed = []
    if cell.startswith("lm"):
        from repro_torch.launch import steps

        orig = steps.make_local_step

        def make(*a, **k):
            step = orig(*a, **k)

            def step_fn(state, prior, batch, eps=None, generator=None):
                handed.append(eps is not None)
                return step(state, prior, batch, eps=eps, generator=generator)

            return step_fn

        monkeypatch.setattr(steps, "make_local_step", make)
    else:
        from repro_torch.api.session import Session

        orig = Session.round

        def round_(self, W=None, *, batch_idx=None, eps=None, batch_seed=None):
            handed.append(eps is not None and batch_idx is not None)
            return orig(self, W, batch_idx=batch_idx, eps=eps, batch_seed=batch_seed)

        monkeypatch.setattr(Session, "round", round_)
    return handed


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_only_the_check_rounds_take_the_benchmarks_draws(cell, monkeypatch):
    """The set-up's check rounds take the benchmark's draws (the reference
    draws the same); the window's rounds are the program's own, which draw
    their batches and noise themselves."""
    handed = _draws_of_each_call(cell, monkeypatch)
    res = tiny_run(cell, seconds=0.3)
    assert res["correct"], res["checks"]
    traffic = {**run.common.cell_files(cell)["traffic"], **tiny.CELLS[cell].get("traffic", {})}
    per_round = traffic["local_updates"] if cell.startswith("lm") else 1
    checked = traffic["check_rounds"] * per_round
    assert handed[:checked] == [True] * checked
    assert len(handed) == checked + res["attempted"] * per_round
    assert not any(handed[checked:])


def test_gossip_bound_counts_only_the_rows_that_move():
    """A gossip window's eq. (6) bound reads the merging rows and the kept
    edges' sources once and writes the merging rows once: below the bound
    of every row read and written, above that of the merging rows alone."""
    import torch

    ctx = run.Ctx("mlp_gossip_ws4200", 5, True, torch.device("cpu"), tiny.GOSSIP)
    driver = ctx.driver_module.Driver(ctx)
    stats = driver.trace_stats([{"round": r} for r in range(4)])["eq6_bytes"]
    for r, got in stats.items():
        win, corrupt = driver.window(r)
        merging = int(win.active.sum())
        assert 0 < merging < driver.n
        assert 16 * driver.p * merging < got < 16 * driver.p * driver.n


def test_forbidden_compares_whole_top_level_names():
    got = run.common.forbidden_loaded(["repro_torch", "repro_torch.api", "jaxtyping",
                                       "reprox", "repro", "repro.core", "jax.numpy", "flax"])
    assert got == ["flax", "jax.numpy", "repro", "repro.core"]


# -- faults planted in the program ------------------------------------------


def _unchanged_mlp(monkeypatch):
    from repro_torch.api import engines
    from repro_torch.gossip import engine as gossip

    for cls in (engines.SimulatedEngine, gossip.GossipEngine):
        orig = cls.run_round

        def run_round(self, state, *a, _orig=orig, **k):
            new, losses = _orig(self, state, *a, **k)
            return dataclasses.replace(new, posterior=state.posterior), losses

        monkeypatch.setattr(cls, "run_round", run_round)


def _half_batch_mlp(monkeypatch):
    from repro_torch.api import models

    orig = models.mlp_nll

    def nll(theta, batch):
        b = batch["x"].shape[1] // 2
        return 2.0 * orig(theta, {"x": batch["x"][:, :b], "y": batch["y"][:, :b]})

    monkeypatch.setattr(models, "mlp_nll", nll)


def _no_exchange_mlp(monkeypatch):
    from repro_torch.core import simulated
    from repro_torch.gossip import engine as gossip

    monkeypatch.setattr(simulated, "consensus_all_agents", lambda post, W, wire_dtype=None: post)
    monkeypatch.setattr(gossip, "consensus_flat_segments_quarantined",
                        lambda posts, dst, *a, **k: (posts, torch.ones(len(dst), dtype=torch.bool)))


def _loss_altered_mlp(monkeypatch):
    """Every agent's loss 1% off where it is computed (the cell compares
    the agents' gaps at their 99th percentile, so a wrong answer has to
    reach more than one agent in a hundred to show)."""
    from repro_torch.api import models

    orig = models.mlp_nll

    def nll(theta, batch):
        return 1.01 * orig(theta, batch)

    monkeypatch.setattr(models, "mlp_nll", nll)


def _unchanged_lm(monkeypatch):
    from repro_torch.launch import steps

    orig = steps.make_local_step

    def make(*a, **k):
        step = orig(*a, **k)

        def step_fn(state, prior, batch, eps=None, generator=None):
            new, loss = step(state, prior, batch, eps=eps, generator=generator)
            return dataclasses.replace(new, posterior=state.posterior), loss

        return step_fn

    monkeypatch.setattr(steps, "make_local_step", make)


def _half_batch_lm(monkeypatch):
    import repro_torch.models as models

    orig = models.nll_loss

    def nll_loss(params, cfg, batch, remat=False):
        b = batch["tokens"].shape[-2] // 2
        nll, aux = orig(params, cfg, {k: v[..., :b, :] for k, v in batch.items()}, remat)
        return 2.0 * nll, aux

    monkeypatch.setattr(models, "nll_loss", nll_loss)


def _no_exchange_lm(monkeypatch):
    from repro_torch.launch import steps

    monkeypatch.setattr(steps, "make_consensus_step", lambda cfg, W, wire_dtype=None: lambda p: p)


def _loss_altered_lm(monkeypatch):
    import repro_torch.models as models

    orig = models.nll_loss

    def nll_loss(params, cfg, batch, remat=False):
        nll, aux = orig(params, cfg, batch, remat)
        return nll + 0.1 * batch["targets"][0].numel(), aux

    monkeypatch.setattr(models, "nll_loss", nll_loss)


FAULTS = {
    "unchanged": (_unchanged_mlp, _unchanged_lm),
    "half_batch": (_half_batch_mlp, _half_batch_lm),
    "no_exchange": (_no_exchange_mlp, _no_exchange_lm),
    "loss_altered": (_loss_altered_mlp, _loss_altered_lm),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    plant = FAULTS[fault][1 if cell.startswith("lm") else 0]
    plant(monkeypatch)
    res = tiny_run(cell)
    assert not res["correct"], (fault, res["checks"])
    worst = max(c["value"] / max(c["limit"], 1e-300) if c["limit"] else
                (np.inf if c["value"] else 0.0) for c in res["checks"].values())
    assert worst > 1.0
