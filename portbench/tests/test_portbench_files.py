"""The benchmark's files: every cell, configuration, traffic mix, driver,
reference and per-layer reader is found by the name ``BENCHMARK.json``
gives it, and ``BENCHMARK.json`` keeps to the benchmark's contract."""
from __future__ import annotations

import math
import re

import pytest

from portbench import common, costs

DOC = common.benchmark_doc()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_cell_files_are_found_by_name(cell):
    files = common.cell_files(cell)
    assert files["config"]["name"] == files["entry"]["config"]
    assert files["driver_path"].is_file() and files["reference_path"].is_file()
    assert files["workload"]["limits"]
    mod = common.load_module(files["driver_path"], files["traffic"]["driver"])
    assert hasattr(mod, "Driver")
    ref = common.load_module(files["reference_path"], files["entry"]["config"])
    assert ref.n_params(files["config"]) == files["config"]["params_per_agent"]


@pytest.mark.parametrize("metric", [m["name"] for m in DOC["per_layer"]])
def test_per_layer_readers_are_found_by_name(metric):
    mod = common.load_module(common.find("metrics", metric, ".py"), metric)
    assert callable(mod.read)


def test_contract():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["portbench"] and 1 <= DOC["run_seconds"] <= 51
    assert all(len(w) <= 200 and not w.startswith("/") and ".." not in w for w in DOC["command"])
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for x in DOC[sec]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in DOC["configs"]}
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and 1 <= len(c["why"]) <= 200
    cells = {w["name"]: w for w in DOC["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in DOC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in DOC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m["workloads"]:  # each cell that reads it reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:  # setup_s, one other end-to-end metric, one per-layer metric
        assert len(common.cell_metrics(cell, "end_to_end")) >= 2
        assert common.cell_metrics(cell, "per_layer")


def test_costs_at_hand_computed_shapes():
    mlp = {"dim": 784, "hidden": 200, "depth": 2, "n_classes": 10}
    assert costs.mlp_weights(mlp) == 784 * 200 + 200 * 200 + 200 * 10 == 198_800
    assert costs.mlp_train_flops(mlp, 64) == 6 * 198_800 * 64
    assert costs.posterior_adam_bytes(3, 5) == 2 * 6 * 3 * 5 * 4
    assert costs.eq6_dense_bytes(4, 10) == 16 * 4 * 10 + 4 * 16 + 4
    # 3 rows read (2 sources, 2 merging rows, one row both), 2 written, 5 edges kept
    assert costs.eq6_edges_bytes(10, 3, 2, 5) == 8 * 10 * 3 + 8 * 10 * 2 + 8 * (5 + 2)
    lm = {"d_model": 768, "n_heads": 12, "n_kv_heads": 12, "d_ff": 3072, "vocab_size": 32768,
          "n_layers": 12}
    per_layer = 4 * 768 * 768 + 3 * 768 * 3072
    assert costs.lm_matmul_params(lm) == 12 * per_layer + 768 * 32768 == 138_412_032
    tokens, s = 2 * 4 * 16 * 512, 512
    attn = 3 * 4 * 768 * (2 * 4 * 16) * s * (s + 1) / 2 * 12
    assert math.isclose(costs.lm_train_flops(lm, 2 * 4 * 16, s),
                        6 * 138_412_032 * tokens + attn)
    assert 5.6e13 < costs.lm_train_flops(lm, 2 * 4 * 16, s) < 5.7e13


def test_sub_seeds_are_stable_and_distinct():
    a = common.sub_seed(2 ** 31 + 5, "eps", 3)
    assert a == common.sub_seed(2 ** 31 + 5, "eps", 3) and 0 <= a < 2 ** 63
    assert a != common.sub_seed(2 ** 31 + 5, "eps", 4) != common.sub_seed(2 ** 31 + 6, "eps", 3)


def test_norm_gap_is_the_worst_leaf_against_its_own_or_the_median_norm():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-6}
    prog = {"a": 1.01, "b": 2.0, "c": 2e-6}
    gap = common.norm_gaps(prog, ref)
    assert math.isclose(gap, 0.01)  # a's; c's 1e-6 is against the median, 1.0
    assert common.still_leaves({"a": 1.0, "b": 2.0, "c": 1e-6}) == ["c"]
    assert common.loss_gap([1.0, float("nan")], [1.0, 2.0]) == float("inf")
