"""On the card: each cell's control, the reference computed in the
precision below the configuration's and put in the program's place, comes
out beyond one of the cell's limits, at a size a test run holds (the MLP
at full width over 64 agents; repro-100m at full width on 2 x 2 x 128
tokens).  Its full-size readings are in PERF.md."""
from __future__ import annotations

import pytest

from portbench import common, control

SMALL = {
    "mlp_gossip_ws4200": {"traffic": {"topology": {
        "kind": "sparse", "generator": "watts_strogatz", "n": 64, "k": 6, "beta": 0.1,
        "graph_seed": 1}}},
    "mlp_sync_grid1024": {"traffic": {"topology": {"kind": "grid", "rows": 8, "cols": 8}}},
    "lm_repro100m_train_u4": {"traffic": {"batch_size": 2, "seq_len": 128}},
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell, card):
    limits = common.load_json(common.find("workloads", cell, ".json"))["limits"]
    lines = control.readings(cell, [7, 8, 9], False, True, [], device=card,
                             overrides=SMALL[cell], emit=lambda *a, **k: None)
    for line in lines:
        assert any(line["numbers"][k] > v for k, v in limits.items()), line
