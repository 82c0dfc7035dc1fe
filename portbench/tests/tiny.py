"""Tiny CPU sizes of each cell: the same drivers, references and checks
at a size a test run holds (the widths cut, a handful of agents)."""
from __future__ import annotations

MLP = {"config": {"dim": 12, "hidden": 8, "n_classes": 10}}
GOSSIP = {**MLP, "traffic": {
    "topology": {"kind": "sparse", "generator": "watts_strogatz", "n": 40, "k": 6, "beta": 0.1,
                 "graph_seed": 1},
    "clock": {"kind": "poisson", "rate": 0.3}}}
SYNC = {**MLP, "traffic": {"topology": {"kind": "grid", "rows": 4, "cols": 5}}}
LM_SIZES = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                vocab_size=256)
LM = {"config": dict(LM_SIZES), "traffic": {"batch_size": 2, "seq_len": 16}}

CELLS = {"mlp_gossip_ws4200": GOSSIP, "mlp_sync_grid1024": SYNC, "lm_repro100m_train_u4": LM}
