#!/usr/bin/env python3
"""The sharded gossip slice over the real cards of one host, against the
masked slice, bitwise.

    python3 probes/sharded_cards.py          # on a host with several cards

``chip_smoke.py``'s gossip slice (9 agents, 784-200-200-10, chaos faults,
quarantine, 4 windows) on ``consensus_impl="ppermute"`` with the default
devices, every card of the host, so the engine shards N = 9 over the
largest card count that divides it (3 of 4 cards): each rotation is a peer
copy.  At wire f32 and bf16 it prints each window's wall ms beside the
masked slice's, the bytes the rotations copied beside the cost model's
``window_ppermute``, and fails unless the states are bitwise equal and the
bytes agree.  On one card the engine runs one shard (no rotation).
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.api import build_session  # noqa: E402
from repro_torch.launch.consensus_opt import window_shard_offsets  # noqa: E402
from repro_torch.launch.costmodel import gossip_window_roofline  # noqa: E402


def main() -> int:
    dev = torch.device("cuda", 0)
    print("cards", torch.cuda.device_count(), cs.smi_name_power())
    clock = cs.gossip_spec().topology.gossip_clock()
    wins = [clock.window(r) for r in range(4)]
    for wire in ("f32", "bf16"):
        masked = build_session(cs.gossip_spec(wire_dtype=wire), device=dev)
        m_done = cs.sharded_windows(masked, 4)
        sharded = build_session(cs.gossip_spec(consensus_impl="ppermute", wire_dtype=wire),
                                device=dev)
        mesh = sharded.engine.mesh
        s_done = cs.sharded_windows(sharded, 4)
        S = mesh.n_shards
        modeled = [gossip_window_roofline(9, cs.P_SLICE, int(w.participating().sum()),
                                          n_shards=S,
                                          n_cross_offsets=len(window_shard_offsets(w, S)),
                                          wire_dtype=wire).get("ici_bytes", {})
                   .get("window_ppermute", 0) for w in wins]
        copied = [rot["bytes"] for _, _, rot in s_done]
        same = cs.states_bitwise(sharded.state, masked.state)
        cs.phase("real_cards", wire=wire, shards=S, devices=[str(d) for d in mesh.devices],
                 cards=mesh.n_cards, bitwise_masked=same,
                 sharded_window_wall_ms=[ms for _, ms, _ in s_done],
                 masked_window_wall_ms=[ms for _, ms, _ in m_done],
                 copied_bytes=copied, modeled_bytes=modeled,
                 health=sharded.health()["n_healthy"])
        if not same or copied != modeled:
            raise AssertionError(f"wire={wire}: bitwise {same}, copied {copied} vs {modeled}")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
