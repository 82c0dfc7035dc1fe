"""Asynchronous gossip quickstart on the PyTorch port: Poisson clocks, link
failures, delayed delivery, and the sharded window consensus, on the CUDA
card.

The spec is ``examples/async_gossip.py``'s: eight agents on a bidirectional
ring learn a synthetic classification task with no global synchronization.
Every directed link carries its own Poisson activation clock, and each fired
link fails with probability 0.1.  Time is discretized into event windows
(``repro_torch.gossip.clocks``); each window runs the local
Bayes-by-Backprop steps, then the masked active-edge consensus, in which
idle agents pass through bit-untouched.

The same declarative spec then runs delayed delivery (every message
arrives 2 windows late, from a ``[K, N, P]`` history ring), the sharded
consensus (``InferenceSpec(consensus_impl="ppermute")``: the agent axis
split into 4 shards, one rotation of the shards' wire statistics per fired
cross-shard offset; on one card or the CPU the 4 shards are virtual, as the
reference forces 4 virtual CPU devices; bitwise the dense run), the bf16
wire (half the exchange bytes), chaos faults under quarantine, a
Watts-Strogatz base graph, and one consensus round at N = 10,000 through
the edge-native path without an [N, N] matrix.

    PYTHONPATH=src python examples/torch_async_gossip.py              # on the card
    PYTHONPATH=src python examples/torch_async_gossip.py --device cpu --rounds 3
"""
import argparse
import dataclasses

import torch

from repro_torch.api import (
    DataSpec,
    ExperimentSpec,
    InferenceSpec,
    ObsSpec,
    RunSpec,
    TopologySpec,
    build_session,
)

N_AGENTS = 8
SHARDS = 4  # the reference's virtual device count

# ring base graph; Poisson link clocks (rate 0.8 firings/window) with 10% of
# fired messages dropped: the unreliable-network scenario
UNRELIABLE_CLOCK = {
    "kind": "failure_injected",
    "inner": {"kind": "poisson", "rate": 0.8, "seed": 0},
    "drop_rate": 0.1,
}

SPEC = ExperimentSpec(
    topology=TopologySpec.gossip(
        "bidirectional_ring", {"n": N_AGENTS}, clock=UNRELIABLE_CLOCK
    ),
    data=DataSpec(
        dataset_params=dict(n_classes=4, dim=32, n_train_per_class=120),
        # non-IID: each pair of ring neighbors holds ONE label; only gossip
        # spreads the other three around the ring
        partition="by_label",
        partition_params=dict(label_sets=[[c] for c in range(4) for _ in range(2)]),
        batch_size=16,
        local_updates=4,
    ),
    inference=InferenceSpec(hidden=32, depth=1, lr=5e-3, kl_scale=1e-3),
    run=RunSpec(n_rounds=30, seed=0, eval_every=10),
)


def _print_history(hist):
    for rec in hist:
        st = rec["engine"]["staleness"]
        loss = "  idle " if rec["loss"] is None else f"{rec['loss']:7.3f}"
        print(
            f"window {rec['round']:3d}  loss {loss}  "
            f"trained {rec['n_trained']:2d}/{N_AGENTS}  "
            f"avg_acc {rec['avg_acc']:.3f}  "
            f"staleness p50/p90/max {st['p50']:.0f}/{st['p90']:.0f}/{st['max']}"
        )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--rounds", type=int, default=SPEC.run.n_rounds)
    args = ap.parse_args(argv)
    spec = dataclasses.replace(SPEC, run=dataclasses.replace(
        SPEC.run, n_rounds=args.rounds, eval_every=min(SPEC.run.eval_every, args.rounds)))

    def session_for(s, **kw):
        return build_session(s, device=args.device, **kw)

    session = session_for(spec)  # validates the activation union eagerly
    hist = session.run(eval_fn=lambda s: s.evaluate())
    _print_history(hist)
    tel = session.evaluate()["engine"]
    print(
        f"\n{tel['windows']} event windows, "
        f"{tel['merges']['total']} merges "
        f"({tel['merges']['per_agent_mean']:.1f}/agent, "
        f"min {tel['merges']['min']}); one jitted call per window "
        f"(traced {session.engine.n_traces}x).\n"
        "Despite asynchronous, unreliable links every agent classifies all "
        "labels — the paper's consensus claim survives the gossip regime.\n"
    )
    # the same numbers, observed live: rerun with the observability layer
    # attached (ObsSpec is a pure observer: bit-identical trajectories)
    observed = session_for(dataclasses.replace(spec, obs=ObsSpec(enabled=True)))
    observed.run()
    print(observed.dashboard(), "\n")

    # -- delayed delivery: every message arrives 2 windows late -------------
    delayed_spec = dataclasses.replace(
        spec,
        topology=TopologySpec.gossip(
            "bidirectional_ring", {"n": N_AGENTS},
            clock={"kind": "delayed", "inner": UNRELIABLE_CLOCK,
                   "latency": {"kind": "constant", "delay": 2}},
        ),
    )
    delayed = session_for(delayed_spec)
    d_hist = delayed.run(eval_fn=lambda s: s.evaluate())
    d_tel = delayed.evaluate()["engine"]
    print(
        f"Delayed delivery (k={d_tel['max_delay']} windows, "
        f"{delayed.engine.hist_slots}-slot posterior history ring): "
        f"final avg_acc {d_hist[-1]['avg_acc']:.3f} vs instant "
        f"{hist[-1]['avg_acc']:.3f} — consensus still mixes, only later."
    )

    # -- sharded window consensus: the agent axis over 4 shards --------------
    sharded_spec = dataclasses.replace(
        spec,
        inference=dataclasses.replace(spec.inference, consensus_impl="ppermute"),
    )
    device = session.device
    sharded = session_for(sharded_spec, devices=[device] * SHARDS)
    s_hist = sharded.run(eval_fn=lambda s: s.evaluate())
    s_tel = sharded.evaluate()["engine"]
    bitwise = bool(torch.equal(sharded.posterior().mean, session.posterior().mean))
    print(
        f"Sharded windows ({s_tel['consensus_shards']} shards over "
        f"{sharded.engine.mesh.n_cards} devices, ppermute on fired offsets only): "
        f"avg_acc {s_hist[-1]['avg_acc']:.3f}, bit-identical to the dense "
        f"run: {bitwise}."
    )

    # -- bf16 wire: half the exchange bytes, error-bounded posterior --------
    from repro_torch.launch.costmodel import gossip_window_roofline

    wire_spec = dataclasses.replace(
        spec,
        inference=dataclasses.replace(spec.inference, wire_dtype="bf16"),
    )
    wired = session_for(wire_spec)
    w_hist = wired.run(eval_fn=lambda s: s.evaluate())
    w_tel = wired.evaluate()["engine"]
    dev = float((wired.posterior().mean - session.posterior().mean).abs().max())
    n_params = int(wired.posterior().mean.shape[-1])
    model = {
        wd: gossip_window_roofline(
            N_AGENTS, n_params, n_participating=N_AGENTS,
            n_shards=SHARDS, n_cross_offsets=2, wire_dtype=wd,
        )["ici_bytes"]["window_ppermute"]
        for wd in ("f32", "bf16")
    }
    print(
        f"bf16 wire ({w_tel['wire_dtype']} exchange, fp32 accumulate): "
        f"avg_acc {w_hist[-1]['avg_acc']:.3f} vs fp32 "
        f"{hist[-1]['avg_acc']:.3f}; max posterior deviation {dev:.2e}; "
        f"modeled window wire bytes {model['f32']:.0f} -> {model['bf16']:.0f} "
        f"({model['f32'] / model['bf16']:.0f}x fewer)."
    )

    # -- chaos: agent churn + payload corruption under quarantine -----------
    chaos_spec = dataclasses.replace(
        spec,
        topology=TopologySpec.gossip(
            "bidirectional_ring", {"n": N_AGENTS},
            clock=dict(
                UNRELIABLE_CLOCK,
                faults={"crash_rate": 0.15, "recover_rate": 0.5,
                        "corrupt_rate": 0.2, "corrupt_kind": "mix",
                        "seed": 7},
            ),
        ),
        inference=dataclasses.replace(spec.inference, fault_policy="quarantine"),
    )
    chaotic = session_for(chaos_spec)
    c_hist = chaotic.run(eval_fn=lambda s: s.evaluate())
    c_tel = chaotic.evaluate()["engine"]
    faults = c_tel["faults"]
    health = chaotic.health()
    n_crashed = sum(rec.get("n_crashed", 0) for rec in c_hist)
    print(
        f"Chaos run (15% crash / 50% recover churn, 20% payload "
        f"corruption, quarantine defense): avg_acc "
        f"{c_hist[-1]['avg_acc']:.3f} vs undisturbed "
        f"{hist[-1]['avg_acc']:.3f};\n"
        f"  {n_crashed} crashed agent-windows "
        f"(mean uptime {faults['uptime']['frac_mean']:.2f}, "
        f"least-up agent {faults['uptime']['min']}/{c_tel['windows']} "
        f"windows), "
        f"{faults['quarantined']['total']} contributions quarantined "
        f"(per agent: {faults['quarantined']['per_agent']});\n"
        f"  healthy posteriors {health['n_healthy']}/{N_AGENTS} — the "
        f"injected NaN/Inf garbage never reached a resident posterior."
    )

    # -- small-world gossip: Watts-Strogatz base instead of the ring --------
    ws_spec = dataclasses.replace(
        spec,
        topology=TopologySpec.gossip(
            "watts_strogatz",
            {"n": N_AGENTS, "k": 4, "beta": 0.3, "seed": 0},
            clock=UNRELIABLE_CLOCK,
        ),
    )
    ws = session_for(ws_spec)
    ws_hist = ws.run(eval_fn=lambda s: s.evaluate())
    print(
        f"Watts-Strogatz base (k=4, beta=0.3 — ring + shortcut rewires): "
        f"avg_acc {ws_hist[-1]['avg_acc']:.3f} vs ring "
        f"{hist[-1]['avg_acc']:.3f}; shortcuts shrink the gossip mixing "
        f"diameter the label-partitioned data has to cross."
    )

    # -- the same generator at population scale: no [N, N], ever ------------
    # above ~10^3 agents the dense W is the bottleneck (N=1e5 would be a
    # 40 GB matrix).  TopologySpec.sparse keeps the topology as CSR edge
    # arrays end to end: validation, consensus, and the gossip windows all
    # run on [E]-shaped buffers.
    from repro_torch.core.flat import FlatLayout, FlatPosterior, consensus_flat_segments

    big = TopologySpec.sparse("watts_strogatz", n=10_000, k=6, beta=0.1, seed=0)
    big.validate()  # row-stochasticity + strong connectivity, all on CSR
    g = big.sparse_graph()
    dst, src, w = g.edge_arrays()
    layout = FlatLayout.for_pytree({"w": torch.zeros(8)})
    posts = FlatPosterior(
        mean=torch.zeros((g.n_agents, 8), device=device),
        rho=torch.ones((g.n_agents, 8), device=device),
        layout=layout,
    )
    merged = consensus_flat_segments(posts, dst, src, w)
    graph_bytes = g.indices.nbytes + g.weights.nbytes + g.indptr.nbytes
    print(
        f"Population scale: one eq.-(6) consensus round over "
        f"N={g.n_agents} agents / E={g.n_edges} directed edges via "
        f"segment-sum — peak graph memory {graph_bytes:,} "
        f"bytes (O(E); the dense W would be {8 * g.n_agents**2:,}), "
        f"output finite: {bool(torch.isfinite(merged.mean).all())}."
    )
    return {"sharded_bitwise": bitwise, "shards": s_tel["consensus_shards"]}


if __name__ == "__main__":
    main()
