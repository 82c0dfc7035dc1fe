"""Serving entry point (port of ``repro.launch.serve``): train a small
decentralized network, publish a posterior snapshot, and serve batched
MC-predictive traffic against it (the paper's Sec 4.2 predictive
distribution behind the ``repro_torch.serve`` tier).

``build_session`` -> ``Session.run`` -> ``Session.snapshot`` ->
``Session.attach_server`` -> a ragged request stream round-robined over the
agents -> the server's latency percentiles, QPS and staleness/SLO
telemetry.  On the card each (bucket, row shape) is one CUDA-graph capture.

    PYTHONPATH=src python -m repro_torch.launch.serve --rounds 6 --requests 32 \
        --mc-samples 8 --snapshot-dtype bf16 --max-staleness 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --rounds 3
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.api import (
    DataSpec,
    ExperimentSpec,
    InferenceSpec,
    RunSpec,
    ServeSpec,
    TopologySpec,
    build_session,
)


def serving_spec(n_agents: int = 4, rounds: int = 6, seed: int = 0, *,
                 serve: ServeSpec = ServeSpec()) -> ExperimentSpec:
    """A small gossip network whose snapshots carry real staleness
    telemetry: the serving tier's natural substrate."""
    return ExperimentSpec(
        topology=TopologySpec.gossip("ring", {"n": n_agents}),
        data=DataSpec(
            dataset_params=dict(n_classes=4, dim=16, n_train_per_class=60),
            partition_params=dict(n_agents=n_agents),
            batch_size=8,
            local_updates=2,
        ),
        inference=InferenceSpec(hidden=16, depth=1, lr=5e-3),
        run=RunSpec(n_rounds=rounds, seed=seed),
        serve=serve,
    )


def main(argv=None) -> dict:
    """Train, publish, serve; print the reference's lines; return the
    server's telemetry."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--mc-samples", type=int, default=8,
                    help="posterior ensemble size L (0 = point estimate)")
    ap.add_argument("--snapshot-dtype", default="f32", choices=["f32", "bf16", "f16"])
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="SLO bound in training windows (default: off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    spec = serving_spec(
        args.agents, args.rounds, args.seed,
        serve=ServeSpec(snapshot_dtype=args.snapshot_dtype, mc_samples=args.mc_samples,
                        max_staleness=args.max_staleness, staleness_policy="flag"),
    )
    sess = build_session(spec, device=args.device)
    hist = sess.run(eval_every=args.rounds)  # history: final round only
    print(f"trained {args.rounds} windows x {args.agents} agents "
          f"(final loss {hist[-1]['loss'] if hist else None})")

    snap = sess.snapshot()
    print(f"published snapshot: window={snap.window} dtype={snap.dtype} "
          f"resident={snap.nbytes()}B telemetry={snap.telemetry}")

    server = sess.attach_server()
    rng = np.random.default_rng(args.seed)
    x_test = sess.data.x_test.cpu().numpy()
    # a ragged request stream round-robined over the agents
    sizes = rng.integers(1, 9, size=args.requests)
    for i, n in enumerate(sizes):
        rows = x_test[rng.integers(0, x_test.shape[0], size=int(n))]
        server.query(rows, agent=i % args.agents)  # returns once the answer is ready

    tel = server.telemetry()
    lat = tel.get("latency", {})
    warm = server._lat_us[len(server.bucket_sizes):]  # skip the capture batches
    qps = (1e6 * len(warm) / sum(warm)) if warm else 0.0
    print(f"served {tel['requests']} requests ({tel['rows']} rows, "
          f"{tel['batches']} bucket slabs, {tel['padded_rows']} pad rows, "
          f"{tel['traces']} traces)")
    print(f"latency p50={lat.get('p50_us', 0):.0f}us "
          f"p99={lat.get('p99_us', 0):.0f}us  warm-qps~{qps:.1f}")
    print("telemetry:", json.dumps(tel, default=float))
    return tel


if __name__ == "__main__":
    main()
