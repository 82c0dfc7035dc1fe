"""Serving quickstart on the PyTorch port: snapshot-isolated batched
MC-predictive inference, on the CUDA card.

Train a small gossip network, publish the consensus posterior into an
immutable double-buffered snapshot (bf16-resident: half the bytes), attach
a ``PredictiveServer``, and stream ragged request batches through its
padding-bucket programs (one CUDA-graph capture per bucket on the card)
under a bounded-staleness SLO.  The spec is ``examples/serve_batched.py``'s,
with ``ObsSpec`` on: request spans and serve counters land in the metrics
registry, the dashboard at the end reads them, and the trained posteriors
are bitwise what they would be without it.

    PYTHONPATH=src python examples/torch_serve_batched.py              # on the card
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu

Expected output (losses and timings vary; the structure and every count do
not):

    trained 6 windows, final loss <float>
    snapshot: window=6 dtype=bf16 bytes=1188 telemetry={'window': 6, ...}
    served 12 ragged requests through 12 bucket slabs -> 2 traces (one per bucket)
    point estimate (L=0) probs row sums: [1.0, 1.0, 1.0, 1.0, 1.0]
    after 3 more windows: snapshot_age=3 slo_ok=False
    after republish: snapshot_age=0 slo_ok=True
    evaluate() serving block: published=2 slo_breaches=1

    === session dashboard · engine=gossip round=9 ===
    ...                                  (loop, gossip and serving counters
                                          and the warm/compile span table)
"""
import argparse

import numpy as np

from repro_torch.api import (
    DataSpec,
    ExperimentSpec,
    InferenceSpec,
    ObsSpec,
    RunSpec,
    ServeSpec,
    TopologySpec,
    build_session,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--rounds", type=int, default=6, help="training windows before serving")
    args = ap.parse_args(argv)
    n_agents = 3
    spec = ExperimentSpec(
        topology=TopologySpec.gossip("ring", {"n": n_agents}),
        data=DataSpec(
            dataset_params=dict(n_classes=3, dim=8, n_train_per_class=40),
            partition_params=dict(n_agents=n_agents),
            batch_size=4,
            local_updates=2,
        ),
        inference=InferenceSpec(hidden=8, depth=1, lr=1e-2),
        run=RunSpec(n_rounds=args.rounds, seed=0),
        serve=ServeSpec(
            snapshot_dtype="bf16",   # half the serving bytes, fp32 decode
            mc_samples=8,            # paper Sec 4.2 ensemble size L
            bucket_sizes=(4, 16),    # the captured padding buckets
            max_staleness=2,         # SLO: refuse/flag >2-window-old answers
            staleness_policy="flag",
        ),
        # pure observer: the dashboard below reads the registry it fills
        obs=ObsSpec(enabled=True),
    )
    sess = build_session(spec, device=args.device)
    hist = sess.run(eval_every=spec.run.n_rounds)  # history: final round only
    print(f"trained {spec.run.n_rounds} windows, final loss {hist[-1]['loss']:.3f}")

    # publish the serving copy: an immutable, decoupled, bf16-resident
    # snapshot; training keeps changing its own buffers untouched
    snap = sess.snapshot()
    print(f"snapshot: window={snap.window} dtype={snap.dtype} "
          f"bytes={snap.nbytes()} telemetry={snap.telemetry}")

    server = sess.attach_server()
    rng = np.random.default_rng(0)
    x_test = sess.data.x_test.cpu().numpy()

    # a ragged stream: request sizes 1..9 all route through the two
    # buckets (4 and 16); the count of programs stays put
    for i in range(12):
        n = int(rng.integers(1, 10))
        rows = x_test[rng.integers(0, x_test.shape[0], size=n)]
        probs, meta = server.query(rows, agent=i % n_agents)
        assert np.allclose(probs.sum(-1).cpu().numpy(), 1.0, atol=1e-5)
    print(f"served 12 ragged requests through {server.n_batches} bucket "
          f"slabs -> {server.n_traces} traces (one per bucket)")

    # the L=0 point estimate: one softmax at the posterior mean
    probs0, _ = server.query(x_test[:5], mc_samples=0)
    print(f"point estimate (L=0) probs row sums: "
          f"{probs0.sum(-1).cpu().numpy().round(4).tolist()}")

    # age the snapshot past the SLO: policy="flag" keeps serving but marks
    # the answer (policy="strict" would raise serve.StalenessSLOError)
    sess.run(n_rounds=3)
    _, meta = server.query(x_test[:2])
    print(f"after 3 more windows: snapshot_age={meta['snapshot_age']} "
          f"slo_ok={meta['slo_ok']}")

    # republish -> back inside the SLO
    sess.snapshot()
    _, meta = server.query(x_test[:2])
    print(f"after republish: snapshot_age={meta['snapshot_age']} slo_ok={meta['slo_ok']}")

    serving = sess.evaluate(n_mc=2)["serving"]
    print(f"evaluate() serving block: published={serving['published']} "
          f"slo_breaches={serving['slo']['breaches']}")

    # the same numbers from the metrics registry, as a terminal summary:
    # loop counters, gossip staleness, serving state, and the span table
    print()
    print(sess.dashboard())


if __name__ == "__main__":
    main()
