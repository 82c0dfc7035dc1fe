"""Quickstart on the PyTorch port: decentralized Bayesian learning in one
declarative spec, on the CUDA card.

Four agents, a star network, non-IID label partition of a synthetic
classification task.  Each round every agent runs a few Bayes-by-Backprop
steps on its local data, then precision-averages posteriors with its
neighbours (eq. 6, the hand-written consensus kernel on the card).  The
edge agents learn labels they have never seen.  The spec is
``examples/quickstart.py``'s; ``--engine launch`` runs the same experiment
on the production ``launch.steps`` path.

The reference example's convergence overlay (measured disagreement decay
against the ring's Theorem-1 rate) needs ``obs/convergence.py``, which the
port does not have yet (ROADMAP queue A item 8); this example prints a line
saying so in its place.

    PYTHONPATH=src python examples/torch_quickstart.py                 # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --rounds 5
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.api import (
    DataSpec,
    ExperimentSpec,
    InferenceSpec,
    RunSpec,
    TopologySpec,
    build_session,
)
from repro_torch.core.theory import stationary_distribution

SPEC = ExperimentSpec(
    # star: agent 0 (center) holds labels {1,2,3}; 3 edge agents share label 0
    topology=TopologySpec.star(n_edge=3, a=0.5),
    data=DataSpec(
        dataset_params=dict(n_classes=4, dim=32, n_train_per_class=150),
        partition="star",
        partition_params=dict(center_labels=[1, 2, 3], edge_labels=[0], n_edge=3),
        batch_size=16,
        local_updates=4,
    ),
    inference=InferenceSpec(hidden=32, depth=1, lr=5e-3, kl_scale=1e-3),
    run=RunSpec(n_rounds=20, seed=0, eval_every=5),
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--rounds", type=int, default=SPEC.run.n_rounds)
    ap.add_argument("--engine", default="simulated", choices=["simulated", "launch"])
    args = ap.parse_args(argv)
    spec = dataclasses.replace(SPEC, run=dataclasses.replace(
        SPEC.run, n_rounds=args.rounds, engine=args.engine,
        eval_every=min(SPEC.run.eval_every, args.rounds)))

    session = build_session(spec, device=args.device)
    W = spec.topology.w_schedule()(0)
    print("eigenvector centrality:", np.round(stationary_distribution(W), 3))

    hist = session.run(eval_fn=lambda s: s.evaluate())
    for rec in hist:
        accs = ", ".join(f"{a:.2f}" for a in rec["acc"])
        print(f"round {rec['round']:3d}  loss {rec['loss']:7.3f}  per-agent acc [{accs}]")
    final = hist[-1]["avg_acc"]
    print(f"\nfinal average accuracy {final:.3f} — edge agents classify labels "
          "1-3 they never observed locally (the paper's central claim).")

    print("\nconvergence overlay (lr=0 ring: measured decay vs Theorem-1 "
          "spectral rate):")
    print("  not in the port yet: it needs obs/convergence.py (ROADMAP queue A item 8)")


if __name__ == "__main__":
    main()
