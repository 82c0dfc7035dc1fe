"""Paper Example 1 / Fig 1 on the PyTorch port: decentralized Bayesian
linear regression with theta* = [-0.3, 0.5, 0.5, 0.1, 0.2], noise 0.8, each
of the 4 agents observing only one input coordinate, on the paper's own
social-interaction matrix from supplementary 1.3: the exact-conjugate
inference family (``InferenceSpec(method="conjugate_linreg")``,
full-covariance posteriors, eq. 2 local updates + eq. 6 consensus), on the
CUDA card.  The spec is ``examples/linear_regression.py``'s.

    PYTHONPATH=src python examples/torch_linear_regression.py             # on the card
    PYTHONPATH=src python examples/torch_linear_regression.py --device cpu --rounds 20
"""
import argparse

import numpy as np

from repro_torch.api import (
    DataSpec,
    ExperimentSpec,
    InferenceSpec,
    RunSpec,
    TopologySpec,
    build_session,
)
from repro_torch.core.theory import lambda_max, stationary_distribution

# supplementary 1.3 weights (4 agents)
W = np.array([
    [0.5, 0.5, 0.0, 0.0],
    [0.3, 0.1, 0.3, 0.3],
    [0.0, 0.5, 0.5, 0.0],
    [0.0, 0.5, 0.0, 0.5],
])

SPEC = ExperimentSpec(
    topology=TopologySpec.explicit(W),
    data=DataSpec(dataset="linreg", batch_size=10),
    inference=InferenceSpec(method="conjugate_linreg", prior_var=0.5),
    run=RunSpec(n_rounds=200, seed=0),
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--rounds", type=int, default=SPEC.run.n_rounds,
                    help="total rounds, reported in five equal legs")
    args = ap.parse_args(argv)
    print("centrality:", np.round(stationary_distribution(W), 3),
          " lambda_max:", round(lambda_max(W), 3))
    session = build_session(SPEC, device=args.device)  # validates W (Assumption 1) eagerly
    task = session.data.dataset
    for _ in range(5):
        session.run(max(args.rounds // 5, 1))
        mses = session.evaluate()["mse"]
        print(f"round {session.round_idx:4d}  per-agent test MSE "
              + " ".join(f"{m:.4f}" for m in mses)
              + f"   (noise floor {task.noise_std**2:.3f})")
    posts = session.posterior()
    print("\ntheta*      =", np.round(task.theta_star, 3))
    print("agent 0 mu  =", np.round(posts.mean[0].cpu().numpy(), 3))
    print("every agent recovered theta* despite observing a single coordinate.")


if __name__ == "__main__":
    main()
