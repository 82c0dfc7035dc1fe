"""``repro_torch.serve``: the posterior serving tier (port of
``repro.serve``).

Snapshot-isolated, batched MC-predictive inference against a live
``Session``: ``snapshot.SnapshotStore`` double-buffers immutable copies of
the consensus ``FlatPosterior`` (optionally bf16-resident, half the bytes),
and ``server.PredictiveServer`` serves the paper's Monte-Carlo predictive
distribution from the front buffer through padding-bucket programs captured
once (CUDA graphs on the card), under a bounded-staleness SLO.

    sess.run(n_rounds=8)
    sess.snapshot(dtype="bf16")            # publish the serving copy
    server = sess.attach_server(mc_samples=8, max_staleness=4)
    probs, meta = server.query(x, agent=0)

``examples/torch_serve_batched.py`` is the full tour.
"""
from repro_torch.serve.server import DEFAULT_BUCKETS, PredictiveServer, StalenessSLOError
from repro_torch.serve.snapshot import PosteriorSnapshot, SnapshotStore, take_snapshot

__all__ = [
    "DEFAULT_BUCKETS",
    "PosteriorSnapshot",
    "PredictiveServer",
    "SnapshotStore",
    "StalenessSLOError",
    "take_snapshot",
]
