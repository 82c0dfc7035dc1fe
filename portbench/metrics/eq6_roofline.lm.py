"""The eq. (6) call's share of its byte bound in the LM cell: 16 A P +
4 A^2 + A bytes (every (mean, rho) row read once and written once, W, the
mask; ``costs.eq6_dense_bytes``) at the HBM peak, over the CUDA-event time
of ``launch.steps.make_consensus_step``'s call, averaged over the traced
rounds."""

from portbench import costs


def read(t):
    ms = t.stats.get("consensus_ms")
    if not ms:
        return None
    a, p = t.stats["agents"], t.stats["params"]
    bound_ms = costs.eq6_dense_bytes(a, p) / t.hbm * 1e3
    return 100.0 * bound_ms / (sum(ms) / len(ms))
