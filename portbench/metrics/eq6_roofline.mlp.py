"""The eq. (6) kernels' share of their byte bound in an MLP cell: the
bound of the traced rounds' merges at the HBM peak (``costs.eq6_dense_bytes``
over every row; ``costs.eq6_edges_bytes`` over the rows a gossip window
reads and writes) over the profiled device time of the kernels named here
(``csrc/consensus_network.cu``, ``csrc/consensus_segments.cu``).  Nothing
where none of them ran."""

EQ6_KERNELS = (
    "consensus_small_kernel",
    "consensus_generic_kernel",
    "consensus_segments_kernel",
    "consensus_segments_tile_kernel",
)


def read(t):
    seconds = t.kernel_seconds(EQ6_KERNELS)
    if seconds <= 0:
        return None
    bound = sum(t.stats["eq6_bytes"][r["round"]] for r in t.rounds) / t.hbm
    return 100.0 * bound / seconds
