"""Communication-network topologies and social-interaction matrices W.

The paper (Sec 2) models the network as a directed graph with a
row-stochastic weight matrix W: W_ij > 0 iff j in N(i) (i receives from j),
sum_j W_ij = 1, and i in N(i).  Assumption 1 requires W irreducible and
aperiodic.  Every builder here returns a row-stochastic numpy/jnp array and
is validated by ``check_w``.

Topologies used in the paper's experiments:
  * star (Sec 4.2.1): central agent 0 uniform over all; edge agent i puts
    confidence ``a`` on the center and 1-a on itself.
  * grid 3x3 (Sec 4.2.2): W_ij = 1/|N(i)| (degree-uniform).
  * time-varying star (Sec 1.4.3): at round t only N0 edge agents are
    connected to agent 0; union over the schedule is strongly connected.
Plus general builders (ring, torus, complete, erdos) for the framework.

Sparse-first representation
---------------------------
``SparseGraph`` is the edge-native counterpart: CSR-style ``indptr`` /
``indices`` / ``weights`` over directed IN-edges (row i lists the sources j
with W_ij > 0, self-loop included), row-stochastic by construction.  The
sparse builders (``ring_sparse``, ``grid_sparse``, ``torus_sparse``,
``star_sparse``, ``bidirectional_ring_sparse``) and the small-world
generators (``watts_strogatz_sparse``, ``barabasi_albert_sparse``) never
materialize ``[N, N]`` — peak host memory is O(E).  Assumption 1 is
validated by ``strongly_connected_csr``, an iterative (frontier-BFS)
Kosaraju check directly on the CSR arrays: reachability from node 0 in the
support graph AND in its counting-sort transpose — no networkx, no dense
conversion, no recursion.  ``to_dense()`` / ``from_dense()`` bridge to the
dense builders so every existing W interops; the dense validators
(``check_w`` / ``check_schedule_union``) now route through the same sparse
checker.
"""
from __future__ import annotations

import dataclasses

import numpy as np


# ---------------------------------------------------------------------------
# Iterative strong-connectivity check on CSR arrays (Assumption 1)
# ---------------------------------------------------------------------------


def _csr_transpose(indptr: np.ndarray, indices: np.ndarray, n: int):
    """Transpose a CSR support graph via a stable counting sort: O(E)."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    order = np.argsort(indices, kind="stable")
    t_indices = rows[order]
    t_indptr = np.zeros(n + 1, dtype=np.int64)
    t_indptr[1:] = np.cumsum(np.bincount(indices, minlength=n))
    return t_indptr, t_indices


def _reaches_all(indptr: np.ndarray, indices: np.ndarray, n: int) -> bool:
    """Does node 0 reach every node?  Iterative frontier BFS, no recursion."""
    seen = np.zeros(n, dtype=bool)
    seen[0] = True
    frontier = np.array([0], dtype=np.int64)
    visited = 1
    while frontier.size:
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        # Gather every frontier row's neighbor slice in one vectorized pass:
        # position k of the flat gather reads indices[starts[r] + offset]
        # where r is k's row and offset is k's rank within that row.
        row_of = np.repeat(np.arange(frontier.size), counts)
        offsets = np.arange(total) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        nbrs = indices[starts[row_of] + offsets]
        fresh = np.unique(nbrs[~seen[nbrs]])
        if fresh.size == 0:
            break
        seen[fresh] = True
        visited += fresh.size
        frontier = fresh
    return visited == n


def strongly_connected_csr(
    indptr: np.ndarray, indices: np.ndarray, n: int | None = None
) -> bool:
    """Is the digraph described by CSR ``indptr``/``indices`` strongly
    connected?

    Iterative Kosaraju-style check: strong connectivity holds iff node 0
    reaches every node in the support graph AND in its transpose.  Works on
    either edge orientation (strong connectivity is invariant under
    transposition); here the convention is rows = in-edges, matching
    ``SparseGraph``.  Pure numpy, O(E) time and memory, no recursion — safe
    at N = 10^5+ where both ``sys.setrecursionlimit`` DFS and a dense
    ``[N, N]`` conversion would fall over.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    if n is None:
        n = indptr.shape[0] - 1
    if n <= 1:
        return True
    if indices.size == 0:
        return False
    if not _reaches_all(indptr, indices, n):
        return False
    t_indptr, t_indices = _csr_transpose(indptr, indices, n)
    return _reaches_all(t_indptr, t_indices, n)


# ---------------------------------------------------------------------------
# SparseGraph: edge-native row-stochastic topology
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SparseGraph:
    """CSR-style row-stochastic directed graph over IN-edges.

    Row i of the CSR (``indices[indptr[i]:indptr[i+1]]``) lists the source
    agents j that agent i listens to (W_ij > 0), self-loop included;
    ``weights`` holds the matching W_ij.  This is the native representation
    for every O(E) code path: segment-sum consensus
    (``core.flat.consensus_flat_segments``), padded neighbor tables for the
    Pallas sparse kernels, and the E-parameterized rooflines.  ``to_dense``
    exists as an interop bridge only — the builders here never allocate
    ``[N, N]``.
    """

    indptr: np.ndarray  # [N + 1] int64, monotone
    indices: np.ndarray  # [E] int32 source ids, ascending within each row
    weights: np.ndarray  # [E] float64 W_ij, rows sum to 1

    @property
    def n_agents(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        """Directed edge count INCLUDING self-loops (CSR nnz)."""
        return int(self.indices.shape[0])

    @property
    def in_degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def max_in_degree(self) -> int:
        return int(self.in_degrees.max()) if self.n_agents else 0

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(sources, weights) of agent i's in-edges."""
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        return self.indices[lo:hi], self.weights[lo:hi]

    @classmethod
    def from_dense(cls, W: np.ndarray) -> "SparseGraph":
        """Bridge from any dense row-stochastic W (no validation here —
        call ``validate()`` for the Assumption-1 checks)."""
        Wn = np.asarray(W, dtype=np.float64)
        n = Wn.shape[0]
        if Wn.shape != (n, n):
            raise ValueError(f"W must be square, got {Wn.shape}")
        rows = [np.nonzero(Wn[i])[0] for i in range(n)]
        indptr = np.zeros(n + 1, dtype=np.int64)
        indptr[1:] = np.cumsum([len(r) for r in rows])
        indices = (
            np.concatenate(rows).astype(np.int32)
            if n
            else np.zeros(0, np.int32)
        )
        weights = (
            np.concatenate([Wn[i, r] for i, r in enumerate(rows)])
            if n
            else np.zeros(0, np.float64)
        )
        return cls(indptr=indptr, indices=indices, weights=weights)

    def to_dense(self) -> np.ndarray:
        """Interop bridge: materialize the dense [N, N] W.  Only call this
        below the spec size guard — it is the one place the sparse path is
        allowed to go quadratic."""
        n = self.n_agents
        W = np.zeros((n, n), dtype=np.float64)
        dst = np.repeat(np.arange(n, dtype=np.int64), self.in_degrees)
        W[dst, self.indices] = self.weights
        return W

    def edge_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flat [E] edge arrays (dst, src, w) for segment-sum consensus.

        Self-loops are included — ``consensus_flat_segments`` needs no
        separate diagonal term.  dst/src are int32, w is float32 (the
        weights' compute dtype at the kernel boundary).
        """
        dst = np.repeat(
            np.arange(self.n_agents, dtype=np.int32),
            self.in_degrees.astype(np.int64),
        )
        return dst, self.indices.astype(np.int32), self.weights.astype(np.float32)

    def neighbor_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """Padded [N, D] neighbor tables for ``consensus_fused_sparse``.

        Identical contract (and bit pattern) to the historical dense-W
        extraction: D = max in-degree, ragged rows padded with the agent's
        own id at weight 0.0, weights cast to float32.  This is THE one CSR
        construction behind ``core.flat.neighbor_tables``,
        ``neighbor_lists`` and ``max_in_degree``.
        """
        n, d = self.n_agents, max(self.max_in_degree, 1)
        neighbors = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, d))
        weights = np.zeros((n, d), np.float32)
        for i in range(n):
            lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
            neighbors[i, : hi - lo] = self.indices[lo:hi]
            weights[i, : hi - lo] = self.weights[lo:hi]
        return neighbors, weights

    def strongly_connected(self) -> bool:
        return strongly_connected_csr(self.indptr, self.indices, self.n_agents)

    def validate(self, *, require_connected: bool = True) -> None:
        """Assumption-1 prerequisites, sparse edition: the exact checks of
        ``check_w`` without ever leaving O(E) memory."""
        n = self.n_agents
        if self.indptr.shape != (n + 1,) or int(self.indptr[0]) != 0:
            raise ValueError("indptr must be [N+1] starting at 0")
        if np.any(np.diff(self.indptr) < 0):
            raise ValueError("indptr must be monotone")
        if int(self.indptr[-1]) != self.indices.shape[0]:
            raise ValueError("indptr[-1] must equal len(indices)")
        if self.weights.shape != self.indices.shape:
            raise ValueError("weights and indices must be the same length")
        if self.indices.size and (
            int(self.indices.min()) < 0 or int(self.indices.max()) >= n
        ):
            raise ValueError("edge sources out of range")
        if np.any(self.weights < 0):
            raise ValueError("W must be nonnegative")
        row_sums = np.zeros(n)
        dst = np.repeat(np.arange(n), self.in_degrees)
        np.add.at(row_sums, dst, self.weights)
        if not np.allclose(row_sums, 1.0, atol=1e-6):
            raise ValueError("W must be row-stochastic")
        has_self = np.zeros(n, dtype=bool)
        has_self[dst[(dst == self.indices) & (self.weights > 0)]] = True
        if not has_self.all():
            raise ValueError("self-loops required: i in N(i) (W_ii > 0)")
        if require_connected and not self.strongly_connected():
            raise ValueError("W's support graph must be strongly connected")


def _graph_from_rows(rows: list[list[int]], row_weights=None) -> SparseGraph:
    """Assemble a SparseGraph from per-agent in-neighbor lists.

    Each row is sorted ascending (matching ``np.nonzero`` order on the dense
    bridge); ``row_weights`` defaults to degree-uniform 1/|N(i)|.
    """
    n = len(rows)
    indptr = np.zeros(n + 1, dtype=np.int64)
    idx_parts, w_parts = [], []
    for i, r in enumerate(rows):
        order = np.argsort(r, kind="stable")
        r_arr = np.asarray(r, dtype=np.int32)[order]
        if row_weights is None:
            w_arr = np.full(len(r), 1.0 / len(r), dtype=np.float64)
        else:
            w_arr = np.asarray(row_weights[i], dtype=np.float64)[order]
        indptr[i + 1] = indptr[i] + len(r)
        idx_parts.append(r_arr)
        w_parts.append(w_arr)
    return SparseGraph(
        indptr=indptr,
        indices=np.concatenate(idx_parts) if n else np.zeros(0, np.int32),
        weights=np.concatenate(w_parts) if n else np.zeros(0, np.float64),
    )


# ---------------------------------------------------------------------------
# Sparse builders: the named topologies without the [N, N] allocation
# ---------------------------------------------------------------------------


def ring_sparse(n: int, self_weight: float = 0.5) -> SparseGraph:
    """Directed ring with self-loops: i listens to i-1 and itself.  Edge
    arrays only — ``ring_sparse(n).to_dense()`` equals ``ring_w(n)``."""
    # weights are aligned with the unsorted source list [(i-1) % n, i];
    # _graph_from_rows re-sorts both together, so row 0 ([n-1, 0]) lands
    # as sources [0, n-1] with weights [self_weight, 1 - self_weight].
    rows = [[(i - 1) % n, i] for i in range(n)]
    w = [[1.0 - self_weight, self_weight] for _ in range(n)]
    if n == 1:
        rows, w = [[0]], [[1.0]]
    g = _graph_from_rows(rows, w)
    g.validate()
    return g


def bidirectional_ring_sparse(n: int, self_weight: float = 1.0 / 3.0) -> SparseGraph:
    side = (1.0 - self_weight) / 2.0
    rows, w = [], []
    for i in range(n):
        trio = {(i - 1) % n: side, i: self_weight}
        trio[(i + 1) % n] = trio.get((i + 1) % n, 0.0) + side
        srcs = sorted(trio)
        rows.append(srcs)
        w.append([trio[j] for j in srcs])
    g = _graph_from_rows(rows, w)
    g.validate()
    return g


def _lattice_rows(rows: int, cols: int, wrap: bool) -> list[list[int]]:
    out = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            nbrs = [i]
            if wrap:
                nbrs += [
                    ((r - 1) % rows) * cols + c,
                    ((r + 1) % rows) * cols + c,
                    r * cols + (c - 1) % cols,
                    r * cols + (c + 1) % cols,
                ]
            else:
                if r > 0:
                    nbrs.append((r - 1) * cols + c)
                if r < rows - 1:
                    nbrs.append((r + 1) * cols + c)
                if c > 0:
                    nbrs.append(r * cols + c - 1)
                if c < cols - 1:
                    nbrs.append(r * cols + c + 1)
            out.append(sorted(dict.fromkeys(nbrs)))
    return out


def grid_sparse(rows: int, cols: int) -> SparseGraph:
    """Paper Sec 4.2.2 grid, degree-uniform, CSR-native."""
    g = _graph_from_rows(_lattice_rows(rows, cols, wrap=False))
    g.validate()
    return g


def torus_sparse(rows: int, cols: int) -> SparseGraph:
    """2-D torus, degree-uniform (the natural TPU-ICI-shaped topology)."""
    g = _graph_from_rows(_lattice_rows(rows, cols, wrap=True))
    g.validate()
    return g


def star_sparse(n_edge: int, a: float) -> SparseGraph:
    """Paper Sec 4.2.1 star in CSR form (center row uniform, edge rows
    (a, 1-a))."""
    n = n_edge + 1
    rows = [list(range(n))] + [[0, i] for i in range(1, n)]
    w = [[1.0 / n] * n] + [[a, 1.0 - a] for _ in range(1, n)]
    g = _graph_from_rows(rows, w)
    g.validate()
    return g


# ---------------------------------------------------------------------------
# Small-world generators (sparse-only: these are the N = 10^4+ topologies)
# ---------------------------------------------------------------------------


def _graph_from_neighbor_sets(nbrs: list[set[int]]) -> SparseGraph:
    """Symmetric support + self-loops, degree-uniform weights."""
    rows = [sorted(s | {i}) for i, s in enumerate(nbrs)]
    return _graph_from_rows(rows)


def watts_strogatz_sparse(
    n: int, k: int = 6, beta: float = 0.1, seed: int = 0, attempts: int = 100
) -> SparseGraph:
    """Watts-Strogatz small-world graph, degree-uniform row-stochastic.

    Ring lattice with k/2 neighbors each side, each lattice edge rewired
    with probability ``beta`` (no self-edges, no duplicates); the support is
    kept symmetric, so strong connectivity = undirected connectivity.
    Rewiring can disconnect the graph, so samples are drawn from the
    ``(seed, attempt)`` stream until the iterative CSR check passes.  Never
    allocates ``[N, N]``.
    """
    if k <= 0 or k % 2:
        raise ValueError(f"watts_strogatz_sparse: k must be positive and even, got {k}")
    if k >= n:
        raise ValueError(f"watts_strogatz_sparse: need k < n, got k={k}, n={n}")
    if not 0.0 <= beta <= 1.0:
        raise ValueError(f"watts_strogatz_sparse: beta must be in [0, 1], got {beta}")
    for attempt in range(attempts):
        rng = np.random.default_rng([seed, attempt])
        nbrs: list[set[int]] = [set() for _ in range(n)]
        for off in range(1, k // 2 + 1):
            for i in range(n):
                j = (i + off) % n
                nbrs[i].add(j)
                nbrs[j].add(i)
        for off in range(1, k // 2 + 1):
            for i in range(n):
                j = (i + off) % n
                if rng.random() < beta and j in nbrs[i] and len(nbrs[i]) < n - 1:
                    while True:
                        t = int(rng.integers(n))
                        if t != i and t not in nbrs[i]:
                            break
                    nbrs[i].discard(j)
                    nbrs[j].discard(i)
                    nbrs[i].add(t)
                    nbrs[t].add(i)
        g = _graph_from_neighbor_sets(nbrs)
        if g.strongly_connected():
            g.validate()
            return g
    raise RuntimeError(
        f"watts_strogatz_sparse: no connected sample after {attempts} attempts "
        f"(n={n}, k={k}, beta={beta}, seed={seed}); raise k or lower beta"
    )


def _random_subset(repeated: list[int], m: int, rng) -> list[int]:
    chosen: set[int] = set()
    while len(chosen) < m:
        chosen.add(repeated[int(rng.integers(len(repeated)))])
    return sorted(chosen)


def barabasi_albert_sparse(n: int, m: int = 3, seed: int = 0) -> SparseGraph:
    """Barabasi-Albert preferential attachment, degree-uniform row-stochastic.

    Standard repeated-nodes construction: node ``m`` attaches to the m seed
    nodes, every later node to m distinct targets drawn proportionally to
    degree.  The undirected support is connected by construction, so no
    resampling loop is needed; symmetrized + self-loops it satisfies
    Assumption 1 directly.  O(E) memory throughout.
    """
    if m < 1 or m >= n:
        raise ValueError(f"barabasi_albert_sparse: need 1 <= m < n, got m={m}, n={n}")
    rng = np.random.default_rng(seed)
    nbrs: list[set[int]] = [set() for _ in range(n)]
    targets = list(range(m))
    repeated: list[int] = []
    for source in range(m, n):
        for t in targets:
            nbrs[source].add(t)
            nbrs[t].add(source)
        repeated.extend(targets)
        repeated.extend([source] * m)
        targets = _random_subset(repeated, m, rng)
    g = _graph_from_neighbor_sets(nbrs)
    g.validate()
    return g


#: Registry for ``TopologySpec(kind="sparse")``: generator name -> builder.
#: Every builder returns a validated ``SparseGraph`` and never goes O(N^2).
SPARSE_GENERATORS = {
    "ring": ring_sparse,
    "bidirectional_ring": bidirectional_ring_sparse,
    "grid": grid_sparse,
    "torus": torus_sparse,
    "star": star_sparse,
    "watts_strogatz": watts_strogatz_sparse,
    "barabasi_albert": barabasi_albert_sparse,
}


def build_sparse(generator: str, **params) -> SparseGraph:
    """Build a named sparse topology (the ``TopologySpec(kind="sparse")``
    entry point)."""
    if generator not in SPARSE_GENERATORS:
        raise ValueError(
            f"unknown sparse generator {generator!r}; "
            f"choose from {sorted(SPARSE_GENERATORS)}"
        )
    return SPARSE_GENERATORS[generator](**params)


def watts_strogatz_w(n: int, k: int = 6, beta: float = 0.1, seed: int = 0) -> np.ndarray:
    """Dense bridge for the Watts-Strogatz generator (named-topology /
    gossip-base interop; use ``watts_strogatz_sparse`` at scale)."""
    return watts_strogatz_sparse(n, k=k, beta=beta, seed=seed).to_dense()


def barabasi_albert_w(n: int, m: int = 3, seed: int = 0) -> np.ndarray:
    """Dense bridge for the Barabasi-Albert generator."""
    return barabasi_albert_sparse(n, m=m, seed=seed).to_dense()


# ---------------------------------------------------------------------------
# Dense builders + validators (interop surface; small N)
# ---------------------------------------------------------------------------


def check_w(W: np.ndarray, *, require_connected: bool = True) -> None:
    """Validate the paper's Assumption 1 prerequisites."""
    W = np.asarray(W)
    n = W.shape[0]
    if W.shape != (n, n):
        raise ValueError(f"W must be square, got {W.shape}")
    if np.any(W < 0):
        raise ValueError("W must be nonnegative")
    if not np.allclose(W.sum(axis=1), 1.0, atol=1e-6):
        raise ValueError("W must be row-stochastic")
    if np.any(np.diag(W) <= 0):
        raise ValueError("self-loops required: i in N(i) (W_ii > 0)")
    if require_connected:
        g = SparseGraph.from_dense(W)
        if not g.strongly_connected():
            raise ValueError("W's support graph must be strongly connected")


def star_w(n_edge: int, a: float) -> np.ndarray:
    """Paper Sec 4.2.1: star with agent 0 at the center and ``n_edge`` edge
    agents.  Center row uniform 1/(n_edge+1); edge agent i puts ``a`` on the
    center and 1-a on itself."""
    n = n_edge + 1
    W = np.zeros((n, n))
    W[0, :] = 1.0 / n
    for i in range(1, n):
        W[i, 0] = a
        W[i, i] = 1.0 - a
    check_w(W)
    return W


def grid_w(rows: int, cols: int) -> np.ndarray:
    """Paper Sec 4.2.2: grid with degree-uniform weights W_ij = 1/|N(i)|
    (self-loop included in N(i))."""
    n = rows * cols
    W = np.zeros((n, n))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            nbrs = [i]
            if r > 0:
                nbrs.append((r - 1) * cols + c)
            if r < rows - 1:
                nbrs.append((r + 1) * cols + c)
            if c > 0:
                nbrs.append(r * cols + c - 1)
            if c < cols - 1:
                nbrs.append(r * cols + c + 1)
            for j in nbrs:
                W[i, j] = 1.0 / len(nbrs)
    check_w(W)
    return W


def ring_w(n: int, self_weight: float = 0.5) -> np.ndarray:
    """Directed ring with self-loops: i listens to i-1 and itself."""
    W = np.zeros((n, n))
    for i in range(n):
        W[i, i] = self_weight
        W[i, (i - 1) % n] = 1.0 - self_weight
    check_w(W)
    return W


def bidirectional_ring_w(n: int, self_weight: float = 1.0 / 3.0) -> np.ndarray:
    W = np.zeros((n, n))
    side = (1.0 - self_weight) / 2.0
    for i in range(n):
        W[i, i] = self_weight
        W[i, (i - 1) % n] = side
        W[i, (i + 1) % n] = side
    check_w(W)
    return W


def torus_w(rows: int, cols: int) -> np.ndarray:
    """2-D torus, degree-uniform (the natural TPU-ICI-shaped topology)."""
    n = rows * cols
    W = np.zeros((n, n))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            nbrs = [
                i,
                ((r - 1) % rows) * cols + c,
                ((r + 1) % rows) * cols + c,
                r * cols + (c - 1) % cols,
                r * cols + (c + 1) % cols,
            ]
            nbrs = list(dict.fromkeys(nbrs))
            for j in nbrs:
                W[i, j] = 1.0 / len(nbrs)
    check_w(W)
    return W


def complete_w(n: int) -> np.ndarray:
    """Fully connected, uniform weights (centralized-equivalent baseline)."""
    W = np.full((n, n), 1.0 / n)
    check_w(W)
    return W


def erdos_w(n: int, p: float, seed: int = 0, attempts: int = 1000) -> np.ndarray:
    """Erdos-Renyi digraph (resampled until strongly connected), degree-uniform
    weights with self-loops.

    Each attempt is screened by the iterative CSR connectivity check (no
    per-attempt networkx graph); on exhaustion the error reports the actual
    ``(n, p, attempts)`` and the connectivity threshold ``p >~ log(n)/n``
    below which strongly connected samples are exponentially rare.
    """
    rng = np.random.default_rng(seed)
    for _ in range(attempts):
        adj = (rng.random((n, n)) < p).astype(float)
        np.fill_diagonal(adj, 1.0)
        if SparseGraph.from_dense(adj).strongly_connected():
            W = adj / adj.sum(axis=1, keepdims=True)
            check_w(W)
            return W
    threshold = np.log(n) / n if n > 1 else 0.0
    raise RuntimeError(
        f"erdos_w: could not sample a strongly connected graph with n={n}, "
        f"p={p} after {attempts} attempts; directed G(n, p) is a.s. "
        f"disconnected below the threshold p ~ log(n)/n = {threshold:.4g} — "
        f"raise p (or n)"
    )


def check_schedule_union(mats) -> None:
    """Time-varying relaxation of Assumption 1: each slot need not be
    connected, but the UNION of the schedule's support graphs must be
    strongly connected."""
    union = (sum((np.asarray(m) > 0).astype(float) for m in mats) > 0).astype(float)
    if not SparseGraph.from_dense(union).strongly_connected():
        raise ValueError("union of the W schedule must be strongly connected")


def time_varying_star_schedule(
    n_agents: int, n_active: int, a: float = 0.5
) -> list[np.ndarray]:
    """Paper Sec 1.4.3: N+1 agents {0..N}; at slot k only agents
    {N0(k-1)+1, ..., N0 k} are connected to the center 0 in a star.
    Inactive agents keep W_ii = 1 (train locally / idle).  The union over the
    schedule is strongly connected.  Returns the list of per-slot W's."""
    if n_agents % n_active != 0:
        raise ValueError("n_agents must be divisible by n_active")
    n = n_agents + 1
    mats = []
    for k in range(n_agents // n_active):
        W = np.eye(n)
        active = list(range(n_active * k + 1, n_active * (k + 1) + 1))
        W[0, 0] = 1.0 / (n_active + 1)
        for j in active:
            W[0, j] = 1.0 / (n_active + 1)
            W[j, 0] = a
            W[j, j] = 1.0 - a
        check_w(W, require_connected=False)
        mats.append(W)
    check_schedule_union(mats)
    return mats


def neighbor_lists(W: np.ndarray) -> list[list[int]]:
    """In-neighbors per agent (j such that W_ij > 0), including self.

    Routed through the one CSR construction (``SparseGraph.from_dense``) so
    this, ``max_in_degree`` and ``core.flat.neighbor_tables`` can never
    disagree on ordering or support."""
    g = SparseGraph.from_dense(W)
    return [[int(j) for j in g.row(i)[0]] for i in range(g.n_agents)]


def max_in_degree(W: np.ndarray) -> int:
    return SparseGraph.from_dense(W).max_in_degree
