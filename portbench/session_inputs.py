"""The MLP cells' inputs as the benchmark works them out itself: frozen
numpy copies of the program's data, graph, clock and fault arithmetic, so
that a later change to the program cannot move what the reference is
handed.

Copied from the port (``src/repro_torch``), numpy only:

* ``synthetic_classification`` / ``partition_iid``: ``data/synthetic.py``
  (``make_synthetic_classification``, ``mnist_like``) and
  ``data/partition.py``;
* ``watts_strogatz_edges``, ``grid_w``: ``core/graphs.py``
  (``watts_strogatz_sparse`` over ``_graph_from_neighbor_sets``, ``grid_w``);
* ``SparsePoissonWindows``: ``gossip/clocks.py`` (``SparsePoissonClock``,
  ``thinned_poisson_indices``, ``SparseClock._build_window``);
* ``FaultDraws``: ``gossip/faults.py`` (``FaultModel.up`` / ``corrupted``,
  ``edge_keep_mask``).

Each is a pure function of its seeds, as the originals are.
"""
from __future__ import annotations

import dataclasses

import numpy as np

CRASH_SALT = 0xC7A54
CORRUPT_SALT = 0xBADBAD


# -- data -------------------------------------------------------------------


def synthetic_classification(n_classes: int, dim: int, n_train_per_class: int,
                             n_test_per_class: int = 100, noise: float = 0.55,
                             proto_scale: float = 1.0, confusable_pairs=((4, 9),),
                             confusable_gap: float = 0.35, seed: int = 0):
    """Class prototypes plus Gaussian noise (``mnist_like``: the {4, 9}
    confusable pair); returns ``(x_train [n, dim] f32, y_train [n] i32)``."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, proto_scale, (n_classes, dim))
    for a, b in confusable_pairs:
        direction = np.zeros(dim)
        direction[rng.integers(dim)] = 1.0
        protos[b] = protos[a] + confusable_gap * proto_scale * direction
    xs, ys = [], []
    for c in range(n_classes):
        xs.append(protos[c] + rng.normal(0.0, noise, (n_train_per_class, dim)))
        ys.append(np.full(n_train_per_class, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def partition_iid(n_rows: int, n_agents: int, seed: int) -> list[np.ndarray]:
    """Row indices of each agent's shard: a shuffle split evenly."""
    return np.array_split(np.random.default_rng(seed).permutation(n_rows), n_agents)


def shard_sizes(n_rows: int, n_agents: int) -> np.ndarray:
    """``np.array_split``'s shard sizes, without the shuffle."""
    base, extra = divmod(n_rows, n_agents)
    return np.array([base + (i < extra) for i in range(n_agents)], np.int64)


# -- graphs -----------------------------------------------------------------


def _csr_rows(rows: list[list[int]]):
    """(dst, src, w64) of per-agent sorted in-neighbour lists, degree-uniform
    weights, CSR row-major (self-loops included)."""
    dst, src, w = [], [], []
    for i, r in enumerate(rows):
        r = sorted(r)
        dst += [i] * len(r)
        src += r
        w += [1.0 / len(r)] * len(r)
    return np.asarray(dst, np.int64), np.asarray(src, np.int64), np.asarray(w, np.float64)


def _connected(nbrs: list[set[int]]) -> bool:
    seen, stack = {0}, [0]
    while stack:
        for j in nbrs[stack.pop()]:
            if j not in seen:
                seen.add(j)
                stack.append(j)
    return len(seen) == len(nbrs)


def watts_strogatz_edges(n: int, k: int, beta: float, seed: int, attempts: int = 100):
    """Watts-Strogatz small world (ring lattice of k/2 neighbours a side,
    each lattice edge rewired with probability beta), symmetric support
    plus self-loops, degree-uniform weights: ``(dst, src, w64)``."""
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
        if _connected(nbrs):
            return _csr_rows([list(s | {i}) for i, s in enumerate(nbrs)])
    raise RuntimeError(f"no connected Watts-Strogatz sample (n={n}, k={k}, beta={beta})")


def grid_w(rows: int, cols: int) -> np.ndarray:
    """The paper's grid (Sec 4.2.2): W_ij = 1/|N(i)|, self included."""
    n = rows * cols
    w = np.zeros((n, n))
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
            w[i, nbrs] = 1.0 / len(nbrs)
    return w


# -- faults and windows -----------------------------------------------------


class FaultDraws:
    """Agent churn (a two-state Markov chain, all up at window 0) and
    sender corruption, each window's draws a pure function of (seed, r)."""

    def __init__(self, n: int, crash_rate: float, recover_rate: float, corrupt_rate: float,
                 seed: int):
        self.n, self.seed = n, seed
        self.crash_rate, self.recover_rate = crash_rate, recover_rate
        self.corrupt_rate = corrupt_rate
        self._up = [np.ones(n, bool)]

    def up(self, r: int) -> np.ndarray:
        while len(self._up) <= r:
            t = len(self._up)
            u = np.random.default_rng([self.seed, CRASH_SALT, t]).random(self.n)
            prev = self._up[t - 1]
            self._up.append(np.where(prev, u >= self.crash_rate, u < self.recover_rate))
        return self._up[r].copy()

    def corrupted(self, r: int) -> np.ndarray:
        if self.corrupt_rate <= 0.0:
            return np.zeros(self.n, bool)
        draw = np.random.default_rng([self.seed, CORRUPT_SALT, r]).random(self.n)
        return (draw < self.corrupt_rate) & self.up(r)


@dataclasses.dataclass
class Window:
    """One edge-native window: the fired edges that survive the crash
    filter, each row's conserve-rule self-weight (float64) and the rows
    that merge."""

    dst: np.ndarray
    src: np.ndarray
    weights: np.ndarray  # float32, as the program's edge tables
    self_weight: np.ndarray
    active: np.ndarray


class SparsePoissonWindows:
    """Each non-self directed edge fires on its own Poisson clock of
    ``rate`` a window (superposition thinning: Poisson(E rate) picks of
    uniform edges, unique); edges touching a crashed agent are dropped; a
    row with a fired in-edge keeps the base weight on it and moves the
    weight of its idle in-edges onto self."""

    def __init__(self, dst, src, w64, rate: float, seed: int, faults: FaultDraws | None):
        ns = dst != src
        self.n = int(dst.max()) + 1
        self.ns_dst, self.ns_src = dst[ns], src[ns]
        self.ns_w64 = w64[ns]
        self.ns_w32 = w64[ns].astype(np.float32)
        self.w_diag = np.zeros(self.n)
        self.w_diag[dst[~ns]] = w64[~ns]
        self.offdiag = np.bincount(self.ns_dst, weights=self.ns_w64, minlength=self.n)
        self.deg = np.bincount(self.ns_dst, minlength=self.n)
        self.rate, self.seed, self.faults = rate, seed, faults

    def window(self, r: int) -> Window:
        rng = np.random.default_rng([self.seed, r])
        n_edges = len(self.ns_dst)
        k = int(rng.poisson(n_edges * self.rate))
        fired = (np.unique(rng.integers(0, n_edges, size=k)) if k
                 else np.zeros(0, np.int64))
        f_dst, f_src = self.ns_dst[fired], self.ns_src[fired]
        if self.faults is not None:
            up = self.faults.up(r)
            keep = up[f_dst] & up[f_src]
            fired, f_dst, f_src = fired[keep], f_dst[keep], f_src[keep]
        count = np.bincount(f_dst, minlength=self.n)
        fsum = np.bincount(f_dst, weights=self.ns_w64[fired], minlength=self.n)
        active = count > 0
        w_self = np.where(count == self.deg, self.w_diag, self.w_diag + (self.offdiag - fsum))
        w_self = np.where(active, w_self, 1.0)
        return Window(dst=f_dst, src=f_src, weights=self.ns_w32[fired], self_weight=w_self,
                      active=active)
