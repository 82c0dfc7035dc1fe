"""Non-IID data partitioners (paper Secs 4.2.1-4.2.2, supplementary 1.4).

The paper's partitions assign disjoint LABEL subsets to agents:
  MNIST-Setup1:  center {2..9},     each edge agent a shard of {0,1}
  MNIST-Setup2:  center {0..7},     edges shards of {8,9}
  MNIST-Setup3:  center others,     edges shards of {4,9}
  FMNIST-Setup1: center {t-shirt,pullover,dress,coat,shirt,bag},
                 edges shards of {trouser,sandal,sneaker,ankle-boot}
  FMNIST-Setup2: center {t-shirt,trouser,dress,coat,shirt,bag},
                 edges shards of {pullover,sandal,sneaker,ankle-boot}
"""
from __future__ import annotations

import numpy as np


def partition_iid(
    x: np.ndarray, y: np.ndarray, n_agents: int, seed: int = 0
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Shuffle and split evenly (paper Sec 1.4.3 time-varying experiment)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(y))
    shards = np.array_split(perm, n_agents)
    return [(x[s], y[s]) for s in shards]


def partition_by_label(
    x: np.ndarray,
    y: np.ndarray,
    label_sets: list[list[int]],
    seed: int = 0,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Assign each agent all samples whose label is in its label set.  If a
    label appears in k>1 sets, its samples are split into k shards."""
    rng = np.random.default_rng(seed)
    owners: dict[int, list[int]] = {}
    for a, ls in enumerate(label_sets):
        for l in ls:
            owners.setdefault(l, []).append(a)
    per_agent_idx: list[list[np.ndarray]] = [[] for _ in label_sets]
    for l, agents in owners.items():
        idx = np.nonzero(y == l)[0]
        idx = rng.permutation(idx)
        for a, shard in zip(agents, np.array_split(idx, len(agents))):
            per_agent_idx[a].append(shard)
    out = []
    for chunks in per_agent_idx:
        idx = np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
        idx = rng.permutation(idx)
        out.append((x[idx], y[idx]))
    return out


def star_partition(
    x: np.ndarray,
    y: np.ndarray,
    center_labels: list[int],
    edge_labels: list[int],
    n_edge: int,
    seed: int = 0,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Paper star partitions: agent 0 (center) owns ``center_labels``; the
    ``edge_labels`` samples are shuffled and split into n_edge equal shards."""
    rng = np.random.default_rng(seed)
    center_idx = np.nonzero(np.isin(y, center_labels))[0]
    edge_idx = rng.permutation(np.nonzero(np.isin(y, edge_labels))[0])
    shards = np.array_split(edge_idx, n_edge)
    out = [(x[center_idx], y[center_idx])]
    out += [(x[s], y[s]) for s in shards]
    return out


def grid_partition(
    x: np.ndarray,
    y: np.ndarray,
    type1_labels: list[int],
    type2_labels: list[int],
    type1_position: int,
    n_agents: int = 9,
    seed: int = 0,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Paper Sec 4.2.2 grid: the Type-1 (informative) agent at
    ``type1_position`` owns ``type1_labels``; the other 8 agents share equal
    shards of ``type2_labels``."""
    rng = np.random.default_rng(seed)
    t1_idx = np.nonzero(np.isin(y, type1_labels))[0]
    t2_idx = rng.permutation(np.nonzero(np.isin(y, type2_labels))[0])
    shards = np.array_split(t2_idx, n_agents - 1)
    out: list[tuple[np.ndarray, np.ndarray]] = []
    s = 0
    for a in range(n_agents):
        if a == type1_position:
            out.append((x[t1_idx], y[t1_idx]))
        else:
            out.append((x[shards[s]], y[shards[s]]))
            s += 1
    return out
