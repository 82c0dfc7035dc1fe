"""Synthetic clustered image-classification dataset: the offline stand-in for
MNIST / Fashion-MNIST (the container has no network access).

Each class c has a prototype p_c in R^dim; a sample is p_c + noise.  The
geometry is controllable so the paper's data-partition phenomenology is
reproducible:

* ``confusable_pairs``: class pairs whose prototypes are placed at small
  distance (the paper's {4, 9} MNIST ambiguity, Sec 4.2.2) — agents that
  never see both classes cannot learn to separate them.
* ``groups``: clusters of classes sharing a common direction (the FMNIST
  "shirt-like" family: t-shirt / pullover / dress / coat / shirt).

Distances are chosen so a 2-layer MLP trained on all classes separates
everything, while the confusable pairs are only separable along one specific
low-variance direction (only visible when both classes are in-domain).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticClassification:
    x_train: np.ndarray  # [n_train, dim] float32
    y_train: np.ndarray  # [n_train] int32
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int
    dim: int
    prototypes: np.ndarray  # [n_classes, dim]


def make_synthetic_classification(
    n_classes: int = 10,
    dim: int = 64,
    n_train_per_class: int = 600,
    n_test_per_class: int = 100,
    noise: float = 0.55,
    proto_scale: float = 1.0,
    confusable_pairs: tuple[tuple[int, int], ...] = (),
    confusable_gap: float = 0.35,
    groups: tuple[tuple[int, ...], ...] = (),
    group_spread: float = 0.5,
    seed: int = 0,
) -> SyntheticClassification:
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, proto_scale, (n_classes, dim))
    # group members share a common center with a small per-class offset
    for g in groups:
        center = rng.normal(0.0, proto_scale, dim)
        for c in g:
            protos[c] = center + rng.normal(0.0, group_spread * proto_scale, dim)
    # confusable pairs: second member = first + small offset in ONE direction
    for a, b in confusable_pairs:
        direction = np.zeros(dim)
        direction[rng.integers(dim)] = 1.0
        protos[b] = protos[a] + confusable_gap * proto_scale * direction

    def sample(n_per_class: int, salt: int):
        xs, ys = [], []
        for c in range(n_classes):
            e = rng.normal(0.0, noise, (n_per_class, dim))
            xs.append(protos[c] + e)
            ys.append(np.full(n_per_class, c))
        x = np.concatenate(xs).astype(np.float32)
        y = np.concatenate(ys).astype(np.int32)
        perm = rng.permutation(len(y))
        return x[perm], y[perm]

    x_train, y_train = sample(n_train_per_class, 0)
    x_test, y_test = sample(n_test_per_class, 1)
    return SyntheticClassification(
        x_train=x_train,
        y_train=y_train,
        x_test=x_test,
        y_test=y_test,
        n_classes=n_classes,
        dim=dim,
        prototypes=protos,
    )


def mnist_like(seed: int = 0, **kw) -> SyntheticClassification:
    """MNIST stand-in with the {4, 9} confusable pair from the paper."""
    kw.setdefault("confusable_pairs", ((4, 9),))
    return make_synthetic_classification(seed=seed, **kw)


def fmnist_like(seed: int = 0, **kw) -> SyntheticClassification:
    """FMNIST stand-in.  Label order matches the paper:
    0 t-shirt, 1 trouser, 2 pullover, 3 dress, 4 coat, 5 sandal, 6 shirt,
    7 sneaker, 8 bag, 9 ankle-boot.  Shirt-like family grouped: {0,2,3,4,6};
    shoe-like family grouped: {5,7,9}."""
    kw.setdefault("groups", ((0, 2, 3, 4, 6), (5, 7, 9)))
    return make_synthetic_classification(seed=seed, **kw)


FMNIST_LABELS = [
    "t-shirt",
    "trouser",
    "pullover",
    "dress",
    "coat",
    "sandal",
    "shirt",
    "sneaker",
    "bag",
    "ankle-boot",
]
