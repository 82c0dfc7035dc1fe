"""DataSpec -> concrete data: dataset, per-agent shards, round sampler,
held-out test set (port of ``repro.api.data``).  One builder per dataset
family; every builder enforces the spec/topology agent-count agreement
eagerly."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api.spec import DataSpec
from repro_torch.data import linreg as linreg_mod
from repro_torch.data import partition as partition_mod
from repro_torch.data import synthetic
from repro_torch.data.pipeline import AgentDataset, make_round_batches

_DATASETS = {
    "synthetic_classification": synthetic.make_synthetic_classification,
    "mnist_like": synthetic.mnist_like,
    "fmnist_like": synthetic.fmnist_like,
}


@dataclasses.dataclass
class DataBundle:
    """Concrete data behind a Session: ``sampler(generator, round, idx=None)``
    -> batches with leading [N, u, B] axes (classification), or
    ``sampler(generator, round, seed=None)`` -> ``{"phi": [N, B, d], "y":
    [N, B]}`` (linreg), plus the test set for ``evaluate``."""

    kind: str  # "classification" | "linreg"
    n_agents: int
    sampler: Callable[..., Any]
    x_test: torch.Tensor | None = None
    y_test: np.ndarray | None = None
    dim: int = 0
    n_classes: int = 0
    dataset: Any = None  # the underlying SyntheticClassification / LinRegTask
    test_phi: np.ndarray | None = None  # linreg global test features
    test_y: np.ndarray | None = None


def _partition(spec: DataSpec, ds) -> list:
    params = dict(spec.partition_params)
    if spec.partition == "iid":
        return partition_mod.partition_iid(ds.x_train, ds.y_train, **params)
    if spec.partition == "by_label":
        return partition_mod.partition_by_label(ds.x_train, ds.y_train, **params)
    if spec.partition == "star":
        return partition_mod.star_partition(ds.x_train, ds.y_train, **params)
    if spec.partition == "grid":
        return partition_mod.grid_partition(ds.x_train, ds.y_train, **params)
    raise ValueError(f"unknown partition {spec.partition!r}")


def build_data(spec: DataSpec, n_agents: int, device=None) -> DataBundle:
    if spec.dataset == "linreg":
        return _build_linreg(spec, n_agents, device)
    ds = _DATASETS[spec.dataset](**dict(spec.dataset_params))
    shards = _partition(spec, ds)
    if len(shards) != n_agents:
        raise ValueError(
            f"partition {spec.partition!r} produced {len(shards)} agent "
            f"shards but the topology has {n_agents} agents"
        )
    data = AgentDataset.from_shards(
        [(x.astype(np.float32), y.astype(np.int32)) for x, y in shards], device=device
    )
    return DataBundle(
        kind="classification",
        n_agents=n_agents,
        sampler=make_round_batches(data, spec.batch_size, spec.local_updates),
        x_test=torch.as_tensor(ds.x_test, device=device),
        y_test=ds.y_test,
        dim=ds.dim,
        n_classes=ds.n_classes,
        dataset=ds,
    )


def _build_linreg(spec: DataSpec, n_agents: int, device=None) -> DataBundle:
    params = dict(spec.dataset_params)
    params.setdefault("n_agents", n_agents)
    task = linreg_mod.make_linreg_task(**params)
    if task.n_agents != n_agents:
        raise ValueError(
            f"linreg task has {task.n_agents} agents but the topology has {n_agents}"
        )
    b = spec.batch_size

    def sampler(generator: torch.Generator | None, round_idx: int, seed: int | None = None):
        """numpy task sampling from one per-round seed, drawn from
        ``generator`` in [0, 2**31 - 1) as the reference draws it from its
        round key; ``seed`` injects it."""
        del round_idx
        if seed is None:
            seed = int(torch.randint(0, np.iinfo(np.int32).max, (), generator=generator,
                                     device=generator.device))
        rng = np.random.default_rng(seed)
        phis, ys = [], []
        for i in range(n_agents):
            phi, y = task.sample_local(rng, i, b)
            phis.append(phi)
            ys.append(y)
        return {
            "phi": torch.as_tensor(np.stack(phis), dtype=torch.float32, device=device),
            "y": torch.as_tensor(np.stack(ys), dtype=torch.float32, device=device),
        }

    phi_t, y_t = task.sample_global(np.random.default_rng(10_000), 4000)
    return DataBundle(
        kind="linreg",
        n_agents=n_agents,
        sampler=sampler,
        dim=task.d,
        dataset=task,
        test_phi=phi_t,
        test_y=y_t,
    )
