"""DataSpec -> concrete data: dataset, per-agent shards, round sampler,
held-out test set (port of the classification builder of
``repro.api.data``).  Every builder enforces the spec/topology agent-count
agreement eagerly."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api.spec import DataSpec
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
    """Concrete data behind a Session: sampler(generator, round, idx=None) ->
    batches with leading [N, u, B] axes, plus the test set for ``evaluate``."""

    kind: str  # "classification"
    n_agents: int
    sampler: Callable[..., Any]
    x_test: torch.Tensor | None = None
    y_test: np.ndarray | None = None
    dim: int = 0
    n_classes: int = 0
    dataset: Any = None  # the underlying SyntheticClassification


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
        raise NotImplementedError("the linreg dataset arrives with the linreg slice")
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
