"""Batching pipeline (port of the classification half of
``repro.data.pipeline``).

The paper equalizes the number of local updates per communication round:
every agent contributes u minibatches of size B per round, drawn from its
own shard, stacked to [N, u, B, ...].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class AgentDataset:
    """Per-agent local shards, padded to a common backing size."""

    x: torch.Tensor  # [N, max_n, ...]
    y: torch.Tensor  # [N, max_n]
    n: torch.Tensor  # [N] true (unpadded) shard sizes

    @property
    def n_agents(self) -> int:
        return int(self.x.shape[0])

    @staticmethod
    def from_shards(shards: list[tuple[np.ndarray, np.ndarray]], device=None) -> "AgentDataset":
        max_n = max(len(y) for _, y in shards)
        xs, ys, ns = [], [], []
        for x, y in shards:
            # pad by repeating from the start (padded rows are never sampled:
            # sampling indices are taken below the true size n)
            reps = int(np.ceil(max_n / max(len(y), 1)))
            xs.append(np.concatenate([x] * reps)[:max_n])
            ys.append(np.concatenate([y] * reps)[:max_n])
            ns.append(len(y))
        return AgentDataset(
            x=torch.as_tensor(np.stack(xs), device=device),
            y=torch.as_tensor(np.stack(ys), device=device),
            n=torch.as_tensor(np.asarray(ns, np.int64), device=device),
        )


def make_round_batches(data: AgentDataset, batch_size: int, n_local_updates: int):
    """Returns ``sampler(generator, round, idx=None) -> dict(x=[N,u,B,...],
    y=[N,u,B])``.

    Each agent draws u*B sample indices uniformly from its true shard.  ``idx``
    (``[N, u*B]`` integers) injects the indices in place of the draw."""
    n_agents = data.n_agents
    u, b = n_local_updates, batch_size
    rows = torch.arange(n_agents, device=data.x.device).unsqueeze(1)

    def sampler(generator: torch.Generator | None, round_idx: int, idx=None):
        del round_idx
        if idx is None:
            # uniform below each agent's n: a 62-bit draw modulo n (bias < n/2^62)
            raw = torch.randint(0, 2 ** 62, (n_agents, u * b), generator=generator,
                                device=data.x.device)
            idx = raw % data.n.unsqueeze(1)
        idx = torch.as_tensor(idx, device=data.x.device).long()
        xs = data.x[rows, idx]
        ys = data.y[rows, idx]
        return {
            "x": xs.reshape((n_agents, u, b) + tuple(data.x.shape[2:])),
            "y": ys.reshape(n_agents, u, b),
        }

    return sampler
