"""Batching pipeline (port of ``repro.data.pipeline``).

The paper equalizes the number of local updates per communication round:
every agent contributes u minibatches of size B per round, drawn from its
own shard, stacked to [N, u, B, ...].

For the model zoo, ``make_lm_batch_sampler`` yields synthetic token batches
(nothing is downloaded; real corpora plug in behind the same interface).
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


def lm_logits(vocab_size: int, distribution: str = "zipf") -> np.ndarray:
    """The synthetic LM's unigram logits ``[V]`` float32, bit for bit the
    reference's: Zipf(1.2) (learnable structure, entropy below log V) or
    uniform."""
    if distribution == "zipf":
        w = 1.0 / (np.arange(1, vocab_size + 1) ** 1.2)
        return np.log(w / w.sum()).astype(np.float32)
    if distribution == "uniform":
        return np.zeros((vocab_size,), np.float32)
    raise ValueError(distribution)


def make_lm_batch_sampler(vocab_size: int, batch_size: int, seq_len: int, n_agents: int = 0,
                          distribution: str = "zipf", device=None):
    """Synthetic LM token pipeline: ``sampler(generator, round, toks=None)
    -> dict`` with ``tokens [(N,) B, S]`` and ``targets`` (the next-token
    shift), int32, on ``device`` (the card unless ``device="cpu"``).  The
    ``S + 1`` tokens of a row are drawn i.i.d. from ``lm_logits`` with
    ``generator``; ``toks [(N,) B, S + 1]`` injects them instead."""
    from repro_torch.kernels.dispatch import resolve_device

    dev = resolve_device(device)
    shape = ((n_agents, batch_size, seq_len + 1) if n_agents
             else (batch_size, seq_len + 1))
    probs = torch.softmax(torch.from_numpy(lm_logits(vocab_size, distribution)).double(), 0)
    probs = probs.to(dev)

    def sampler(generator: torch.Generator | None, round_idx: int, toks=None):
        del round_idx
        if toks is None:
            n = int(np.prod(shape))
            toks = torch.multinomial(probs, n, replacement=True, generator=generator)
        toks = torch.as_tensor(toks, device=dev).to(torch.int32).reshape(shape)
        return {"tokens": toks[..., :-1], "targets": toks[..., 1:]}

    return sampler
