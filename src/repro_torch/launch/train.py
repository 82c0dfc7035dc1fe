"""Production training entry point (port of ``repro.launch.train``):
decentralized Bayesian training of a model-zoo language model, A agents
held as a leading axis on one card.

Runs the paper's round structure: the eq. (6) consensus over the agents,
then u local Bayes-by-Backprop steps against that round's prior
(``make_consensus_step`` + ``make_local_step``).  With u <= 1, or the
deterministic (non-Bayesian decentralized-FedAvg) baseline
``--no-bayesian``, a round is one ``make_train_round_step``.  The
learning rate decays by ``--lr-decay`` a round.  Every draw (the initial
weights, the Zipf tokens, the Bayes-by-Backprop noise) comes from one
``torch.Generator`` seeded by ``--seed``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m \
        --batch 8 --seq 256 --rounds 10 --local-steps 4 --agents 2
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
        --rounds 3 --seq 32
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.graphs import complete_w
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.steps import (
    init_train_state,
    make_consensus_step,
    make_local_step,
    make_train_round_step,
)
from repro_torch.optim import adam
from repro_torch.optim.schedules import exponential_decay


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--reduced", action="store_true", help="use the smoke config")
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8, help="per-agent batch")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=4, help="u per round")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr-decay", type=float, default=0.99, help="per round (paper)")
    ap.add_argument("--kl-scale", type=float, default=1e-4)
    ap.add_argument("--no-bayesian", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def main(argv=None) -> list[float]:
    """Train; print a line a round; return each round's mean loss."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch_sampler

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    a = args.agents
    opt = adam()
    # paper: lr decays per communication round
    sched = exponential_decay(args.lr, args.lr_decay ** (1.0 / max(args.local_steps, 1)))
    W = torch.as_tensor(complete_w(a), dtype=torch.float32, device=dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_train_state(cfg, a, opt, gen, device=dev)
    print(f"arch={cfg.name} agents={a} posterior params={state.posterior.mean.numel():,}")

    sampler = make_lm_batch_sampler(cfg.vocab_size, args.batch, args.seq, n_agents=a,
                                    device=dev)
    local_step = make_local_step(cfg, opt, sched, kl_scale=args.kl_scale, remat=False)
    consensus = make_consensus_step(cfg, W)
    round_step = make_train_round_step(cfg, W, opt=opt, lr_schedule=sched,
                                       kl_scale=args.kl_scale, remat=False,
                                       bayesian=not args.no_bayesian)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    losses = []
    t0 = time.time()
    for r in range(args.rounds):
        if args.local_steps <= 1 or args.no_bayesian:
            state, metrics = round_step(state, sampler(gen, r), generator=gen)
            loss = float(metrics["loss"])
        else:
            prior = consensus(state.posterior)
            state = type(state)(posterior=prior, opt_state=state.opt_state, step=state.step)
            step_losses = []
            for u in range(args.local_steps):
                batch = sampler(gen, r * args.local_steps + u)
                state, loss_u = local_step(state, prior, batch, generator=gen)
                step_losses.append(float(loss_u))
            loss = sum(step_losses) / len(step_losses)
        losses.append(loss)
        dt = time.time() - t0
        print(f"round {r + 1:4d}/{args.rounds}  loss {loss:8.4f}  ({dt:6.1f}s)", flush=True)
        if ckpt and (r + 1) % 10 == 0:
            ckpt.save(r + 1, state)
    if ckpt:
        ckpt.save(args.rounds, state)
        print(f"checkpoint saved to {args.ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
