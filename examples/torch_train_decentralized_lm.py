"""End-to-end run on the PyTorch port: decentralized Bayesian training
of a ~100M-parameter decoder-only LM (repro-100m: 12L x 768d) across 2
agents on the CUDA card, through the same step function as
``repro_torch.launch.train`` (``make_train_round_step``: eq. (6), then one
Bayes-by-Backprop step from the consensus prior).

The default invocation trains a width/depth-reduced variant for speed;
``--full --rounds 300`` is the full 100M run (the step function is
identical: only the config changes).  This is examples/train_decentralized_lm.py
on the port, ``--device cpu`` to run it on the CPU.

    PYTHONPATH=src python examples/torch_train_decentralized_lm.py --rounds 30
    PYTHONPATH=src python examples/torch_train_decentralized_lm.py --full --rounds 300
    PYTHONPATH=src python examples/torch_train_decentralized_lm.py --device cpu --rounds 5
"""
import argparse
import dataclasses
import math
import time

import torch

from repro_torch.configs.paper_models import REPRO_100M
from repro_torch.core.graphs import bidirectional_ring_w, complete_w
from repro_torch.data.pipeline import make_lm_batch_sampler
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.steps import init_train_state, make_train_round_step
from repro_torch.optim import adam
from repro_torch.optim.schedules import warmup_cosine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4, help="per-agent")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="the full 100M config")
    ap.add_argument("--topology", choices=["complete", "ring"], default="complete")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = REPRO_100M if args.full else dataclasses.replace(
        REPRO_100M, n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=1024, vocab_size=4096, name="repro-100m-cpu",
    )
    a = args.agents
    W = torch.as_tensor(complete_w(a) if args.topology == "complete" else bidirectional_ring_w(a),
                        dtype=torch.float32, device=dev)
    opt = adam()
    sched = warmup_cosine(3e-4, 20, args.rounds * 2)
    step = make_train_round_step(cfg, W, opt=opt, lr_schedule=sched, kl_scale=1e-5,
                                 remat=not args.full)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(cfg, a, opt, gen, device=dev)
    n = state.posterior.mean.shape[1]
    print(f"model {cfg.name}: {n:,} params/agent, {a} agents, W={args.topology}")

    sampler = make_lm_batch_sampler(cfg.vocab_size, args.batch, args.seq, n_agents=a,
                                    device=dev)
    t0 = time.time()
    for r in range(args.rounds):
        state, m = step(state, sampler(gen, r), generator=gen)
        if (r + 1) % 5 == 0 or r == 0:
            nll = float(m["nll"].mean())
            kl = float(m["kl"].mean())
            print(f"round {r + 1:4d}  nll/token {nll:7.4f}  KL {kl:10.1f}  "
                  f"({time.time() - t0:5.1f}s)", flush=True)
    nll_final = float(m["nll"].mean())
    print(f"\nuniform-prediction nll = {math.log(cfg.vocab_size):.3f}; the token "
          f"stream is Zipfian (entropy below that); reached {nll_final:.3f} "
          "with fully decentralized Bayesian training.")
    return nll_final


if __name__ == "__main__":
    main()
