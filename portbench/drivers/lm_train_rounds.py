"""Traffic driver: decentralized LM training rounds, back to back, as
``repro_torch.launch.train`` composes them: eq. (6) over the A agents
(``launch.steps.make_consensus_step``), then u Bayes-by-Backprop local
steps against that prior (``make_local_step``), each step's loss read on
the host.

The benchmark makes every input from ``--seed``: one agent's weights (all
agents start from them) and, for the set-up's ``check_rounds`` whole
rounds, each step's Zipf tokens ``[A, B, S + 1]`` (handed to the
program's batch sampler as ``toks``) and noise ``eps [A, P]``; the
reference follows the first round and the second round's eq. (6).  The
window's steps are ``launch.train``'s own: the sampler draws the tokens
and the local step its noise from one card generator seeded from
``--seed``.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import costs
from portbench.common import loss_gap, norm_gaps, still_leaves, sub_seed
from portbench.readings import dict_leaf_norms, flat_leaf_norms


SIZES = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size")


def zipf_probs(vocab: int, device) -> torch.Tensor:
    """Zipf(1.2) unigram probabilities over the vocabulary."""
    w = 1.0 / np.arange(1, vocab + 1) ** 1.2
    return torch.as_tensor(w / w.sum(), dtype=torch.float64, device=device)


class Driver:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.tr = ctx, ctx.config, ctx.traffic
        self.device, self.ref = ctx.device, ctx.reference
        self.a, self.u = self.tr["agents"], self.tr["local_updates"]
        self.b, self.s = self.tr["batch_size"], self.tr["seq_len"]
        self.p = self.ref.n_params(self.cfg)
        self.W = [[1.0 / self.a] * self.a for _ in range(self.a)]  # complete_w(A)
        self.probs = zipf_probs(self.cfg["vocab_size"], self.device)
        self.round_idx = 0
        self.readings: dict = {}
        self.events: dict = {"local_step_ms": [], "consensus_ms": []}

    def draws(self, r: int, t: int):
        """Step (r, t)'s tokens ``[A, B, S + 1]`` and noise ``[A, P]``."""
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.ctx.seed, "toks", r, t))
        n = self.a * self.b * (self.s + 1)
        toks = torch.multinomial(self.probs, n, replacement=True, generator=g)
        toks = toks.reshape(self.a, self.b, self.s + 1).to(torch.int32)
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.ctx.seed, "eps", r, t))
        return toks, torch.randn((self.a, self.p), generator=g, device=self.device)

    def params(self) -> dict:
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.ctx.seed, "weights"))
        return self.ref.make_params(self.cfg, g, self.device)

    def lr(self, step: int) -> float:
        return self.cfg["lr"] * (self.cfg["lr_decay"] ** (1.0 / self.u)) ** step

    # -- the program ---------------------------------------------------------

    def program_config(self):
        """The program's own config of this name, at the sizes the
        configuration file states."""
        import dataclasses

        from repro_torch.configs import get_config

        return dataclasses.replace(get_config(self.cfg["name"]),
                                   **{k: self.cfg[k] for k in SIZES})

    def setup(self):
        from repro_torch.core.flat import flat_posterior_from_pytree
        from repro_torch.core.posterior import init_posterior
        from repro_torch.core.tree import tree_map
        from repro_torch.data.pipeline import make_lm_batch_sampler
        from repro_torch.launch.steps import BayesTrainState, make_consensus_step, make_local_step
        from repro_torch.optim import adam
        from repro_torch.optim.schedules import exponential_decay

        t0 = time.perf_counter()
        cfg = self.program_config()
        self.init = self.params()
        stacked = tree_map(lambda x: x.expand((self.a,) + tuple(x.shape)),
                           self.ref.nest(self.init))
        post = flat_posterior_from_pytree(
            init_posterior(stacked, init_sigma=self.cfg["init_sigma"]), leading_axes=1)
        opt = adam()
        self.state = BayesTrainState(posterior=post, opt_state=opt.init(post),
                                     step=torch.zeros((), dtype=torch.int32, device=self.device))
        sched = exponential_decay(self.cfg["lr"], self.cfg["lr_decay"] ** (1.0 / self.u))
        W = torch.as_tensor(self.W, dtype=torch.float32, device=self.device)
        self.consensus = make_consensus_step(cfg, W)
        self.local_step = make_local_step(cfg, opt, sched, kl_scale=self.cfg["kl_scale"],
                                          remat=False)
        self.sampler = make_lm_batch_sampler(cfg.vocab_size, self.b, self.s, n_agents=self.a,
                                             device=self.device)
        self.specs = post.layout.specs
        self.gen = torch.Generator(device=self.device).manual_seed(
            sub_seed(self.ctx.seed, "program"))
        self.times = {"build_s": time.perf_counter() - t0}
        for _ in range(self.tr["check_rounds"]):
            self.round(check=True)
        self.times["check_rounds_s"] = time.perf_counter() - t0 - self.times["build_s"]
        self.events = {"local_step_ms": [], "consensus_ms": []}

    def _timer(self):
        if self.ctx.trace and self.device.type == "cuda":
            return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        return None

    def round(self, check: bool = False) -> dict:
        r = self.round_idx
        ev = self._timer()
        if ev:
            ev[0].record()
        prior = self.consensus(self.state.posterior)
        if ev:
            ev[1].record()
            self.events["consensus_ms"].append(ev)
        if check and r == 1:
            self.readings["merged_norms"] = self._norms(prior, minus_init=True)
        state = type(self.state)(posterior=prior, opt_state=self.state.opt_state,
                                 step=self.state.step)
        losses = []
        for t in range(self.u):
            if check:
                toks, eps = self.draws(r, t)
                batch = self.sampler(None, r * self.u + t, toks=toks)
            else:
                batch, eps = self.sampler(self.gen, r * self.u + t), None
            ev = self._timer()
            if ev:
                ev[0].record()
            state, loss = self.local_step(state, prior, batch, eps=eps, generator=self.gen)
            if ev:
                ev[1].record()
                self.events["local_step_ms"].append(ev)
            del eps
            losses.append(float(loss))
            if check and r == 0 and t == 0:
                self.readings["moment_norms"] = self._norms(state.opt_state.mu)
        self.state = state
        if check and r == 0:
            self.readings["losses"] = np.asarray(losses)
            self.readings["change_norms"] = self._norms(state.posterior, minus_init=True)
        self.round_idx += 1
        out = {"round": r, "work": self.a * self.u * self.b * self.s,
               "failed": not all(math.isfinite(x) for x in losses)}
        if self.ctx.trace:
            out.update(flops=costs.lm_train_flops(self.cfg, self.a * self.u * self.b, self.s),
                       bytes=costs.posterior_adam_bytes(self.a, self.p))
        return out

    def _norms(self, post, minus_init: bool = False) -> dict:
        if not minus_init:
            return {**flat_leaf_norms(post.mean, self.specs, "mean"),
                    **flat_leaf_norms(post.rho, self.specs, "rho")}
        sig = self.cfg["init_sigma"]
        rho0 = sig + math.log(-math.expm1(-sig))  # as the posterior is initialised
        init_rho = {k: torch.full((v.numel(),), rho0, device=self.device)
                    for k, v in self.init.items()}
        return {**flat_leaf_norms(post.mean, self.specs, "mean", minus=self.init),
                **flat_leaf_norms(post.rho, self.specs, "rho", minus=init_rho)}

    def trace_stats(self, rounds) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {key: [s.elapsed_time(e) for s, e in evs] for key, evs in self.events.items()} | {
            "agents": self.a, "params": self.p}

    def release(self):
        self.state = self.consensus = self.local_step = None

    # -- the reference -------------------------------------------------------

    def reference_readings(self, control: bool = False, faults=()) -> dict:
        """The reference's own first round and second eq. (6) from the seed,
        read as the program's are.  ``control``: its products at float8,
        the precision below the configuration's bfloat16; ``faults``:
        planted faults (``unchanged``, ``half_batch``, ``no_exchange``)."""
        ref, cfg = self.ref, self.cfg
        init = self.params()
        ag = ref.Agents(cfg, init, self.a)
        out: dict = {}
        losses = []
        ref.consensus(ag, self.W)
        prior = [({k: v.clone() for k, v in ag.mean[i].items()},
                  {k: v.clone() for k, v in ag.rho[i].items()}) for i in range(self.a)]
        for t in range(self.u):
            toks, eps = self.draws(0, t)
            losses.append(ref.local_step(ag, prior, toks, eps, self.lr(t), fp8=control,
                                         faults=faults))
            del eps
            if t == 0:
                out["moment_norms"] = self._ref_norms([{k: m[("mean", k)] for k in init}
                                                       for m in ag.m],
                                                      [{k: m[("rho", k)] for k in init}
                                                       for m in ag.m])
        out["losses"] = np.asarray(losses)
        out["change_norms"] = self._ref_norms(ag.mean, ag.rho, init)
        if "no_exchange" not in faults:
            ref.consensus(ag, self.W)
        out["merged_norms"] = self._ref_norms(ag.mean, ag.rho, init)
        return out

    def _ref_norms(self, means: list, rhos: list, init: dict | None = None) -> dict:
        """Per-leaf norms over the agents of lists of per-agent flat dicts."""
        rho_init = None
        if init is not None:
            sig = self.cfg["init_sigma"]
            rho0 = sig + math.log(-math.expm1(-sig))
            rho_init = {k: torch.full_like(v, rho0).reshape(1, -1) for k, v in init.items()}
            init = {k: v.reshape(1, -1) for k, v in init.items()}
        stack = {k: torch.stack([m[k].reshape(-1) for m in means]) for k in means[0]}
        out = dict_leaf_norms(stack, "mean", init)
        stack = {k: torch.stack([r[k].reshape(-1) for r in rhos]) for k in rhos[0]}
        out.update(dict_leaf_norms(stack, "rho", rho_init))
        return out

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict:
        """The numbers compared: the relative gap of the first step's loss
        (``loss_gap_first``) and the worst of the first round's step losses
        (``loss_gap``); the worst leaf's gap in Adam's first moment after
        the first step, in the posterior's change over the first round
        (leaves whose reference moment is nought to rounding left out) and
        in the second round's eq. (6) prior."""
        skip = still_leaves(ref["moment_norms"])
        return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
                "loss_gap_first": loss_gap(prog["losses"][:1], ref["losses"][:1]),
                "moment_gap": norm_gaps(prog["moment_norms"], ref["moment_norms"]),
                "change_gap": norm_gaps(prog["change_norms"], ref["change_norms"], skip),
                "merge_gap": norm_gaps(prog["merged_norms"], ref["merged_norms"], skip)}

