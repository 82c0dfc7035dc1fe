"""Traffic driver: whole rounds of a ``repro_torch.api`` session, back to
back (a closed loop, as a training job runs them).

The traffic file says which execution a round is: the synchronous round
over a named graph (``{"kind": "grid", ...}``: ``SimulatedEngine``) or an
edge-native gossip window (``{"kind": "sparse", ...}`` with a clock and
faults: ``GossipEngine``).  The benchmark makes every input from
``--seed``: one agent's weights (all agents start from them) and the
dataset, graph, clock, fault and run seeds of the spec.  The first
``check_rounds`` rounds are the set-up's warm-up and the rounds the
reference follows: they take their batch indices and Bayes-by-Backprop
noise from the benchmark (``Session.round(batch_idx=, eps=)``), so that
the reference can draw the same.  The window's rounds are the program's
own ``Session.round()``: it draws its batches and noise itself.
"""
from __future__ import annotations

import math
import time
import numpy as np
import torch

from portbench import costs, session_inputs
from portbench.common import loss_gap, norm_gaps, still_leaves, sub_seed
from portbench.readings import dict_leaf_norms, flat_leaf_norms


class Driver:
    """One cell's session, its rounds, and the reference that judges it."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.config, ctx.traffic
        self.device = ctx.device
        self.ref = ctx.reference
        topo = self.tr["topology"]
        self.gossip = topo["kind"] == "sparse"
        self.n = topo["n"] if self.gossip else topo["rows"] * topo["cols"]
        self.u, self.b = self.tr["local_updates"], self.tr["batch_size"]
        self.p = self.ref.n_params(self.cfg)
        seed = ctx.seed
        self.seeds = {w: sub_seed(seed, w) % (1 << 31)
                      for w in ("data", "partition", "clock", "faults", "run")}
        self.npc = max(self.tr["data"]["min_train_per_class"],
                       -(-self.tr["data"]["min_rows_per_agent"] * self.n // self.cfg["n_classes"]))
        self.sizes = session_inputs.shard_sizes(self.npc * self.cfg["n_classes"], self.n)
        self.round_idx = 0
        self.readings: dict = {}

    # -- inputs --------------------------------------------------------------

    def spec(self):
        from repro_torch.api import (DataSpec, ExperimentSpec, InferenceSpec, ObsSpec, RunSpec,
                                     TopologySpec)

        topo, cfg = self.tr["topology"], self.cfg
        if self.gossip:
            clock = dict(self.tr["clock"], seed=self.seeds["clock"])
            if self.tr.get("faults"):
                clock["faults"] = dict(self.tr["faults"], seed=self.seeds["faults"])
            topology = TopologySpec.sparse(topo["generator"], n=topo["n"], k=topo["k"],
                                           beta=topo["beta"], seed=topo["graph_seed"],
                                           clock=clock)
        else:
            topology = TopologySpec.grid(topo["rows"], topo["cols"])
        data = DataSpec(dataset=self.tr["data"]["dataset"],
                        dataset_params=dict(dim=cfg["dim"], n_classes=cfg["n_classes"],
                                            n_train_per_class=self.npc, seed=self.seeds["data"]),
                        partition="iid",
                        partition_params=dict(n_agents=self.n, seed=self.seeds["partition"]),
                        batch_size=self.b, local_updates=self.u)
        inference = InferenceSpec(hidden=cfg["hidden"], depth=cfg["depth"],
                                  init_sigma=cfg["init_sigma"], lr=cfg["lr"],
                                  lr_decay=cfg["lr_decay"], kl_scale=cfg["kl_scale"],
                                  n_mc_samples=cfg["n_mc_samples"],
                                  fault_policy=self.tr.get("fault_policy", "strict"))
        return ExperimentSpec(topology=topology, data=data, inference=inference,
                              run=RunSpec(n_rounds=1, seed=self.seeds["run"]),
                              obs=ObsSpec(enabled=self.ctx.trace, convergence=False))

    def params(self):
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.ctx.seed, "weights"))
        return self.ref.make_params(self.cfg, g, self.device)

    def draws(self, r: int):
        """Round ``r``'s batch indices ``[N, u B]`` and noise ``[N, u, 1, P]``."""
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.ctx.seed, "idx", r))
        sizes = torch.as_tensor(self.sizes, device=self.device)
        idx = (torch.rand((self.n, self.u * self.b), generator=g, device=self.device)
               * sizes[:, None]).long()
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.ctx.seed, "eps", r))
        eps = torch.randn((self.n, self.u, 1, self.p), generator=g, device=self.device)
        return idx, eps

    # -- the program ---------------------------------------------------------

    def setup(self):
        from repro_torch.api import build_session

        t0 = time.perf_counter()
        self.init = self.params()
        self.session = build_session(self.spec(), device=self.device, init_params=self.init)
        self.times = {"build_s": time.perf_counter() - t0}
        self.rec_losses = []
        for r in range(self.tr["check_rounds"]):
            rec = self.round(check=True)
            self.rec_losses.append(rec["losses"])
            if r == 0:
                self._read_moments()
        self._read_change()
        self.times["check_rounds_s"] = time.perf_counter() - t0 - self.times["build_s"]
        obs = self.session.obs
        self.span_mark = len(obs.tracer.spans) if obs is not None else 0

    def round(self, check: bool = False) -> dict:
        if check:
            idx, eps = self.draws(self.round_idx)
            rec = self.session.round(batch_idx=idx, eps=eps)
            del eps
        else:
            rec = self.session.round()
        r, self.round_idx = self.round_idx, self.round_idx + 1
        kept = rec["n_trained"]
        out = {"round": r, "losses": rec["losses"], "work": kept * self.u * self.b,
               "failed": not np.isfinite(rec["loss"] if rec["loss"] is not None else np.nan)}
        if self.ctx.trace:
            out.update(flops=costs.mlp_train_flops(self.cfg, kept * self.u * self.b),
                       bytes=costs.posterior_adam_bytes(kept, self.p))
        return out

    def trace_stats(self, rounds) -> dict:
        """The eq. (6) byte bound of each traced round's merge, worked out
        once the window has closed.  An edge-native window's rows that take
        part come from the benchmark's own copy of its clock and faults:
        the rows that merge (``active``) and the sources of the edges that
        quarantine keeps (a corrupted sender's are dropped)."""
        out = {}
        for rec in rounds:
            r = rec["round"]
            if self.gossip:
                win, corrupt = self.window(r)
                kept = ~corrupt[win.src]
                merging = np.flatnonzero(win.active)
                read = np.union1d(merging, win.src[kept]).size
                out[r] = costs.eq6_edges_bytes(self.p, read, merging.size, int(kept.sum()))
            else:
                out[r] = costs.eq6_dense_bytes(self.n, self.p)
        return {"eq6_bytes": out}

    def _read_moments(self):
        st = self.session.state
        specs = st.posterior.layout.specs
        mu = st.opt_state.mu
        self.readings["moment_norms"] = {**flat_leaf_norms(mu.mean, specs, "mean"),
                                         **flat_leaf_norms(mu.rho, specs, "rho")}

    def _read_change(self):
        st = self.session.state
        post = st.posterior
        specs = post.layout.specs
        sig = self.cfg["init_sigma"]
        rho0 = sig + math.log(-math.expm1(-sig))  # as the posterior is initialised
        init_rho = {k: torch.full((v.numel(),), rho0, device=self.device)
                    for k, v in self.init.items()}
        self.readings["change_norms"] = {
            **flat_leaf_norms(post.mean, specs, "mean", minus=self.init),
            **flat_leaf_norms(post.rho, specs, "rho", minus=init_rho)}
        self.readings["losses"] = np.stack(self.rec_losses)
        if getattr(st, "n_quarantined", None) is not None:
            self.readings["quarantined"] = int(st.n_quarantined.sum())

    def obs_spans(self) -> list:
        obs = self.session.obs
        if obs is None:
            return []
        return [(s.name, s.dur_us) for s in obs.tracer.spans[self.span_mark:]]

    def release(self):
        del self.session
        self.session = None

    # -- the reference -------------------------------------------------------

    def window(self, r: int):
        if not hasattr(self, "_windows"):
            topo = self.tr["topology"]
            dst, src, w = session_inputs.watts_strogatz_edges(topo["n"], topo["k"], topo["beta"],
                                                              topo["graph_seed"])
            f = self.tr.get("faults") or {}
            self._faults = session_inputs.FaultDraws(
                self.n, f.get("crash_rate", 0.0), f.get("recover_rate", 0.5),
                f.get("corrupt_rate", 0.0), self.seeds["faults"])
            self._windows = session_inputs.SparsePoissonWindows(
                dst, src, w, self.tr["clock"]["rate"], self.seeds["clock"],
                self._faults if f else None)
        return self._windows.window(r), self._faults.corrupted(r)

    def reference_readings(self, control: bool = False, faults=()) -> dict:
        """The reference's own run of the check rounds from the seed, read as
        the program's run is read.  ``control``: computed in TF32, the
        precision below the configuration's; ``faults``: planted faults
        (``unchanged``, ``half_batch``, ``no_exchange``)."""
        ref, cfg, dev = self.ref, self.cfg, self.device
        x, y = session_inputs.synthetic_classification(
            cfg["n_classes"], cfg["dim"], self.npc, seed=self.seeds["data"])
        shards = session_inputs.partition_iid(len(y), self.n, self.seeds["partition"])
        table = np.zeros((self.n, int(self.sizes.max())), np.int64)
        for i, s in enumerate(shards):
            table[i, :len(s)] = s
        table = torch.as_tensor(table, device=dev)
        xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        init = self.params()
        net = ref.Network(cfg, init, self.n, dev)
        W = None if self.gossip else torch.as_tensor(
            session_inputs.grid_w(self.tr["topology"]["rows"], self.tr["topology"]["cols"]),
            device=dev)
        losses, quarantined, out = [], 0, {}
        rows = torch.arange(self.n, device=dev)[:, None]
        with ref.precision(tf32=control):
            for r in range(self.tr["check_rounds"]):
                idx, eps = self.draws(r)
                pick = table[rows, idx]
                batches = {"x": xt[pick].reshape(self.n, self.u, self.b, -1),
                           "y": yt[pick].reshape(self.n, self.u, self.b)}
                if self.gossip:
                    win, corrupt = self.window(r)
                    train = torch.as_tensor(self._faults.up(r), device=dev)
                else:
                    train = torch.ones(self.n, dtype=torch.bool, device=dev)
                lr = cfg["lr"] * cfg["lr_decay"] ** r
                if "unchanged" in faults:
                    snap = (dict(net.mean), dict(net.rho))
                    net.mean = {k: v.clone() for k, v in net.mean.items()}
                    net.rho = {k: v.clone() for k, v in net.rho.items()}
                loss = ref.local_steps(net, batches, eps, lr, train, faults=faults)
                del eps
                if "no_exchange" not in faults:
                    if self.gossip:
                        quarantined += ref.consensus_edges(net, win, corrupt)
                    else:
                        ref.consensus_dense(net, W)
                if "unchanged" in faults:
                    net.mean, net.rho = snap
                losses.append(loss.cpu().numpy())
                if r == 0:
                    out["moment_norms"] = {
                        **dict_leaf_norms({k: net.m[("mean", k)] for k in net.leaves()}, "mean"),
                        **dict_leaf_norms({k: net.m[("rho", k)] for k in net.leaves()}, "rho")}
        sig = cfg["init_sigma"]
        rho0 = sig + math.log(-math.expm1(-sig))
        init_rho = {k: torch.full((v.numel(),), rho0, device=dev) for k, v in init.items()}
        out["change_norms"] = {**dict_leaf_norms(net.mean, "mean", minus=init),
                               **dict_leaf_norms(net.rho, "rho", minus=init_rho)}
        out["losses"] = np.stack(losses)
        if self.gossip and self.tr.get("fault_policy") == "quarantine":
            out["quarantined"] = quarantined
        return out

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict:
        """The numbers compared: the first round's per-agent loss gaps at
        their 99th percentile (``loss_gap``: the worst agent swings with
        Adam's noise lanes, see ``PERF.md``); the worst leaf's gap in Adam's
        first moment after the first round and in the posterior's change
        over the check rounds (leaves whose reference moment is nought to
        rounding left out of the change); the quarantined count, exactly."""
        skip = still_leaves(ref["moment_norms"])
        out = {"loss_gap": loss_gap(prog["losses"][0], ref["losses"][0], q=0.99),
               "moment_gap": norm_gaps(prog["moment_norms"], ref["moment_norms"]),
               "change_gap": norm_gaps(prog["change_norms"], ref["change_norms"], skip)}
        if "quarantined" in ref:
            out["quarantined_gap"] = float(abs(prog.get("quarantined", -1) - ref["quarantined"]))
        return out
