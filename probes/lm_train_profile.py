#!/usr/bin/env python3
"""Where a full-width LM training step's device time goes, by PyTorch op.

    python3 probes/lm_train_profile.py          # on the card

``chip_smoke.py``'s ``3.lm_train`` setting (repro-100m at full width, A = 2,
batch 8 of S = 256 Zipf tokens an agent, bf16 compute, f32 posterior and
Adam state): two warm local steps, then one local step under
``torch.profiler``.  It prints the step's CUDA-event time, the profiler's
device time and kernel count, the device time of each phase of the step
(``record_function`` spans around ``FlatPosterior.sample`` and the KL over
the ``[1, P]`` posterior rows, the forward ``models.nll_loss`` and the
optimizer's update; the rest, the backward, which autograd runs outside
the spans' thread, and the new rows' update and copies in
``vi.bayes_by_backprop.blocked_update``, is the profiled time less the
spans), and the top aten ops by self device time with their calls.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch.models as models  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.flat import FlatPosterior  # noqa: E402
from repro_torch.data.pipeline import make_lm_batch_sampler  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.optim.schedules import exponential_decay  # noqa: E402

SPANS = ("posterior.sample", "posterior.kl", "model.nll_loss", "optimizer.update")


def spanned(owner, name, span):
    """Wrap ``owner.name`` in a ``record_function`` span (the step looks it
    up at call time, so the wrapper is what runs; outside a profiler a span
    costs next to nothing)."""
    fn = getattr(owner, name)

    def wrapped(*args, **kwargs):
        with record_function(span):
            return fn(*args, **kwargs)

    setattr(owner, name, wrapped)


def main() -> int:
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_name_power(), torch.__version__, torch.version.cuda)
    cfg = get_config(cs.TRAIN_ARCH)
    a, b, s = cs.TRAIN_AGENTS, cs.TRAIN_BATCH, cs.TRAIN_S
    spanned(FlatPosterior, "sample", "posterior.sample")
    spanned(steps, "kl_gaussian", "posterior.kl")
    spanned(models, "nll_loss", "model.nll_loss")
    opt = adam()
    update = opt.update

    def spanned_update(*args, **kwargs):
        with record_function("optimizer.update"):
            return update(*args, **kwargs)

    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps.init_train_state(cfg, a, opt, gen, device=dev)
    sampler = make_lm_batch_sampler(cfg.vocab_size, b, s, n_agents=a, device=dev)
    local = steps.make_local_step(cfg, opt._replace(update=spanned_update),
                                  exponential_decay(cs.TRAIN_LR, cs.TRAIN_LR_DECAY),
                                  kl_scale=cs.TRAIN_KL, remat=False)
    prior = state.posterior
    batch = sampler(gen, 0)
    for _ in range(2):
        state, _ = local(state, prior, batch, generator=gen)
    _, event_ms = cs.timed(lambda: local(state, prior, batch, generator=gen))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        local(state, prior, batch, generator=gen)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"local step: {event_ms:.2f} ms (CUDA events); profiled device {device_ms:.2f} ms in "
          f"{sum(e.count for e in kernels)} kernels")
    spans = {e.key: e.device_time_total / 1e3 for e in events if e.key in SPANS}
    print("spans (device ms, children included):", {k: round(v, 2) for k, v in spans.items()})
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU and e.key.startswith(
        "aten::") and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    print("top ops by self device ms:")
    for e in ops[:25]:
        print(f"  {e.key:40s} calls {e.count:6d}  {e.self_device_time_total / 1e3:9.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
