"""LM training on the port (``repro_torch.launch.steps``
``make_train_round_step`` and ``make_local_step``'s language-model
objective, ``models`` under autograd) against the JAX package on the CPU,
at ``reduced()`` sizes in float32: A = 2 agents, B = 2 rows of S = 16
tokens each.

Both packages start from the reference's ``init_train_state`` carried
across, agent 1's mean moved by seeded noise (so eq. (6) mixes agents that
differ), and take the JAX sampler's tokens and the reference's draws
``eps_a = normal(split(key, A)[a], (P,))`` through the port's ``eps``
seam.  Held: the loss, each agent's nll per token and KL within
``F32_ATOL`` = 1e-4; the posterior and Adam's moments within 1e-4 under
``chip_smoke.train_parity``, the rule its card-vs-CPU training check
holds (Adam's noise lanes, ``adam_noise_lanes``, ROADMAP C.3): from Adam's
zero state a step is about ``lr * sign(g)``, so a lane whose gradient
cancels to rounding noise (a few in a million here, |g| ~ 1e-9) steps by
about lr either way in the two packages.  A posterior lane beyond 1e-4
must be such a lane (found from the two packages' Adam moments), within
the 2 u lr its steps allow, and at most 1% of the lanes may be beyond.
(The share counts these lanes only: after a bf16 wire the KL's gradient
at q == prior is 3e-14 in the reference and 0 in the port on every unseen
token's embedding row, noise lanes by the moments that move the posterior
by 3e-9.)  The MoE runs at float32 only (tests/test_torch_zoo_steps.py).

Here: one round step per served kind.  The round step's other routes, the
local steps, the checks inside the port and the entry points are in
tests/test_torch_zoo_train_steps.py.
"""
import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget  # noqa: E402
from repro.data.pipeline import make_lm_batch_sampler as j_sampler  # noqa: E402
from repro.launch import steps as js  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.flat import FlatPosterior  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.optim.optimizers import AdamState  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

A, B, S = 2, 2, 16
F32_ATOL = 1e-4
LR = 1e-3  # the round step's default schedule starts here
W = np.array([[0.75, 0.25], [0.25, 0.75]])  # the merged agents differ
ARCHS = ["repro-100m", "olmoe-1b-7b", "recurrentgemma-9b", "xlstm-1.3b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (dataclasses.replace(jget(arch).reduced(), dtype="float32"),
            dataclasses.replace(tget(arch).reduced(), dtype="float32"))


def _jax_state(jcfg):
    """The reference's initial state with agent 1's mean moved by seeded noise."""
    st = js.init_train_state(jax.random.key(0), jcfg, A, jadam())
    mean = np.array(st.posterior.mean)
    mean[1] += 0.01 * np.random.default_rng(7).normal(size=mean.shape[1]).astype(np.float32)
    return dataclasses.replace(st, posterior=dataclasses.replace(st.posterior,
                                                                 mean=jnp.asarray(mean)))


def _carry(jstate, tcfg):
    """A JAX ``BayesTrainState`` as the port's, leaf for leaf."""
    layout = ts.init_train_state(tcfg, A, adam(), torch.Generator().manual_seed(0),
                                 device="cpu").posterior.layout

    def flat(p):
        return FlatPosterior(torch.from_numpy(np.array(p.mean)),
                             torch.from_numpy(np.array(p.rho)), layout)

    return ts.BayesTrainState(
        posterior=flat(jstate.posterior),
        opt_state=AdamState(mu=flat(jstate.opt_state.mu), nu=flat(jstate.opt_state.nu)),
        step=torch.tensor(int(jstate.step), dtype=torch.int32))


def _batch(jcfg, seed):
    jb = j_sampler(jcfg.vocab_size, B, S, n_agents=A)(jax.random.key(seed), 0)
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _eps(key, p):
    """The reference's per-agent draws of one step (``post_a.sample(key_a)``)."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, (p,)))
                                      for k in jax.random.split(key, A)]))


def _moments(state):
    """A state's posterior and Adam moments as CPU tensors."""
    def t(x):
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))

    post, mu, nu = state.posterior, state.opt_state.mu, state.opt_state.nu
    return SimpleNamespace(
        posterior=SimpleNamespace(mean=t(post.mean), rho=t(post.rho)),
        opt_state=SimpleNamespace(mu=SimpleNamespace(mean=t(mu.mean), rho=t(mu.rho)),
                                  nu=SimpleNamespace(mean=t(nu.mean), rho=t(nu.rho))))


def _noise(tstate, jstate):
    return cs.adam_noise_lanes(_moments(tstate), _moments(jstate))


def _hold_state(tstate, jstate, u=1, lr=LR, noise=None):
    """``chip_smoke.train_parity`` at 2 u lr on Adam's noise lanes after
    the last step (or-ed with ``noise``, those after the earlier steps)."""
    got, want = _moments(tstate), _moments(jstate)
    noise = cs.adam_noise_lanes(got, want) | (False if noise is None else noise)
    fields = cs.train_parity(got, want, noise, 2 * u * lr)
    assert not fields["failures"], fields
    assert int(tstate.step) == int(jstate.step)
    return fields


def _close(got, want, atol=F32_ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _round_case(arch, jkw=None, tkw=None):
    """One round step in each package from the same state, tokens and draws."""
    jcfg, tcfg = _cfgs(arch)
    jstate = _jax_state(jcfg)
    jb, tb = _batch(jcfg, 1)
    key = jax.random.key(2)
    jstep = jax.jit(js.make_train_round_step(jcfg, jnp.asarray(W, jnp.float32), opt=jadam(),
                                             remat=False, **(jkw or {})))
    j2, jm = jstep(jstate, jb, key)
    tstep = ts.make_train_round_step(tcfg, torch.as_tensor(W, dtype=torch.float32), opt=adam(),
                                     remat=False, **(tkw or jkw or {}))
    t2, tm = tstep(_carry(jstate, tcfg), tb, eps=_eps(key, jstate.posterior.mean.shape[1]))
    return (j2, jm), (t2, tm)


@pytest.mark.parametrize("arch", ARCHS)
def test_round_step_against_the_reference(arch):
    (j2, jm), (t2, tm) = _round_case(arch)
    assert tm["loss"].shape == () and tm["nll"].shape == tm["kl"].shape == (A,)
    for name in ("loss", "nll", "kl"):
        _close(tm[name], jm[name])
    _hold_state(t2, j2)
