"""Training the port's encoder-decoder and VLM configs (Whisper-tiny,
Pixtral-12B at ``reduced()`` size, float32) against the JAX package on the
CPU, in the setting of tests/test_torch_zoo_encdec.py (its helpers,
imported from it): ``nll_loss`` and its gradient (the VLM's text tail),
one ``make_train_round_step`` with the frames or patches in the batch, and
``remat`` on against off inside the port.

Tolerances: the NLL rtol 1e-5; its gradient within 1e-4 of the
reference's over the largest gradient leaf's scale; a training round as
tests/test_torch_zoo_train.py holds the other configs (the loss, nll and
KL at 1e-4, the state by ``chip_smoke.train_parity`` at 1e-4, the
reference's draws through the ``eps`` seam); ``remat`` bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jm  # noqa: E402
from repro.launch import steps as js  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map, tree_replace_leaves  # noqa: E402
from repro_torch.launch import steps as ts  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from test_torch_zoo_encdec import (  # noqa: E402
    A,
    ARCHS,
    F32_ATOL,
    _cfgs,
    _close,
    _frontend,
    _j,
    _params,
    _t,
    _toks,
)
from test_torch_zoo_train import _carry, _eps, _hold_state  # noqa: E402
from test_torch_zoo_train import _close as _close_train  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_nll_and_its_gradient_against_the_reference(arch):
    """``nll_loss`` and its gradient in every leaf.  The VLM's targets cover
    the text only, so both packages score the logits' text tail; the
    Whisper batch carries a loss mask."""
    jcfg, tcfg = _cfgs(arch)
    p, tp = _params(jcfg, 10)
    toks = _toks(jcfg, (2, 15), 11)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], **_frontend(jcfg, (2,), 12)}
    if jcfg.is_encdec:
        batch["loss_mask"] = (np.arange(14) % 4 > 0).astype(np.float32)[None].repeat(2, 0)
    ntok = batch["targets"].size

    def jloss(params):
        return jm.nll_loss(params, jcfg, _j(batch))[0] / ntok

    nj, gj = jax.jit(jax.value_and_grad(jloss))(p)
    leaves = [x.requires_grad_() for x in tree_leaves(tp)]
    nt = tm.nll_loss(tp, tcfg, _t(batch))[0] / ntok
    gt = torch.autograd.grad(nt, leaves)
    np.testing.assert_allclose(float(nt.detach()), float(nj), rtol=1e-5)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(gj))
    for got, want in zip(gt, jax.tree.leaves(gj)):
        _close(got, want, F32_ATOL * scale)
    if not jcfg.is_encdec:  # patches get no target: the tail is the text
        full = tm.forward(tp, tcfg, _t(batch)["tokens"], patches=_t(batch)["patches"])[0]
        assert full.shape[-2] == jcfg.n_patches + 14


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_off_bitwise(arch):
    """``remat=True`` checkpoints every period, the encoder's included: the
    loss and every gradient the same bits as without it."""
    _, tcfg = _cfgs(arch)
    params = tm.init_params(tcfg, torch.Generator().manual_seed(13), device="cpu")
    stacked = tree_map(lambda x: torch.stack([x, x * 0.9]), params)
    toks = _toks(tcfg, (2, 2, 9), 14)
    batch = _t({"tokens": toks[..., :-1], "targets": toks[..., 1:], **_frontend(tcfg, (2, 2), 15)})
    if not tcfg.is_encdec:
        batch["targets"] = torch.cat([batch["targets"]] * 3, dim=-1)[..., :tcfg.n_patches + 8]
    out = []
    for remat in (False, True):
        leaves = [x.detach().clone().requires_grad_() for x in tree_leaves(stacked)]
        nll, _ = tm.nll_loss(tree_replace_leaves(stacked, leaves), tcfg, batch, remat=remat)
        out.append((nll.detach(), torch.autograd.grad(nll.sum(), leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_round_step_against_the_reference(arch):
    """One ``make_train_round_step`` (eq. (6), then a Bayes-by-Backprop
    step) from the same state, tokens, stub inputs and draws: the loss,
    nll and KL at 1e-4 and the state by ``train_parity``.  The VLM's
    targets cover the patches and the text (the reference dry run's train
    batch), so ``ntok`` counts the patch positions."""
    jcfg, tcfg = _cfgs(arch)
    jstate = js.init_train_state(jax.random.key(0), jcfg, A, jadam())
    mean = np.array(jstate.posterior.mean)
    mean[1] += 0.01 * np.random.default_rng(7).normal(size=mean.shape[1]).astype(np.float32)
    jstate = dataclasses.replace(jstate, posterior=dataclasses.replace(
        jstate.posterior, mean=jnp.asarray(mean)))
    toks = _toks(jcfg, (A, 2, 13), 16)
    batch = {"tokens": toks[..., :-1], "targets": toks[..., 1:], **_frontend(jcfg, (A, 2), 17)}
    if not jcfg.is_encdec:
        batch["targets"] = _toks(jcfg, (A, 2, jcfg.n_patches + 12), 18)
    W = np.array([[0.75, 0.25], [0.25, 0.75]])
    key = jax.random.key(2)
    jstep = jax.jit(js.make_train_round_step(jcfg, jnp.asarray(W, jnp.float32), opt=jadam(),
                                             remat=False))
    j2, jmet = jstep(jstate, _j(batch), key)
    tstep = ts.make_train_round_step(tcfg, torch.as_tensor(W, dtype=torch.float32), opt=adam(),
                                     remat=False)
    t2, tmet = tstep(_carry(jstate, tcfg), _t(batch),
                     eps=_eps(key, jstate.posterior.mean.shape[1]))
    for name in ("loss", "nll", "kl"):
        _close_train(tmet[name], jmet[name])
    _hold_state(t2, j2)
