"""LM training on a pytree posterior for the enc-dec and VLM configs
(Whisper-tiny, Pixtral-12B at ``reduced()`` size, float32) against the
JAX package on the CPU: tests/test_torch_pytree_steps.py's round step
(its setting, draws and hold rule, imported from it) with the frames or
patches in the batch (tests/test_torch_zoo_encdec_train.py's inputs), with
the einsum consensus and with the bf16 wire.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_pytree_steps import A, _hold_round, _round_case  # noqa: E402
from test_torch_zoo_encdec import _frontend, _j, _t, _toks  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(jcfg):
    """Tokens, targets and the stub inputs; the VLM's targets cover the
    patches and the text (the reference dry run's train batch)."""
    toks = _toks(jcfg, (A, 2, 13), 16)
    batch = {"tokens": toks[..., :-1], "targets": toks[..., 1:], **_frontend(jcfg, (A, 2), 17)}
    if not jcfg.is_encdec:
        batch["targets"] = _toks(jcfg, (A, 2, jcfg.n_patches + 12), 18)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    return _j(batch), _t(batch)


@pytest.mark.parametrize("route", ["einsum", "wire_bf16"])
@pytest.mark.parametrize("arch", ["whisper-tiny", "pixtral-12b"])
def test_round_step_against_the_reference(arch, route):
    j, t = _round_case(arch, route, batch_fn=_batch)
    _hold_round(j, t)
