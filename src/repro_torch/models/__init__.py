"""The model zoo (port of ``repro.models``): the decoder block kinds
``attn``, ``local_attn``, ``moe``, ``rglru``, ``mlstm`` and ``slstm``,
served with prefill attention on the ``flash_attention`` kernels.  ``params_from_numpy`` / ``params_to_numpy``
carry the reference's parameter trees across, leaf for leaf."""
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    nll_loss,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.models import attention, modules, moe, rglru, xlstm

__all__ = [
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "nll_loss",
    "params_from_numpy",
    "params_to_numpy",
    "attention",
    "modules",
    "moe",
    "rglru",
    "xlstm",
]
