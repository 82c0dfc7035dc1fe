"""Parameter counts of a model-zoo config (port of ``repro.launch.dryrun``'s
``count_params`` and ``count_active_params``), the inputs of
``launch.costmodel.analytic_costs``.  The reference counts a
``jax.eval_shape`` tree; here ``param_shapes`` builds the parameter dict on
PyTorch's ``meta`` device (shapes only, no memory), so a config of any
size is counted on any host.  The rest of the reference's dry run (the
production mesh, lowering and the HLO collective parse) comes with the
sharding slice (ROADMAP queue A item 10f).
"""
from __future__ import annotations

import math
from typing import Any

PyTree = Any


def param_shapes(cfg) -> PyTree:
    """``models.init_params(cfg)``'s dict of tensors on the ``meta`` device."""
    from repro_torch.models import init_params

    return init_params(cfg, device="meta")


def _leaves_with_names(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_names(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_names(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def count_params(shape_tree: PyTree) -> int:
    return sum(math.prod(leaf.shape) for _, leaf in _leaves_with_names(shape_tree))


def count_active_params(params_shape: PyTree, cfg) -> int:
    """Matmul-active params per token for the 6ND / 2ND estimate:
    * expert stacks scaled by top_k / n_experts (MoE active fraction),
    * the input embedding table is a gather (0 matmul FLOPs) unless tied,
      in which case it is counted once for the unembed matmul."""
    total = 0
    for name, leaf in _leaves_with_names(params_shape):
        n = math.prod(leaf.shape)
        if cfg.n_experts and "moe" in name and (
            "w_gate" in name or "w_up" in name or "w_down" in name
        ):
            n = n * cfg.top_k // cfg.n_experts
        if "embed" in name and "emb" in name and not cfg.tie_embeddings:
            n = 0  # pure gather
        total += n
    return total
