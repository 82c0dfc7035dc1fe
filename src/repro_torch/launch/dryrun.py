"""Multi-pod dry run on the ``meta`` device (port of ``repro.launch.dryrun``):
for an (architecture x input shape x mesh), the parameter counts, the
inputs' shapes and partition specs, the analytic roofline of one step
(``launch.costmodel.analytic_costs``) and the parameter bytes a device
under the sharding rules (``launch.sharding.sharding_report``), on the
production mesh (``launch.mesh.make_production_mesh``, abstract) or a
``DxM`` override.  The reference counts a ``jax.eval_shape`` tree; here
``param_shapes`` builds the parameter dict on PyTorch's ``meta`` device
(shapes only, no memory), so a config of any size is counted on any host.

Left out: the reference lowers and compiles the step for 512 placeholder
devices and reads XLA's ``memory_analysis``, its HLO costs and the
collective bytes it parses from the HLO text (``parse_collectives``).  One
H100 has no 512-chip mesh and PyTorch no such compiler, so those fields
are absent; the analytic terms, which the reference itself calls primary,
are here.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out-dir benchmarks/results/torch]

Records go to ``dryrun_torch_{arch}_{shape}_{mesh}[_{variant}].json``, by
default under ``benchmarks/results/torch``: apart from the reference's
``dryrun_*.json`` records, whose XLA fields these lack.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Any, NamedTuple

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


class InputSpec(NamedTuple):
    """An input's shape, dtype and sharding (the reference's
    ``jax.ShapeDtypeStruct`` stand-in)."""

    shape: tuple
    dtype: Any
    sharding: Any


def _stacked(tree, a: int):
    """``tree``'s meta leaves with a leading agent axis of ``a``."""
    from repro_torch.core.tree import tree_map

    return tree_map(lambda leaf: leaf.expand((a,) + tuple(leaf.shape)), tree)


def input_specs(cfg, shape, mesh, *, mode: str) -> dict[str, InputSpec]:
    """The shape, dtype and ``batch_pspec`` sharding of every model input
    (no allocation)."""
    import torch

    from repro_torch.launch.mesh import mesh_n_agents
    from repro_torch.launch.sharding import NamedSharding, batch_pspec

    a = mesh_n_agents(mesh)
    # ceil-divide: when the global batch can't split across agents (e.g.
    # long_500k batch=1 on 2 pods) each pod serves its own replica of the
    # request; the effective global batch is a * b.
    b = max(1, -(-shape.global_batch // a))
    s = shape.seq_len

    def sds(shp, dtype):
        return InputSpec(shp, dtype, NamedSharding(mesh, batch_pspec(mesh, shp)))

    out: dict[str, InputSpec] = {}
    if mode == "train":
        n_text = s
        if cfg.frontend == "vision_stub":
            n_text = s - cfg.n_patches
            out["patches"] = sds((a, b, cfg.n_patches, cfg.d_model), torch.float32)
        if cfg.frontend == "audio_stub":
            out["frames"] = sds((a, b, cfg.encoder_seq, cfg.d_model), torch.float32)
        out["tokens"] = sds((a, b, n_text), torch.int32)
        # vlm targets cover the full (patch+text) logit range
        out["targets"] = sds((a, b, s if cfg.frontend == "vision_stub" else n_text), torch.int32)
    elif mode == "prefill":
        n_text = s - (cfg.n_patches if cfg.frontend == "vision_stub" else 0)
        out["tokens"] = sds((a, b, n_text), torch.int32)
        if cfg.frontend == "vision_stub":
            out["patches"] = sds((a, b, cfg.n_patches, cfg.d_model), torch.float32)
        if cfg.frontend == "audio_stub":
            out["frames"] = sds((a, b, cfg.encoder_seq, cfg.d_model), torch.float32)
    elif mode == "decode":
        out["tokens"] = sds((a, b, 1), torch.int32)
        if cfg.frontend == "audio_stub":
            out["frames"] = sds((a, b, cfg.encoder_seq, cfg.d_model), torch.float32)
    return out


def long_context_window_override(cfg, shape) -> int | None:
    """Dense/full-attention archs run long_500k only via the SWA variant."""
    if shape.name != "long_500k":
        return None
    if cfg.family in ("ssm", "hybrid"):
        return None  # native sub-quadratic
    return cfg.long_context_window


def dryrun_one(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    *,
    kv_quant: bool = False,
    no_remat: bool = False,
    consensus_impl: str = "einsum",
    consensus_wire_dtype: str = "",
    mesh_shape: tuple[int, int] | None = None,
    variant: str = "",
) -> dict[str, Any]:
    """One dry run's record: the reference's fields that need no compiler
    (counts, ``analytic``, ``roofline_seconds``, ``dominant``,
    ``model_flops``, ``tokens_per_step``, ``window_override``,
    ``mesh_shape``), ``inputs`` (each input's shape, dtype and spec) and
    ``param_bytes_per_device`` / ``param_bytes_total`` /
    ``replicated_leaves`` of the weights the step holds (the f32 posterior
    mean for ``train``, bf16 serving weights otherwise) from
    ``sharding_report``.  ``no_remat`` changes the lowered program only, so
    nothing here; ``consensus_impl`` labels the record."""
    import torch

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.costmodel import analytic_costs
    from repro_torch.launch.mesh import make_mesh, make_production_mesh, mesh_n_agents, mesh_n_chips
    from repro_torch.launch.sharding import sharding_report

    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]

    if shape.name == "long_500k" and not cfg.long_context_ok:
        return {
            "arch": arch,
            "shape": shape_name,
            "mesh": "multi" if multi_pod else "single",
            "status": "skipped",
            "reason": "full-attention enc-dec; long_500k out of family scope "
                      "(DESIGN.md §5)",
        }

    if mesh_shape is not None:
        mesh = make_mesh(mesh_shape, ("data", "model"))
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    a = mesh_n_agents(mesh)
    chips = mesh_n_chips(mesh)
    window = long_context_window_override(cfg, shape)
    if consensus_wire_dtype not in ("", "f32", "bf16"):
        raise ValueError(f"consensus wire dtype {consensus_wire_dtype!r}")

    params_shape = _stacked(param_shapes(cfg), a)
    n_active = count_active_params(params_shape, cfg) // a
    if shape.kind == "train":
        flops_factor = 6.0
        tokens = shape.global_batch * shape.seq_len
        held = params_shape
    else:
        from repro_torch.core.tree import tree_map

        # serving paths use posterior-mean bf16 weights
        held = tree_map(lambda leaf: leaf.to(torch.bfloat16) if leaf.dtype == torch.float32
                        else leaf, params_shape)
        flops_factor = 2.0
        tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill" else 1)
    inputs = input_specs(cfg, shape, mesh, mode=shape.kind)
    _, bytes_total, bytes_dev, n_repl = sharding_report(held, mesh, agent_leading=True)

    analytic = analytic_costs(
        cfg,
        mode=shape.kind,
        batch_global=(max(1, -(-shape.global_batch // a))) * a,
        seq_len=shape.seq_len,
        n_agents=a,
        data_shards=mesh.shape["data"],
        model_shards=mesh.shape["model"],
        n_matmul_params=n_active,
        n_total_params=count_params(params_shape) // a,
        window=window,
        kv_bytes=1.0 + 4.0 / cfg.hd if kv_quant else 2.0,
    )
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "variant": variant,
        "mesh_shape": dict(mesh.shape),
        "kv_quant": kv_quant,
        "consensus_impl": consensus_impl,
        "consensus_wire_dtype": consensus_wire_dtype or "f32",
        "status": "ok",
        "n_agents": a,
        "chips": chips,
        "window_override": window,
        "params_per_agent": count_params(params_shape) // a,
        "active_params_per_agent": n_active,
        "tokens_per_step": tokens,
        "inputs": {k: {"shape": list(v.shape), "dtype": str(v.dtype).removeprefix("torch."),
                       "spec": list(v.sharding.spec)} for k, v in inputs.items()},
        "param_bytes_total": bytes_total,
        "param_bytes_per_device": bytes_dev,
        "replicated_leaves": n_repl,
        "roofline_seconds": analytic["roofline_seconds"],
        "analytic": analytic,
        "dominant": analytic["dominant"],
        "model_flops": flops_factor * n_active * tokens,
    }


def main(argv=None) -> int:
    from repro_torch.configs import INPUT_SHAPES, list_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="benchmarks/results/torch")
    ap.add_argument("--variant", default="", help="tag for the output filename")
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    ap.add_argument("--no-remat", action="store_true",
                    help="no effect here (it changes the lowered program only); kept as the "
                         "reference's flag")
    ap.add_argument("--consensus-impl", default="einsum", choices=["einsum", "ppermute", "none"],
                    help="no effect on the counts here; kept as the reference's flag and "
                         "recorded as a label")
    ap.add_argument("--consensus-dtype", default="", choices=["", "f32", "bf16"])
    ap.add_argument("--mesh-shape", default="", help="DxM single-pod override, e.g. 32x8")
    args = ap.parse_args(argv)
    mesh_shape = None
    if args.mesh_shape:
        d_, m_ = args.mesh_shape.split("x")
        mesh_shape = (int(d_), int(m_))

    if args.all:
        combos = [(arch, shp) for arch in list_archs() if arch != "repro-100m"
                  for shp in INPUT_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("need --arch and --shape (or --all)")
        combos = [(args.arch, args.shape)]

    os.makedirs(args.out_dir, exist_ok=True)
    failures = 0
    for arch, shp in combos:
        tag = f"{arch}_{shp}_{'multi' if args.multi_pod else 'single'}"
        if args.variant:
            tag += f"_{args.variant}"
        try:
            res = dryrun_one(
                arch, shp, args.multi_pod,
                kv_quant=args.kv_quant,
                no_remat=args.no_remat,
                consensus_impl=args.consensus_impl,
                consensus_wire_dtype=args.consensus_dtype,
                mesh_shape=mesh_shape,
                variant=args.variant,
            )
        except Exception as e:  # noqa: BLE001  (recorded in the file, counted in the exit code)
            res = {
                "arch": arch, "shape": shp,
                "mesh": "multi" if args.multi_pod else "single",
                "status": "error", "error": f"{type(e).__name__}: {e}",
            }
            failures += 1
        path = os.path.join(args.out_dir, f"dryrun_torch_{tag}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        dom = res.get("dominant", "-")
        per_dev = res.get("param_bytes_per_device")
        print(
            f"[{res['status']:7s}] {arch:26s} {shp:12s} "
            f"mesh={res['mesh']:6s} dominant={dom} "
            f"param_GB/device={'-' if per_dev is None else round(per_dev / 1e9, 3)}",
            flush=True,
        )
        if res["status"] == "error":
            print("   ", res["error"], flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
