"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's own functions on the same inputs, in process.

The reference's ``dryrun_one`` lowers and compiles for 512 placeholder
devices; the port's returns the fields that need no compiler.  Each of
those is held against what the reference computes them from:
``count_params`` / ``count_active_params`` over its ``jax.eval_shape``
parameters, ``long_context_window_override``, ``analytic_costs`` (its
counts exactly; the seconds are those counts over the H100's peaks in
``repro_torch.launch.mesh``, not the reference's v5e constants, and the
dominant term the largest of them), ``input_specs`` (shapes, dtypes and
partition specs, on an ``AbstractMesh``), and ``sharding_report`` for the
bytes a device.  Then
``main --all`` (single and multi pod) writes every record into
``tmp_path``.
"""
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from repro.configs import INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch.costmodel import analytic_costs as j_analytic  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16  # noqa: E402

jax.devices()  # the backend first: the reference's dry run sets XLA_FLAGS when imported
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

CASES = [("qwen3-8b", "train_4k", True, {}), ("olmoe-1b-7b", "prefill_32k", False, {}),
         ("phi3.5-moe-42b-a6.6b", "decode_32k", True, {"kv_quant": True}),
         ("mistral-nemo-12b", "long_500k", False, {}), ("xlstm-1.3b", "long_500k", True, {}),
         ("pixtral-12b", "train_4k", False, {"mesh_shape": (32, 8)}),
         ("whisper-tiny", "prefill_32k", True, {}), ("recurrentgemma-9b", "decode_32k", False, {})]


def _reference_fields(arch, shape_name, multi_pod, kv_quant=False, mesh_shape=None):
    """What the reference's ``dryrun_one`` computes these fields from, by
    its own functions, on an abstract mesh of the same shape."""
    cfg, shape = jget(arch), INPUT_SHAPES[shape_name]
    if mesh_shape is not None:
        mesh = AbstractMesh(mesh_shape, ("data", "model"))
    elif multi_pod:
        mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    else:
        mesh = AbstractMesh((16, 16), ("data", "model"))
    a = mesh.shape.get("pod", 1)
    params = jax.eval_shape(lambda: jinit(cfg, jax.random.key(0)))
    stacked = jax.tree.map(lambda x: jax.ShapeDtypeStruct((a,) + x.shape, x.dtype), params)
    n_active = jdry.count_active_params(stacked, cfg) // a
    window = jdry.long_context_window_override(cfg, shape)
    analytic = j_analytic(
        cfg, mode=shape.kind, batch_global=max(1, -(-shape.global_batch // a)) * a,
        seq_len=shape.seq_len, n_agents=a, data_shards=mesh.shape["data"],
        model_shards=mesh.shape["model"], n_matmul_params=n_active,
        n_total_params=jdry.count_params(stacked) // a, window=window,
        kv_bytes=1.0 + 4.0 / cfg.hd if kv_quant else 2.0)
    chips = analytic["chips"]
    seconds = {"compute": analytic["flops_global"] / (chips * PEAK_FLOPS_BF16),
               "memory": analytic["hbm_bytes_global"] / (chips * HBM_BW),
               "collective": analytic["collective_bytes_global"] / (chips * ICI_BW)}
    analytic = dict(analytic, roofline_seconds=seconds, dominant=max(seconds, key=seconds.get))
    if shape.kind == "train":
        held, factor, tokens = stacked, 6.0, shape.global_batch * shape.seq_len
    else:
        held = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
            x.shape, jax.numpy.bfloat16 if x.dtype == jax.numpy.float32 else x.dtype), stacked)
        factor = 2.0
        tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill" else 1)
    _, total, per_dev, n_repl = jsh.sharding_report(held, mesh, agent_leading=True)
    inputs = {k: {"shape": list(v.shape), "dtype": str(np.dtype(v.dtype)),
                  "spec": list(v.sharding.spec) + [None] * (len(v.shape) - len(v.sharding.spec))}
              for k, v in jdry.input_specs(cfg, shape, mesh, mode=shape.kind).items()}
    return {
        "n_agents": a, "chips": int(np.prod(list(mesh.shape.values()))),
        "mesh_shape": dict(mesh.shape), "window_override": window,
        "params_per_agent": jdry.count_params(stacked) // a, "active_params_per_agent": n_active,
        "tokens_per_step": tokens, "analytic": analytic,
        "roofline_seconds": analytic["roofline_seconds"], "dominant": analytic["dominant"],
        "model_flops": factor * n_active * tokens, "param_bytes_total": total,
        "param_bytes_per_device": per_dev, "replicated_leaves": n_repl, "inputs": inputs,
    }


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12, abs=0.0)
    else:
        assert got == want


@pytest.mark.parametrize("arch,shape,multi_pod,kw", CASES, ids=lambda v: str(v))
def test_dryrun_one_against_the_references_functions(arch, shape, multi_pod, kw):
    got = tdry.dryrun_one(arch, shape, multi_pod, **kw)
    assert got["status"] == "ok" and got["arch"] == arch and got["shape"] == shape
    assert got["mesh"] == ("multi" if multi_pod else "single")
    want = _reference_fields(arch, shape, multi_pod, **kw)
    for k, v in want.items():
        if k == "inputs":
            # trailing replicated dims: the reference's spec may leave them out
            got_inputs = {n: dict(x, spec=x["spec"] + [None] * (len(x["shape"]) - len(x["spec"])))
                          for n, x in got[k].items()}
            assert got_inputs == v
        else:
            _same(got[k], v)


def test_the_enc_dec_long_context_skip():
    got = tdry.dryrun_one("whisper-tiny", "long_500k", True)
    want = jdry.dryrun_one("whisper-tiny", "long_500k", True)  # returns before lowering
    assert got == want and got["status"] == "skipped"


def test_main_all_writes_every_record(tmp_path, capsys):
    for multi in (False, True):
        out = tmp_path / ("multi" if multi else "single")
        argv = ["--all", "--out-dir", str(out)] + (["--multi-pod"] if multi else [])
        assert tdry.main(argv) == 0
        files = sorted(out.glob("dryrun_torch_*.json"))
        assert len(files) == 10 * len(INPUT_SHAPES)  # every arch but repro-100m
        recs = [json.loads(f.read_text()) for f in files]
        assert {r["status"] for r in recs} == {"ok", "skipped"}
        assert sum(r["status"] == "skipped" for r in recs) == 1  # whisper-tiny long_500k
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 * 10 * len(INPUT_SHAPES) and all("dominant=" in x for x in lines)
    assert tdry.main(["--arch", "qwen3-8b", "--shape", "decode_32k", "--mesh-shape", "8x4",
                      "--out-dir", str(tmp_path / "one"), "--variant", "v"]) == 0
    rec = json.loads((tmp_path / "one" / "dryrun_torch_qwen3-8b_decode_32k_single_v.json").read_text())
    assert rec["mesh_shape"] == {"data": 8, "model": 4} and rec["variant"] == "v"
    with pytest.raises(SystemExit):
        tdry.main(["--arch", "qwen3-8b"])
