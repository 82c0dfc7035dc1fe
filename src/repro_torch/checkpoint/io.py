"""Pytree and session checkpoints (port of ``repro.checkpoint.io``), in the
JAX package's document format, so a checkpoint written by either package
loads in the other.

A document is MessagePack (``checkpoint._msgpack``, the port's own codec:
no ``msgpack`` package is needed), compressed with zstd when the
``zstandard`` module imports and with zlib otherwise; the reader sniffs the
zstd frame magic, so either build reads every format it can decode.  An
array leaf is ``{"__arr__": True, "dtype", "shape", "data"}``: ``dtype`` is
numpy's byte string (``'<f4'``, ``'<i4'``, ``'<f2'``) or, for an extension
dtype, its NAME (``"bfloat16"``, whose bytes are the int16 view's).  A torch
tensor is moved to the host to be written; array leaves read back as numpy
arrays, and a bf16 leaf as a CPU ``torch.bfloat16`` tensor (numpy has no
such dtype).

Leaf order is ``jax.tree.leaves``' for the same state (``core.tree``).  ``FlatPosterior``
checkpoints carry their layout doc, so they restore with no ``like`` tree.
``CheckpointManager`` adds step-numbered files, retention and an atomic
rename commit.
"""
from __future__ import annotations

import os
import shutil
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.core.flat import FlatLayout, FlatPosterior
from repro_torch.core.tree import tree_leaves, tree_replace_leaves

try:  # optional: not in every image
    import zstandard
except ImportError:  # pragma: no cover - depends on the installation
    zstandard = None

PyTree = Any

_ARR = "__arr__"
_SCALAR = "__scalar__"
_FLAT = "__flat_posterior__"
_SNAPSHOT = "__posterior_snapshot__"
_SESSION = "__session__"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_BF16 = "bfloat16"


def _compress(raw: bytes, level: int) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=level).compress(raw)
    return zlib.compress(raw, level)


def _decompress(comp: bytes) -> bytes:
    if comp[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError(
                "checkpoint is zstd-compressed but the zstandard module is "
                "not installed in this environment"
            )
        return zstandard.ZstdDecompressor().decompress(comp)
    return zlib.decompress(comp)


# -- leaves -------------------------------------------------------------------


def _arr_doc(dtype: str, shape, data: bytes) -> dict:
    return {_ARR: True, "dtype": dtype, "shape": [int(s) for s in shape], "data": data}


def _pack_leaf(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return _arr_doc(_BF16, t.shape, t.view(torch.int16).numpy().tobytes())
        leaf = t.numpy()
    if isinstance(leaf, np.ndarray):
        return _arr_doc(leaf.dtype.str, leaf.shape, leaf.tobytes())
    if isinstance(leaf, (int, float, bool, str)) or leaf is None:
        return {_SCALAR: True, "value": leaf}
    raise TypeError(f"unsupported checkpoint leaf type {type(leaf)}")


def _unpack_leaf(doc):
    if isinstance(doc, dict) and doc.get(_ARR):
        tag, shape, data = doc["dtype"], doc["shape"], bytearray(doc["data"])
        if tag == _BF16:
            return torch.frombuffer(data, dtype=torch.int16).view(torch.bfloat16).reshape(shape)
        dt = np.dtype(tag) if not tag[:1].isalpha() else None
        if dt is None or dt.kind == "V":
            raise ValueError(f"checkpoint leaf dtype {tag!r} is not one the port reads")
        return np.frombuffer(data, dtype=dt).reshape(shape)
    if isinstance(doc, dict) and doc.get(_SCALAR):
        return doc["value"]
    return doc


def restore_leaf(stored, ref):
    """Restore ONE stored leaf into the shape, dtype and device of reference
    leaf ``ref`` (shared by ``restore_pytree`` and ``api.Session.load``).
    Non-array references pass the stored value through."""
    if isinstance(ref, (torch.Tensor, np.ndarray)):
        if tuple(stored.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch: {tuple(stored.shape)} vs {tuple(ref.shape)}")
        if isinstance(ref, np.ndarray):
            if isinstance(stored, torch.Tensor):
                stored = stored.float().numpy()
            return np.asarray(stored).astype(ref.dtype, copy=False)
        return _as_tensor(stored).to(device=ref.device, dtype=ref.dtype, copy=True)
    return stored


def _as_tensor(stored) -> torch.Tensor:
    """A read leaf as a host tensor (numpy arrays in native byte order)."""
    if isinstance(stored, torch.Tensor):
        return stored
    return torch.from_numpy(stored.astype(stored.dtype.newbyteorder("="), copy=False))


# -- documents ----------------------------------------------------------------


def _write_doc(path: str, doc: dict, compress_level: int = 3) -> None:
    comp = _compress(_msgpack.packb(doc), compress_level)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(comp)
    os.replace(tmp, path)  # atomic commit


def _read_doc(path: str) -> dict:
    with open(path, "rb") as f:
        return _msgpack.unpackb(_decompress(f.read()))


def save_pytree(path: str, tree: PyTree, compress_level: int = 3) -> None:
    doc = {
        "treedef": type(tree).__name__,  # JAX writes str(treedef); no reader uses it
        "leaves": [_pack_leaf(leaf) for leaf in tree_leaves(tree)],
    }
    _write_doc(path, doc, compress_level)


def restore_pytree(path: str, like: PyTree) -> PyTree:
    """Restore into the structure, dtypes and devices of ``like``."""
    leaves = [_unpack_leaf(d) for d in _read_doc(path)["leaves"]]
    like_leaves = tree_leaves(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, expected {len(like_leaves)}")
    return tree_replace_leaves(
        like, [restore_leaf(s, ref) for s, ref in zip(leaves, like_leaves)])


def save_flat_posterior(path: str, post: FlatPosterior, compress_level: int = 3) -> None:
    """Checkpoint a ``FlatPosterior`` with its layout doc inline: the [N, P]
    buffers are written whole, so restoring needs no ``like`` tree."""
    doc = {
        _FLAT: True,
        "layout": post.layout.to_doc(),
        "mean": _pack_leaf(post.mean),
        "rho": _pack_leaf(post.rho),
    }
    _write_doc(path, doc, compress_level)


def restore_flat_posterior(path: str, device=None) -> FlatPosterior:
    """Restore a ``FlatPosterior`` saved by ``save_flat_posterior`` (either
    package's) onto ``device`` (default: the host)."""
    doc = _read_doc(path)
    if not doc.get(_FLAT):
        raise ValueError(f"{path} is not a flat-posterior checkpoint")

    return FlatPosterior(
        mean=_as_tensor(_unpack_leaf(doc["mean"])).to(device),
        rho=_as_tensor(_unpack_leaf(doc["rho"])).to(device),
        layout=FlatLayout.from_doc(doc["layout"]),
    )


def save_snapshot(path: str, snap, compress_level: int = 3) -> None:
    """Checkpoint a ``serve.PosteriorSnapshot``: its buffers in their
    resident dtype (a bf16 snapshot by the dtype's name) and its provenance
    (window, version, dtype, telemetry) in the document, so a serving
    replica restores the served posterior without any training state."""
    post = snap.posterior
    doc = {
        _SNAPSHOT: True,
        "layout": post.layout.to_doc(),
        "mean": _pack_leaf(post.mean),
        "rho": _pack_leaf(post.rho),
        "window": int(snap.window),
        "version": int(snap.version),
        "dtype": snap.dtype,
        "telemetry": snap.telemetry,
    }
    _write_doc(path, doc, compress_level)


def restore_snapshot(path: str, device=None):
    """Restore a ``serve.PosteriorSnapshot`` that either package's
    ``save_snapshot`` wrote, in its resident dtype, onto ``device``
    (default: the card; ``"cpu"`` to opt out)."""
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.serve.snapshot import PosteriorSnapshot

    doc = _read_doc(path)
    if not doc.get(_SNAPSHOT):
        raise ValueError(f"{path} is not a posterior-snapshot checkpoint")
    device = resolve_device(device)
    post = FlatPosterior(
        mean=_as_tensor(_unpack_leaf(doc["mean"])).to(device),
        rho=_as_tensor(_unpack_leaf(doc["rho"])).to(device),
        layout=FlatLayout.from_doc(doc["layout"]),
    )
    return PosteriorSnapshot(posterior=post, window=int(doc["window"]),
                             version=int(doc["version"]), dtype=doc["dtype"],
                             telemetry=dict(doc.get("telemetry") or {}))


def seed_key_data(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` as the JAX package runs
    (threefry, 64-bit mode off): ``uint32 [0, seed mod 2**32]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def save_session(
    path: str,
    spec_doc: dict,
    state,
    *,
    round_idx: int,
    key_data,
    generator: torch.Generator | None = None,
    compress_level: int = 3,
) -> None:
    """Self-describing ``api.Session`` checkpoint: the spec doc rides next to
    the engine-state leaves, so ``Session.load`` rebuilds the engine with no
    ``like`` tree; static metadata (the ``FlatLayout``) is rebuilt from the
    spec.  The JAX package's keys, plus ``torch_generator`` (``{"device",
    "state"}``, the bytes of ``generator.get_state()``) when ``generator``
    is given; the JAX reader ignores it."""
    doc = {
        _SESSION: True,
        "spec": spec_doc,
        "round": int(round_idx),
        "key_data": _pack_leaf(np.asarray(key_data)),
        "leaves": [_pack_leaf(leaf) for leaf in tree_leaves(state)],
    }
    if generator is not None:
        doc["torch_generator"] = {"device": generator.device.type,
                                  "state": generator.get_state().numpy().tobytes()}
    _write_doc(path, doc, compress_level)


def restore_session(path: str) -> tuple[dict, list, int, np.ndarray, dict | None]:
    """-> (spec_doc, state_leaves, round_idx, key_data, torch_generator);
    the last is ``None`` for a checkpoint the JAX package wrote.  Use
    ``api.Session.load`` for the full rebuild."""
    doc = _read_doc(path)
    if not doc.get(_SESSION):
        raise ValueError(f"{path} is not a session checkpoint")
    leaves = [_unpack_leaf(d) for d in doc["leaves"]]
    key_data = np.asarray(_unpack_leaf(doc["key_data"]))
    return doc["spec"], leaves, doc["round"], key_data, doc.get("torch_generator")


class CheckpointManager:
    """Step-numbered checkpoints with retention and atomic commit."""

    def __init__(self, root: str, max_to_keep: int = 3):
        self.root = root
        self.max_to_keep = max_to_keep
        os.makedirs(root, exist_ok=True)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}.ckpt")

    def save(self, step: int, tree: PyTree) -> str:
        path = self._step_path(step)
        save_pytree(path, tree)
        self._gc()
        return path

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and name.endswith(".ckpt"):
                steps.append(int(name[len("step_"):-len(".ckpt")]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: PyTree, step: int | None = None) -> tuple[int, PyTree]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return step, restore_pytree(self._step_path(step), like)

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.max_to_keep]:
            p = self._step_path(s)
            if os.path.isdir(p):
                shutil.rmtree(p)
            else:
                os.remove(p)
