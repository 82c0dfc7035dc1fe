"""Device resolution, the kernel library's build and load, and the launch
counters (the port's counterpart of ``repro.kernels.dispatch``).

The CUDA kernels live in ``kernels/csrc/*.cu`` with a plain C interface.  At
first use, ``library()`` compiles each source with its own ``nvcc`` process
(all started together) for ``sm_90a`` and links the objects into one shared
library under ``build/repro_torch/`` at the root of the checkout, named by a
hash of the sources and flags, then loads it with ``ctypes``.  A later call
in any process finds the built file and only loads it.  Nothing here runs
when the module is imported, so machines without ``nvcc`` or a GPU import
every module of the package.

Launch counters: each kernel wrapper calls ``count_launch(name)`` exactly
where it launches its kernel, and nowhere else, so a run can show that its
path went through the kernel (``launch_counts`` / ``reset_launch_counts``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = (
    "consensus_fused_network", "payload_validity_fused", "consensus_fused_masked",
    "consensus_fused_sparse", "consensus_fused_masked_sparse", "consensus_fused",
    "sample_and_kl_fused", "flash_attention", "consensus_fused_segments",
    "consensus_shard_encode", "consensus_fused_shard", "flash_attention_f32",
)
_launches = dict.fromkeys(KERNELS, 0)
_lib: ctypes.CDLL | None = None
_waves: dict[tuple, int] = {}  # (device index, kernel, instance) -> blocks in one wave
_counters: dict[tuple[int, int], torch.Tensor] = {}  # (device index, stream) -> counter
build_info: dict = {}  # seconds / path / ptxas report of the last build or load


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for CUDA without a usable GPU
    raises; the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link one shared library;
    returns its path (an existing build of the same sources is reused)."""
    out = _library_path()
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, built=False)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        reports, failed = [], []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            reports.append(log)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so), *[str(o) for _, o, _ in procs]],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, out)  # atomic: a concurrent loader sees all or nothing
    build_info.update(
        path=str(out), seconds=time.perf_counter() - t0, built=True,
        ptxas="".join(reports),
    )
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use) with every entry
    point's argument types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.consensus_network_blocks_per_sm.argtypes = [i32, i32]
        lib.consensus_network_blocks_per_sm.restype = i32
        lib.consensus_network_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, i32, ptr,
        ]
        lib.consensus_network_launch.restype = i32
        lib.payload_validity_blocks_per_sm.argtypes = [i32, i32]
        lib.payload_validity_blocks_per_sm.restype = i32
        lib.payload_validity_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i64, i64, ctypes.c_float, i32, i32, i64, i32, ptr,
        ]
        lib.payload_validity_launch.restype = i32
        lib.consensus_sparse_blocks_per_sm.argtypes = [i32, i32, i32]
        lib.consensus_sparse_blocks_per_sm.restype = i32
        lib.consensus_sparse_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i64, i32, i32, i32, i32, ptr,
        ]
        lib.consensus_sparse_launch.restype = i32
        lib.consensus_row_blocks_per_sm.argtypes = [i32, i32]
        lib.consensus_row_blocks_per_sm.restype = i32
        lib.consensus_row_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, ptr,
        ]
        lib.consensus_row_launch.restype = i32
        lib.sample_and_kl_blocks_per_sm.argtypes = [i32]
        lib.sample_and_kl_blocks_per_sm.restype = i32
        lib.sample_and_kl_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i64, i32, ptr,
        ]
        lib.sample_and_kl_launch.restype = i32
        lib.flash_attention_launch.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, ptr,
        ]
        lib.flash_attention_launch.restype = i32
        lib.flash_attention_tc_launch.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, ptr,
        ]
        lib.flash_attention_tc_launch.restype = i32
        lib.consensus_segments_blocks_per_sm.argtypes = [i32, i32, i32, i32]
        lib.consensus_segments_blocks_per_sm.restype = i32
        lib.consensus_segments_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64,
            i32, i32, i32, i32, i32, ptr,
        ]
        lib.consensus_segments_launch.restype = i32
        lib.consensus_shard_blocks_per_sm.argtypes = [i32, i32]
        lib.consensus_shard_blocks_per_sm.restype = i32
        lib.consensus_shard_encode_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.consensus_shard_encode_launch.restype = i32
        lib.consensus_shard_reduce_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i64, i32, i32, ptr,
        ]
        lib.consensus_shard_reduce_launch.restype = i32
        _lib = lib
    return _lib


def wave(device: torch.device, what: str, blocks_per_sm, *key) -> int:
    """Blocks in one wave of a kernel instance on ``device``: its SM count
    times ``blocks_per_sm(*key)`` (the library's occupancy query for that
    instance), asked once per device and instance."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    k = (index, what, *key)
    if k not in _waves:
        per_sm = blocks_per_sm(*key)
        if per_sm <= 0:
            raise RuntimeError(f"{what}: occupancy query failed ({per_sm})")
        _waves[k] = torch.cuda.get_device_properties(index).multi_processor_count * per_sm
    return _waves[k]


def arrival_counter(device: torch.device) -> torch.Tensor:
    """The arrival counter of the single-launch kernels (one uint32, 0
    between launches: the last block of each launch resets it) for the
    current stream of ``device``.  Launches on one stream run one after
    another, so they share it; each stream has its own."""
    stream = torch.cuda.current_stream(device)
    k = (stream.device_index, stream.cuda_stream)
    if k not in _counters:
        _counters[k] = torch.zeros(1, dtype=torch.int32, device=stream.device)
    return _counters[k]


def check_cuda(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
