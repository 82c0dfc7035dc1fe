import os
import subprocess
import sys

# Smoke tests and benches must see 1 CPU device (the dry-run, and ONLY the
# dry-run, sets --xla_force_host_platform_device_count=512 itself).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", False)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers",
        "multidevice: spawns an 8-virtual-device XLA subprocess "
        "(deselected from the default tier-1 run via pytest.ini addopts; "
        "CI runs `-m multidevice` as its own step)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: runs a repro_torch CUDA kernel on an NVIDIA GPU (skips without "
        "one; on a GPU machine without JAX: `PYTHONPATH=src python -m pytest "
        "--noconftest -m cuda tests/test_torch_kernels_cuda.py`)",
    )


def run_multidevice_subprocess(code: str, timeout: int = 420) -> None:
    """Run ``code`` in a fresh interpreter so it can claim its own XLA
    device count (``--xla_force_host_platform_device_count`` must be set
    before jax initializes; the main pytest process keeps its single CPU
    device).  Shared by the distributed-substrate and sharded-gossip test
    suites — the multi-device harness lives HERE, once."""
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env={
            "PYTHONPATH": "src",
            "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "JAX_PLATFORMS": "cpu",
            "HOME": os.environ.get("HOME", os.path.expanduser("~")),
        },
        cwd=_REPO_ROOT,
        timeout=timeout,
    )
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
