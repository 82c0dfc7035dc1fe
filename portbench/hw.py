"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates
without sparsity, from NVIDIA's H100 Tensor Core GPU data sheet.  They
assume the full 700 W power limit; a run records the card's limit beside
its numbers (``power_limit``).  Frozen here so that a change to the
program cannot move the yardstick."""
from __future__ import annotations

import subprocess

PEAK_FLOPS = {
    "bfloat16": 989e12,  # tensor cores, dense
    "tf32": 495e12,      # tensor cores, dense
    "float32": 67e12,    # outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    ``"not read"`` where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
