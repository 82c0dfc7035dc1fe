"""The card's constants for the roofline analysis (port of
``repro.launch.mesh``'s constants, for one NVIDIA H100 SXM5 80 GB).

The JAX package's values are a TPU v5e's; none of them carries over.  The
names stay, so that ``launch.costmodel`` reads the same three constants.
Each is NVIDIA's published peak for the SXM5 part at its full 700 W power
limit (the H100 data sheet, dense rates without sparsity); a card set
below 700 W runs slower under load, so a share of these peaks is stated
with the card's power limit beside it.

The mesh functions (``make_production_mesh``, ``mesh_n_agents``,
``mesh_n_chips``) arrive with the sharded windows and the model zoo
(ROADMAP queue A, items 9 and 10).
"""
from __future__ import annotations

# dense bf16 (and fp16) on the tensor cores, H100 SXM5 data sheet
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
# HBM3, 80 GB, H100 SXM5 data sheet
HBM_BW = 3.35e12  # B/s
# NVLink 4: 900 GB/s both ways per GPU, so 450 GB/s a direction (the data
# sheet's 900 GB/s is the two directions summed)
ICI_BW = 450e9  # B/s
