"""PyTorch/CUDA port of the decentralized Bayesian learning system.

The JAX package ``repro`` is the reference; this package reproduces it module
by module under the same names, with hand-written CUDA kernels for NVIDIA
Hopper (``kernels/csrc``) in place of the Pallas TPU kernels.  It imports
``torch`` and ``numpy`` only.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
