"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version:
  consensus        eq. (6) consensus: one agent, the whole network, masked
                   gossip windows, CSR tables; the payload-validity check
  gauss_vi         fused Bayes-by-Backprop sample + KL
  flash_attention  blocked causal / sliding-window attention
``ops`` wraps them over parameter pytrees; ``ref`` holds the oracles."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
