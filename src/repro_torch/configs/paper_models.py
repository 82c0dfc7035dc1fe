"""The paper's own model configurations.

* ``bayes_mlp``: the 2x200-unit fully-connected ReLU network the paper uses
  for MNIST/FMNIST (same architecture as FedAvg [8]) — trained as a
  mean-field Bayesian NN via Bayes-by-Backprop.
* ``repro_100m``: a ~100M decoder-only transformer for the end-to-end
  decentralized-training example (examples/train_decentralized_lm.py).
"""
from repro_torch.configs.base import ModelConfig

# the ~100M end-to-end training example (examples/)
REPRO_100M = ModelConfig(
    name="repro-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=32768,
    pattern=("attn",),
    source="paper-scale example (this repo)",
)

# paper MLP: 2 hidden layers, 200 units, ReLU (McMahan et al. architecture)
PAPER_MLP_HIDDEN = 200
PAPER_MLP_LAYERS = 2
