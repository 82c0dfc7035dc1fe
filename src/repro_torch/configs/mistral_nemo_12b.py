"""Mistral-Nemo-Base-2407 [hf:mistralai/Mistral-Nemo-Base-2407]: 40L,
d_model 5120, 32 heads (GQA kv=8, head_dim 128), d_ff 14336, vocab 131072,
128k context."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    pattern=("attn",),
    head_dim=128,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    long_context_ok=True,  # via SWA window_override
)
