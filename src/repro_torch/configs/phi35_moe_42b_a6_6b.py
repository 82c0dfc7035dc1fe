"""Phi-3.5-MoE-instruct [hf:microsoft/Phi-3.5-MoE-instruct]: 32L, d_model
4096, 32 heads (GQA kv=8), expert d_ff 6400, vocab 32064, 16 experts top-2
(42B total / 6.6B active)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    pattern=("moe",),
    n_experts=16,
    top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    long_context_ok=True,  # via SWA window_override
)
