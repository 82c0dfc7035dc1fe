"""Granite-20B code model [arXiv:2405.04324]: 52L, d_model 6144, 48 heads
with multi-query attention (kv=1), d_ff 24576, vocab 49152."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    pattern=("attn",),
    source="arXiv:2405.04324",
    long_context_ok=True,  # via SWA window_override
)
