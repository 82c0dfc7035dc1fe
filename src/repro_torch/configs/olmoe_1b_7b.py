"""OLMoE-1B-7B [arXiv:2409.02060]: 16L, d_model 2048, 16 heads (kv=16),
expert d_ff 1024, vocab 50304, 64 experts top-8 (1B active / 7B total)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    pattern=("moe",),
    n_experts=64,
    top_k=8,
    qk_norm=True,  # OLMoE uses QK-norm
    source="arXiv:2409.02060",
    long_context_ok=True,  # via SWA window_override (noted in DESIGN.md)
)
