"""DeepSeek-LLM-7B [arXiv:2401.02954]: llama-arch, 30L, d_model 4096,
32 heads (MHA: kv=32), d_ff 11008, vocab 102400."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    pattern=("attn",),
    source="arXiv:2401.02954",
    long_context_ok=True,  # via SWA window_override
)
