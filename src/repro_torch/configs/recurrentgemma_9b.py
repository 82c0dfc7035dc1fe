"""RecurrentGemma-9B / Griffin [arXiv:2402.19427]: 38 blocks, d_model 4096,
16 heads (MQA kv=1), d_ff 12288, vocab 256000.  Pattern 2 recurrent
(RG-LRU) : 1 local attention (window 2048) — 12 periods + (rglru, rglru)
tail.  Hybrid: native sub-quadratic long context."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local_attn"),
    sliding_window=2048,
    tie_embeddings=True,  # Gemma family ties input/output embeddings
    source="arXiv:2402.19427",
    long_context_ok=True,  # native (RG-LRU state + windowed attention)
)
