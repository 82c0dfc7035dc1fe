"""xLSTM-1.3B [arXiv:2405.04517]: 48 blocks, d_model 2048, 4 heads,
d_ff 0 (blocks carry their own 2x up-projection), vocab 50304.
Pattern: 7 mLSTM (matrix memory) : 1 sLSTM (scalar memory) per period —
6 periods of 8 blocks.  Attention-free: native sub-quadratic long context."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm",) * 7 + ("slstm",),
    source="arXiv:2405.04517",
    long_context_ok=True,  # native (O(1) recurrent state)
)
