"""Whisper-tiny [arXiv:2212.04356]: encoder-decoder, 4+4 layers, d_model 384,
6 heads, d_ff 1536, vocab 51865.  The mel-spectrogram + conv frontend is a
STUB per the assignment: input_specs() provides precomputed frame embeddings
[B, 1500, 384].  long_500k is SKIPPED (full-attention enc-dec; the model
family's input is <=30 s of audio = 1500 frames — see DESIGN.md §5)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,  # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    pattern=("dec_attn",),
    encoder_layers=4,
    encoder_seq=1500,
    frontend="audio_stub",
    source="arXiv:2212.04356",
    long_context_ok=False,  # skip long_500k (documented in DESIGN.md)
)
