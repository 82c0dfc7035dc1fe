"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]: Pixtral-ViT vision encoder +
Mistral-Nemo-12B decoder (40L, d_model 5120, 32 heads GQA kv=8, head_dim 128,
d_ff 14336, vocab 131072).  The ViT encoder + projector is a STUB per the
assignment: input_specs() provides precomputed patch embeddings
[B, 256, 5120] that are projected and prepended to the token sequence."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    pattern=("attn",),
    head_dim=128,
    rope_theta=1_000_000.0,
    frontend="vision_stub",
    n_patches=256,
    source="hf:mistralai/Pixtral-12B-2409",
    long_context_ok=True,  # via SWA window_override on the decoder
)
