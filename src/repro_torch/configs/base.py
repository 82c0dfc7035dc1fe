"""Architecture config system (a copy of ``repro.configs.base``: plain
dataclasses, so the port needs no JAX to read a config).

A ``ModelConfig`` fully describes one architecture from the assigned pool.
Layers are organized as ``n_periods`` repetitions of ``pattern`` (a tuple of
block kinds) plus an optional ``tail`` (pattern remainder), with per-kind
parameter stacks ``[n_periods, c_kind, ...]``; the port's layer loop walks
the periods in Python (``models.transformer``).

Block kinds:
  attn        pre-norm GQA attention (+qk-norm, +RoPE) + SwiGLU MLP
  local_attn  same but sliding-window attention
  moe         pre-norm GQA attention + top-k mixture-of-experts FFN
  mlstm       xLSTM matrix-memory block (chunkwise-parallel recurrence)
  slstm       xLSTM scalar-memory block (sequential scan)
  rglru       RecurrentGemma recurrent block (conv1d + RG-LRU) + MLP
  enc_attn    bidirectional encoder attention + MLP (whisper encoder)
  dec_attn    causal self-attn + cross-attn + MLP (whisper decoder)
"""
from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple[str, ...] = ("attn",)
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- attention options ---
    qk_norm: bool = False
    sliding_window: int = 0  # 0 = full; >0 = window size for local_attn
    rope_theta: float = 10000.0
    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper: 1500 frames after conv frontend
    # --- modality frontend stubs ---
    frontend: str = "none"  # none | audio_stub | vision_stub
    n_patches: int = 0  # vlm: image patch embeddings per sample
    # --- numerics ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"
    # --- framework integration ---
    source: str = ""  # paper / model-card citation
    long_context_ok: bool = True  # may run long_500k (sub-quadratic path)
    long_context_window: int = 4096  # SWA window used for long_500k decode
    tie_embeddings: bool = False

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail(self) -> tuple[str, ...]:
        """Pattern remainder when n_layers % len(pattern) != 0."""
        r = self.n_layers % len(self.pattern)
        return self.pattern[:r]

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def kind_counts(self) -> dict[str, int]:
        """Block-kind -> count per period."""
        counts: dict[str, int] = {}
        for k in self.pattern:
            counts[k] = counts.get(k, 0) + 1
        return counts

    def validate(self) -> None:
        assert self.d_model % self.n_heads == 0 or self.head_dim, self.name
        assert self.n_heads % self.n_kv_heads == 0, self.name
        if self.n_experts:
            assert self.top_k > 0 and "moe" in self.pattern, self.name
        assert self.n_periods * len(self.pattern) + len(self.tail) == self.n_layers

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: 2 layers (1 period of a truncated pattern or
        2 periods of single-kind), d_model<=256, <=4 experts."""
        kinds = list(dict.fromkeys(self.pattern))  # preserve kind coverage
        pattern = tuple(kinds[:2]) if len(kinds) >= 2 else (kinds[0],) * 2
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % kv:
            kv -= 1
        base = dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=len(pattern),
            pattern=pattern,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=kv,
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16),
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            long_context_window=64,
        )
        base = dataclasses.replace(base, **overrides)
        base.validate()
        return base


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
