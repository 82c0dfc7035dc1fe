"""The work a round needs, counted from shapes: operations and bytes of
the algorithm, not of the implementation (each input byte read once, each
output byte written once).  Frozen here, with the source of each formula,
so that a change to the program cannot move the yardstick.

Sources: the eq. (6) byte rows of the kernel table in ``PERF.md`` (row
1: ``16 N P + 4 N^2 + N`` dense; row 9: the source rows read, the rows
written and the terms on an edge list), the port's byte models in
``launch/costmodel.py`` (``flat_fused``), and the usual ``6 x
parameters`` FLOPs of a dense layer's forward and backward per sample or
token.
"""
from __future__ import annotations

ADAM_BUFFERS = 6  # posterior mean and rho, Adam's first and second moments of each


def mlp_weights(config: dict) -> int:
    """Multiply-add weights of the MLP (biases are not products)."""
    sizes = [config["dim"]] + [config["hidden"]] * config["depth"] + [config["n_classes"]]
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def mlp_train_flops(config: dict, samples: int) -> float:
    """Forward and backward of ``samples`` samples: 2 FLOPs a weight forward,
    4 backward (the input's and the weight's gradient)."""
    return 6.0 * mlp_weights(config) * samples


def posterior_adam_bytes(agents: int, p: int) -> float:
    """Each f32 posterior and Adam buffer of ``agents`` agents read once and
    written once."""
    return 2.0 * ADAM_BUFFERS * agents * p * 4


def eq6_dense_bytes(n: int, p: int) -> float:
    """Eq. (6) over a dense W: every (mean, rho) row read once and written
    once (16 N P), W read once (4 N^2), the activity mask (N)."""
    return 16.0 * n * p + 4.0 * n * n + n


def eq6_edges_bytes(p: int, rows_read: int, rows_written: int, edges: int) -> float:
    """Eq. (6) over one window's edge list: only the rows that take part
    move.  Each (mean, rho) row that is read (the kept edges' sources and
    the rows that merge, each once) and each row that merges written once
    (8 P bytes a row either way), each kept edge its source index and
    weight (8 bytes), each merging row its self weight and index (8 bytes).
    A row that neither sends nor merges is neither read nor written."""
    return 8.0 * p * (rows_read + rows_written) + 8.0 * (edges + rows_written)


def lm_matmul_params(config: dict) -> int:
    """Weights that multiply a token's activations in a dense pre-norm
    decoder with SwiGLU: q, k, v, o and the three MLP matrices a layer, and
    the output head (the embedding is a lookup)."""
    d, hd = config["d_model"], config["d_model"] // config["n_heads"]
    attn = d * config["n_heads"] * hd * 2 + d * config["n_kv_heads"] * hd * 2
    mlp = 3 * d * config["d_ff"]
    return config["n_layers"] * (attn + mlp) + d * config["vocab_size"]


def lm_train_flops(config: dict, sequences: int, seq_len: int) -> float:
    """Forward and backward of ``sequences`` sequences of ``seq_len``
    tokens: 6 FLOPs a matmul weight a token, and causal attention's two
    products (QK^T and PV, 2 FLOPs a multiply-add each) over the keys at or
    before each query, times 3 for the backward."""
    tokens = sequences * seq_len
    d = config["n_heads"] * (config["d_model"] // config["n_heads"])
    pairs = sequences * seq_len * (seq_len + 1) / 2  # causal (query, key) pairs
    attention = 3 * 4.0 * d * pairs * config["n_layers"]
    return 6.0 * lm_matmul_params(config) * tokens + attention
