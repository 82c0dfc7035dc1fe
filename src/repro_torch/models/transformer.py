"""Composable transformer assembly (port of ``repro.models.transformer``:
the block kinds ``attn``, ``local_attn``, ``moe``, ``rglru``, ``mlstm``,
``slstm``, ``enc_attn`` and ``dec_attn``, and the ``audio_stub`` /
``vision_stub`` frontends).

An architecture is ``n_periods`` repetitions of ``cfg.pattern`` (+ a tail
remainder).  Per-kind parameter stacks carry leaves ``[n_periods, c_kind,
...]``; where the reference runs one ``lax.scan`` over periods, the port
loops over the periods in Python and hands each block views of its stacks.
Caches (KV ``[n_periods, c_kind, B, capacity, kv, hd]``, recurrent states
``[n_periods, c_kind, B, ...]``) are updated in place through the same
views: attention writes its KV slots, a recurrent block copies its new
state into the views it was handed.  Recurrent states stay fp32 whatever
the KV dtype, as the reference's ``*_state_init`` make them.

Agent axis: a tree whose leaves carry one more leading axis ``A``
(``launch.steps``' agent-stacked params and caches) runs all agents in one
pass over ``tokens [A, B, S]``; matmuls take ``[A, rows, D] @ [A, D, F]``,
attention folds A into its batch (so each kernel launches once for every
agent), and the MoE dispatch batches over A with each agent's own
capacity.  A tree without it is one agent's.

Encoder-decoder (Whisper): ``enc_stack`` leaves ``[encoder_layers, 1,
...]`` run as ``encoder_layers`` periods of one ``enc_attn`` block
(non-causal, no RoPE) over ``frames [*A, B, F, D]`` plus a sinusoid, then
``enc_norm``; each ``dec_attn`` block adds causal self-attention without
RoPE over its KV cache and cross-attention over that encoder output.  A
decode step runs the whole encoder again, as the reference's does.  The
vision stub (Pixtral) prepends ``patches [*A, B, P, D] @ patch_proj.w`` to
the token embeddings; positions count the patches.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.tree import tree_leaves, tree_map, tree_replace_leaves
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import attention_block, attn_init, init_kv_cache
from repro_torch.models.modules import (
    embed,
    embed_init,
    matmul,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
    truncated_normal_init,
    unembed,
)
from repro_torch.models.rglru import rglru_block, rglru_init, rglru_state_init
from repro_torch.models.xlstm import (
    mlstm_block,
    mlstm_init,
    mlstm_state_init,
    slstm_block,
    slstm_init,
    slstm_state_init,
)

PyTree = Any

ATTN_KINDS = ("attn", "local_attn", "moe", "enc_attn", "dec_attn")


# ---------------------------------------------------------------------------
# per-kind init / apply / cache
# ---------------------------------------------------------------------------


def block_init(generator, kind: str, cfg, *, dtype=torch.float32, device=None, lead=()):
    kw = dict(dtype=dtype, device=device, lead=lead)
    if kind in ATTN_KINDS:
        p = {
            "norm1": rmsnorm_init(cfg.d_model, **kw),
            "attn": attn_init(generator, cfg, **kw),
            "norm2": rmsnorm_init(cfg.d_model, **kw),
        }
        if kind == "moe":
            p["moe"] = moe_lib.moe_init(generator, cfg, **kw)
        else:
            p["mlp"] = swiglu_init(generator, cfg.d_model, cfg.d_ff, **kw)
        if kind == "dec_attn":
            p["norm_x"] = rmsnorm_init(cfg.d_model, **kw)
            p["xattn"] = attn_init(generator, cfg, cross=True, **kw)
        return p
    if kind == "mlstm":
        return mlstm_init(generator, cfg, **kw)
    if kind == "slstm":
        return slstm_init(generator, cfg, **kw)
    if kind == "rglru":
        return {
            "rec": rglru_init(generator, cfg, **kw),
            "norm2": rmsnorm_init(cfg.d_model, **kw),
            "mlp": swiglu_init(generator, cfg.d_model, cfg.d_ff, **kw),
        }
    raise ValueError(f"unknown block kind {kind!r}")


def block_cache_init(kind: str, cfg, batch: int, capacity: int, dtype=torch.bfloat16,
                     device=None, lead=()):
    """Decode-time cache for one layer of ``kind`` (``lead`` axes first).
    ``dtype`` is the KV cache's; recurrent states are fp32."""
    if kind in ("attn", "moe", "dec_attn"):
        return init_kv_cache(cfg, batch, capacity, dtype, device, lead)
    if kind == "local_attn":
        cap = min(capacity, cfg.sliding_window or capacity)
        return init_kv_cache(cfg, batch, cap, dtype, device, lead)
    if kind == "mlstm":
        return mlstm_state_init(cfg, batch, device=device, lead=lead)
    if kind == "slstm":
        return slstm_state_init(cfg, batch, device=device, lead=lead)
    if kind == "rglru":
        return rglru_state_init(cfg, batch, device=device, lead=lead)
    raise ValueError(kind)


def block_apply(kind: str, params, x, cfg, *, positions, cache=None, enc_out=None,
                window_override: int | None = None):
    """Returns (x', cache, aux_loss): the cache written in place (a
    recurrent kind without one returns its new state), aux the router's
    loss ``[*A]`` for ``moe`` and a 0-d zero otherwise.  ``enc_out``: the
    encoder's output ``[*A, B, F, D]``, which ``dec_attn`` cross-attends."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ATTN_KINDS:
        window = cfg.sliding_window if kind == "local_attn" else 0
        if window_override is not None and kind in ("attn", "local_attn"):
            window = window_override
        h = rmsnorm(params["norm1"], x, cfg.norm_eps)
        y, cache = attention_block(params["attn"], h, cfg, causal=kind != "enc_attn",
                                   window=window, positions=positions, cache=cache,
                                   use_rope=kind not in ("enc_attn", "dec_attn"))
        x = x + y
        if kind == "dec_attn":
            hx = rmsnorm(params["norm_x"], x, cfg.norm_eps)
            yx, _ = attention_block(params["xattn"], hx, cfg, causal=False, positions=positions,
                                    cross_x=enc_out, use_rope=False)
            x = x + yx
        h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
        if kind == "moe":
            y2, aux = moe_lib.moe_ffn(params["moe"], h2, cfg)
        else:
            y2 = swiglu(params["mlp"], h2, x.dtype)
        return x + y2, cache, aux
    if kind == "mlstm":
        y, new_state = mlstm_block(params, x, cfg, state=cache)
    elif kind == "slstm":
        y, new_state = slstm_block(params, x, cfg, state=cache)
    elif kind == "rglru":
        y, new_state = rglru_block(params["rec"], x, cfg, state=cache)
        h2 = rmsnorm(params["norm2"], y, cfg.norm_eps)
        y = y + swiglu(params["mlp"], h2, x.dtype)
    else:
        raise ValueError(kind)
    if cache is None:
        return y, new_state, aux
    for name, value in new_state.items():  # the layer loop keeps the views it handed out
        cache[name].copy_(value)
    return y, cache, aux


# ---------------------------------------------------------------------------
# whole-model init
# ---------------------------------------------------------------------------


def init_params(cfg, generator: torch.Generator | None = None, *, device=None,
                dtype=torch.float32) -> PyTree:
    """Draw the model's parameters from ``generator`` on ``device`` (the
    card unless ``device="cpu"``).  Leaves are drawn in float32 and cast to
    ``dtype`` one at a time: ``dtype=torch.bfloat16`` gives
    ``launch.steps.serve_params``' bf16 weights without a full f32 copy."""
    from repro_torch.kernels.dispatch import resolve_device

    cfg.validate()
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    params: dict = {"embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": truncated_normal_init(
            generator, (cfg.d_model, cfg.padded_vocab), 1.0, dtype, dev)}
    params["final_norm"] = rmsnorm_init(cfg.d_model, **kw)
    params["stacks"] = {
        kind: block_init(generator, kind, cfg, lead=(cfg.n_periods, c), **kw)
        for kind, c in cfg.kind_counts().items() if cfg.n_periods * c
    }
    if cfg.tail:
        params["tail"] = [block_init(generator, kind, cfg, **kw) for kind in cfg.tail]
    if cfg.is_encdec:
        params["enc_stack"] = block_init(generator, "enc_attn", cfg,
                                         lead=(cfg.encoder_layers, 1), **kw)
        params["enc_norm"] = rmsnorm_init(cfg.d_model, **kw)
    if cfg.frontend == "vision_stub":
        params["patch_proj"] = {"w": truncated_normal_init(
            generator, (cfg.d_model, cfg.d_model), 1.0, dtype, dev)}
    return params


def init_cache(cfg, batch: int, capacity: int, dtype=torch.bfloat16, device=None,
               n_agents: int | None = None) -> PyTree:
    """Stacked decode caches matching the layer loop's layout; with
    ``n_agents`` every leaf gets a leading agent axis."""
    from repro_torch.kernels.dispatch import resolve_device

    dev = resolve_device(device)
    agents = () if n_agents is None else (n_agents,)
    cache: dict = {"stacks": {
        kind: block_cache_init(kind, cfg, batch, capacity, dtype, dev, agents + (cfg.n_periods, c))
        for kind, c in cfg.kind_counts().items() if cfg.n_periods
    }}
    if cfg.tail:
        cache["tail"] = [block_cache_init(kind, cfg, batch, capacity, dtype, dev, agents)
                         for kind in cfg.tail]
    return cache


def params_from_numpy(tree, device=None) -> PyTree:
    """The reference's ``init_params`` tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``: dicts, lists, stacks
    ``[n_periods, c, ...]``) -> the port's tree of tensors on ``device``,
    leaf for leaf, bit for bit (bf16 leaves too).  ``device=None`` is the
    card, as for every entry point of the port."""
    from repro_torch.kernels.dispatch import resolve_device

    dev = resolve_device(device)

    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: move the bits
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a.copy()).to(dev)

    return tree_replace_leaves(tree, [t(a) for a in tree_leaves(tree)])


def params_to_numpy(params) -> PyTree:
    """The inverse of ``params_from_numpy`` for float32 and integer leaves;
    a bf16 leaf comes back widened to float32 (exact), since the port does
    not use ml_dtypes."""

    def n(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return tree_map(n, params)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _index(tree, i, lead: int):
    """Views of every leaf at index ``i`` of the axis after ``lead`` agent axes."""
    return tree_map(lambda a: a[(slice(None),) * lead + (i,)], tree)


def _sinusoidal(positions, d_model: int) -> torch.Tensor:
    """``[S, d_model]`` fp32 sinusoid (sin half, then cos half) of
    ``positions [S]``, in the reference's order of fp32 operations."""
    half = d_model // 2
    log_base = torch.log(torch.tensor(10000.0, device=positions.device))  # fp32, as jnp.log
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                      * log_base / half)
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _apply_period(cfg, pattern, stacks_slice, x, positions, cache_slice, enc_out=None,
                  window_override=None, lead: int = 0):
    """Apply one period's blocks.  ``stacks_slice`` / ``cache_slice`` leaves
    are ``[*A, c_kind, ...]`` (``lead`` agent axes); returns (x, aux)."""
    offsets: dict[str, int] = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind in pattern:
        o = offsets.get(kind, 0)
        offsets[kind] = o + 1
        c = _index(cache_slice[kind], o, lead) if cache_slice is not None else None
        x, _, a = block_apply(kind, _index(stacks_slice[kind], o, lead), x, cfg,
                              positions=positions, cache=c, enc_out=enc_out,
                              window_override=window_override)
        aux = aux + a
    return x, aux


def _periods(cfg, pattern, stacks, n_periods, x, positions, cache_stacks, enc_out,
             window_override, lead, remat):
    """The layer loop: ``n_periods`` periods of ``pattern`` over ``stacks``
    (leaves ``[*A, n_periods, c_kind, ...]``), each under
    ``torch.utils.checkpoint`` with ``remat``.  Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in range(n_periods):
        args = (cfg, pattern, _index(stacks, p, lead), x, positions,
                _index(cache_stacks, p, lead) if cache_stacks is not None else None,
                enc_out, window_override, lead)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(_apply_period, *args, use_reentrant=False)
        else:
            x, a = _apply_period(*args)
        aux = aux + a
    return x, aux


def encode(params: PyTree, cfg, frames: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """The encoder of an enc-dec config: ``frames [*A, B, F, D]`` plus the
    sinusoid at 0..F-1, ``encoder_layers`` non-causal ``enc_attn`` blocks
    (``enc_stack``), then ``enc_norm``; ``[*A, B, F, D]`` in the compute
    dtype.  ``remat`` as ``forward``'s."""
    dt = getattr(torch, cfg.dtype)
    lead = params["embed"]["emb"].ndim - 2
    fpos = torch.arange(frames.shape[-2], device=frames.device)
    ex = frames.to(dt) + _sinusoidal(fpos, cfg.d_model).to(dt)
    ex, _ = _periods(cfg, ("enc_attn",), {"enc_attn": params["enc_stack"]}, cfg.encoder_layers,
                     ex, fpos, None, None, None, lead,
                     remat and torch.is_grad_enabled())
    return rmsnorm(params["enc_norm"], ex, cfg.norm_eps)


def forward(params: PyTree, cfg, tokens: torch.Tensor, *, positions=None, cache=None,
            frames=None, patches=None, window_override: int | None = None,
            logits_tail: int = 0, remat: bool = False):
    """Returns (logits ``[*A, B, S, padded_vocab]`` fp32, cache, aux_loss).

    ``tokens [*A, B, S_text]``; ``positions [S]`` absolute positions
    (default ``0..S-1``, S counting the patches).  ``frames [*A, B, F, D]``:
    the audio stub's frame embeddings, which an enc-dec config needs (the
    encoder runs over them on every call).  ``patches [*A, B, P, D]``: the
    vision stub's patch embeddings, projected and prepended to the tokens'
    (logits cover ``[patches; text]``).  ``window_override``: force a
    sliding window on ``attn`` / ``local_attn`` kinds (the dense-arch
    long-context SWA variant; ``moe`` keeps full attention, as in the
    reference).  ``logits_tail``: if > 0, unembed only the last
    ``logits_tail`` positions (prefill returns next-token logits without
    materializing [S, V]).  A ``cache`` is written in place and returned;
    its recurrent states are the initial states (zero without a cache).

    ``aux_loss`` is fp32 of shape ``[*A]``: for each agent the sum over its
    ``moe`` layers of the router's load-balancing loss, each agent's equal
    to the reference's scalar for that agent's model alone (0-d for a tree
    without an agent axis; zeros without ``moe`` layers).

    ``remat``: where autograd records the forward (no cache), each period
    (the encoder's too) runs under ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward pass
    instead of kept, as the reference ``jax.checkpoint``s its scan body.
    The same ops run twice, so the values and gradients are the same
    bits."""
    dt = getattr(torch, cfg.dtype)
    lead = params["embed"]["emb"].ndim - 2  # 1 for an agent-stacked tree
    x = embed(params["embed"], tokens, dt)
    if cfg.frontend == "vision_stub" and patches is not None:
        x = torch.cat([matmul(patches.to(dt), params["patch_proj"]["w"].to(dt)), x], dim=-2)
    if positions is None:
        positions = torch.arange(x.shape[-2], device=x.device)
    positions = torch.as_tensor(positions, device=x.device).reshape(-1)
    remat = remat and cache is None and torch.is_grad_enabled()

    enc_out = None
    if cfg.is_encdec:
        if frames is None:
            raise ValueError(f"{cfg.name}: an enc-dec model needs frame embeddings")
        enc_out = encode(params, cfg, frames, remat)
        x = x + _sinusoidal(positions, cfg.d_model).to(dt)

    x, a = _periods(cfg, cfg.pattern, params["stacks"], cfg.n_periods, x, positions,
                    cache["stacks"] if cache is not None else None, enc_out, window_override,
                    lead, remat)
    aux = torch.zeros(tuple(tokens.shape[:lead]), dtype=torch.float32, device=x.device) + a
    for i, kind in enumerate(cfg.tail):
        c = cache["tail"][i] if cache is not None else None
        x, _, a = block_apply(kind, params["tail"][i], x, cfg, positions=positions, cache=c,
                              enc_out=enc_out, window_override=window_override)
        aux = aux + a

    if logits_tail:
        x = x[..., -logits_tail:, :]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, dt)
    else:
        logits = matmul(x, params["lm_head"]["w"].to(dt)).float()
    return logits, cache, aux


def nll_loss(params, cfg, batch, remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Total next-token NLL (summed over tokens) + aux (the router's loss,
    ``forward``'s; 0 without ``moe`` layers), each ``[*A]``: one value an
    agent of an agent-stacked tree (0-d for one model's).  ``batch``:
    dict(tokens, targets[, loss_mask, frames, patches]), ``[*A, B, S]``.
    Where the targets are shorter than the logits (a VLM's logits cover
    ``[patches; text]``), only the logits' text tail is scored."""
    logits, _, aux = forward(params, cfg, batch["tokens"], frames=batch.get("frames"),
                             patches=batch.get("patches"), remat=remat)
    targets = batch["targets"]
    if logits.shape[-2] != targets.shape[-1]:
        logits = logits[..., logits.shape[-2] - targets.shape[-1]:, :]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    if mask is not None:
        nll = nll * mask
    lead = params["embed"]["emb"].ndim - 2
    return torch.sum(nll.reshape(tuple(nll.shape[:lead]) + (-1,)), dim=-1), aux


def decode_step(params: PyTree, cfg, token: torch.Tensor, position, cache: PyTree,
                enc_out_frames=None, window_override: int | None = None):
    """One-token autoregressive step against the cache: ``token [*A, B, 1]``
    at absolute ``position`` (an int or a 0-d tensor).  An enc-dec config
    takes ``enc_out_frames [*A, B, F, D]`` and runs its whole encoder over
    them again, as the reference's step does.  Returns (logits
    ``[*A, B, 1, V]``, cache)."""
    if not isinstance(position, torch.Tensor):  # made on the card: no host copy to wait for
        position = torch.full((1,), int(position), dtype=torch.long,
                              device=params["embed"]["emb"].device)
    logits, cache, _ = forward(params, cfg, token, positions=position.reshape(1),
                               cache=cache, frames=enc_out_frames,
                               window_override=window_override)
    return logits, cache
