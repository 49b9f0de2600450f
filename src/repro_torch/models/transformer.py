"""Decoder-only transformer of the dense family (stablelm, h2o-danube):
the counterpart of ``repro/models/transformer.py`` for configs whose
every layer has the same cache geometry (attention kind ``full`` or
``swa``).

Parameters keep the JAX tree: ``embed/table``, ``lm_head/w``,
``final_norm``, and ``layers/...`` with a leading layer axis.  A python
loop over the layers replaces ``lax.scan``; caches are stacked along the
same leading axis and written in place (see ``models/attention.py``).
MoE, ``lead/`` dense layers, ``local_global`` and ``rope_theta == 0``
are not ported yet (ROADMAP.md) and raise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import ParamInit, to_dtype
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       init_embedding, init_mlp, init_norm,
                                       logits_from_hidden)
from repro_torch.models.rope import rope_frequencies

FULL_WINDOW = 1 << 30
Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE layers {attn.NOT_PORTED}")
    if cfg.attention.rope_theta == 0.0:
        raise NotImplementedError(
            f"sinusoidal positions (rope_theta == 0) {attn.NOT_PORTED}")
    if cfg.attention.kind not in ("full", "swa"):
        raise NotImplementedError(
            f"attention kind {cfg.attention.kind!r} {attn.NOT_PORTED}")
    attn.check_supported(cfg.attention)


def layer_window(cfg: ModelConfig) -> int:
    """The window every layer masks with (``FULL_WINDOW``: none)."""
    a = cfg.attention
    if a.kind == "swa" or (a.kind == "full" and a.window):
        return a.window
    return FULL_WINDOW


def cache_capacity(cfg: ModelConfig, max_len: int) -> int:
    w = layer_window(cfg)
    return min(max_len, w) if w != FULL_WINDOW else max_len


def _inv_freq(cfg: ModelConfig, device) -> torch.Tensor:
    a = cfg.attention
    return torch.from_numpy(rope_frequencies(
        a.head_dim, a.rope_theta, a.rope_fraction)).to(device)


def _layer(params: Params, i: int) -> Params:
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[i]
    return take(params["layers"])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> Params:
    """Fresh parameters in ``cfg.param_dtype``; ``generator`` is a CPU
    generator, and each leaf is drawn on the host and moved to ``device``
    before the next (``models/common.py``)."""
    check_supported(cfg)
    pi = ParamInit(generator, to_dtype(cfg.param_dtype),
                   resolve_device(device))
    L = cfg.num_layers
    init_embedding(pi, cfg)
    init_norm(pi, "layers/ln1", cfg.d_model, cfg.norm, stack=L)
    attn.init_gqa(pi, "layers/attn", cfg.d_model, cfg.attention, stack=L)
    init_norm(pi, "layers/ln2", cfg.d_model, cfg.norm, stack=L)
    init_mlp(pi, "layers/mlp", cfg.d_model, cfg.d_ff, cfg.act, stack=L)
    init_norm(pi, "final_norm", cfg.d_model, cfg.norm)
    return pi.params


def _mlp_block(cfg, p, x):
    h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg.act)


def _head(params, cfg, x):
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (logits (B,S,V), aux loss 0)."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    inv_freq, window = _inv_freq(cfg, x.device), layer_window(cfg)
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        x = x + attn.gqa_forward(p["attn"], cfg.attention, h, positions,
                                 inv_freq, window=window)
        x = _mlp_block(cfg, p, x)
    return _head(params, cfg, x), x.new_zeros((), dtype=torch.float32)


# ---------------------------------------------------------------------------
# dense ring cache: prefill + decode
# ---------------------------------------------------------------------------

def _stacked(make, n: int):
    """A cache NamedTuple whose leaves gain a leading layer axis."""
    per = [make() for _ in range(n)]
    return type(per[0])(*(torch.stack(xs) for xs in zip(*per)))


def _at(cache, i: int):
    """Layer ``i`` of a stacked cache, as views (writes go through)."""
    return type(cache)(*(x[i] for x in cache))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None):
    """{"lead": {}, "layers": KVCache with a leading layer axis}."""
    check_supported(cfg)
    dtype = dtype or to_dtype(cfg.dtype)
    a, dev = cfg.attention, resolve_device(device)
    cap = cache_capacity(cfg, max_len)
    return {"lead": {}, "layers": _stacked(
        lambda: attn.init_kv_cache(batch, cap, a.num_kv_heads, a.head_dim,
                                   dtype, dev), cfg.num_layers)}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache,
            length: Optional[int] = None):
    """One-shot prefill: the full-sequence pass of :func:`forward`, and
    every layer writes its KV cache for positions ``[0, length)`` in one
    scatter.  ``tokens`` (B,S) may be right-padded beyond ``length``;
    returns (logits (B,S,V), cache ready for decode at ``length``)."""
    check_supported(cfg)
    length = tokens.shape[1] if length is None else int(length)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    inv_freq, window = _inv_freq(cfg, x.device), layer_window(cfg)
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        y, _ = attn.gqa_prefill(p["attn"], cfg.attention, h, positions,
                                length, _at(cache["layers"], i), inv_freq,
                                window=window)
        x = _mlp_block(cfg, p, x + y)
    return _head(params, cfg, x), cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                pos: torch.Tensor, cache):
    """tokens (B,1); pos () or (B,) absolute position of each row.
    Returns (logits (B,1,V), cache)."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    inv_freq, window = _inv_freq(cfg, x.device), layer_window(cfg)
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        y, _ = attn.gqa_decode(p["attn"], cfg.attention, h, pos,
                               _at(cache["layers"], i), inv_freq,
                               window=window)
        x = _mlp_block(cfg, p, x + y)
    return _head(params, cfg, x), cache


# ---------------------------------------------------------------------------
# paged cache: prefill + decode
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype=None, device: DeviceLike = None):
    """Paged cache for every layer, stacked along a leading layer axis
    and indexed by the same pool-issued page ids."""
    check_supported(cfg)
    dtype = dtype or to_dtype(cfg.dtype)
    a, dev = cfg.attention, resolve_device(device)
    return {"lead": {}, "layers": _stacked(
        lambda: attn.init_paged_kv_cache(num_pages, page_size,
                                         a.num_kv_heads, a.head_dim, dtype,
                                         dev), cfg.num_layers)}


def paged_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  cache, block_tables: torch.Tensor,
                  length: Optional[int] = None):
    """One-shot prefill through the block table: the math of
    :func:`prefill`, cache writes scattered into pool pages.  ``tokens``
    (B,S) right-padded past ``length``; ``block_tables`` (B,
    pages_per_seq) pool page ids.  Returns (logits (B,S,V), cache)."""
    check_supported(cfg)
    length = tokens.shape[1] if length is None else int(length)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    inv_freq, window = _inv_freq(cfg, x.device), layer_window(cfg)
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        y, _ = attn.paged_gqa_prefill(p["attn"], cfg.attention, h,
                                      positions, length,
                                      _at(cache["layers"], i), block_tables,
                                      inv_freq, window=window)
        x = _mlp_block(cfg, p, x + y)
    return _head(params, cfg, x), cache


def paged_decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      pos: torch.Tensor, cache, block_tables: torch.Tensor):
    """Batched paged decode: one pass advances every row.  ``tokens``
    (B,1); ``pos`` (B,) per-row positions (free rows point their block
    table at the scratch page).  Returns (logits (B,1,V), cache)."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    inv_freq, window = _inv_freq(cfg, x.device), layer_window(cfg)
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        y, _ = attn.paged_gqa_decode(p["attn"], cfg.attention, h, pos,
                                     _at(cache["layers"], i), block_tables,
                                     inv_freq, window=window)
        x = _mlp_block(cfg, p, x + y)
    return _head(params, cfg, x), cache
