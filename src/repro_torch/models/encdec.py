"""Whisper-style encoder-decoder backbone [arXiv:2212.04356] of the audio
family: the counterpart of ``repro/models/encdec.py``.

As in the reference, the mel-spectrogram and conv frontend is a stub:
the encoder takes precomputed frame embeddings (B, F, d).  Both sides
add sinusoidal positions (``transformer.sinusoidal_positions``) and
neither rotates.  The parameter tree is JAX's key for key:
``embed/table``, ``encoder/{ln1, attn, ln2, mlp}`` and ``decoder/{ln1,
self_attn, ln_x, cross_attn, ln2, mlp}`` with a leading layer axis,
``enc_norm`` and ``final_norm``.  Python loops over the layers replace
``lax.scan``.

On the card every attention runs in the port's kernels: the encoder's
non-causal self-attention over the F frames, the decoder's causal
self-attention and its cross attention from S tokens to F frames in
``ops.flash_attention``, and the decode step's self-attention over its
ring and cross attention over the F precomputed rows in
``ops.decode_attention``.  The cache ``{"self": KVCache with a leading
layer axis, "cross_k", "cross_v": (L, B, F, Hkv, D)}`` is written in
place; :func:`prime_cross_cache` fills the cross rows from an encoder
output (a fresh cache holds zeros, which the serving engine attends to,
as the JAX engine does).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamInit, checkpointed,
                                       layer_slice, to_dtype)
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       init_embedding, init_mlp, init_norm,
                                       logits_from_hidden)
from repro_torch.models.transformer import (_at, _stacked,
                                            sinusoidal_positions)

Params = Dict[str, Any]


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None,
                with_axes: bool = False) -> Params:
    """Fresh parameters in ``cfg.param_dtype``, each leaf drawn where
    ``generator`` lives and moved to ``device`` before the next."""
    pi = ParamInit(generator, to_dtype(cfg.param_dtype),
                   resolve_device(device))
    d, a = cfg.d_model, cfg.attention
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    init_embedding(pi, cfg)
    init_norm(pi, "encoder/ln1", d, cfg.norm, stack=Le)
    attn.init_gqa(pi, "encoder/attn", d, a, stack=Le)
    init_norm(pi, "encoder/ln2", d, cfg.norm, stack=Le)
    init_mlp(pi, "encoder/mlp", d, cfg.d_ff, cfg.act, stack=Le)
    init_norm(pi, "decoder/ln1", d, cfg.norm, stack=Ld)
    attn.init_gqa(pi, "decoder/self_attn", d, a, stack=Ld)
    init_norm(pi, "decoder/ln_x", d, cfg.norm, stack=Ld)
    attn.init_gqa(pi, "decoder/cross_attn", d, a, stack=Ld)
    init_norm(pi, "decoder/ln2", d, cfg.norm, stack=Ld)
    init_mlp(pi, "decoder/mlp", d, cfg.d_ff, cfg.act, stack=Ld)
    init_norm(pi, "enc_norm", d, cfg.norm)
    init_norm(pi, "final_norm", d, cfg.norm)
    return pi.build() if with_axes else pi.params


def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(p, x, cfg.norm, cfg.norm_eps)


def _enc_layer(cfg: ModelConfig, layers: Params, i: int, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Encoder layer ``i`` of the stack, sliced here so that a
    checkpointed layer re-slices when it is recomputed."""
    p = layer_slice(layers, i)
    x = x + attn.gqa_forward(p["attn"], cfg.attention,
                             _norm(cfg, p["ln1"], x), positions, None,
                             causal=False)
    return x + apply_mlp(p["mlp"], _norm(cfg, p["ln2"], x), cfg.act)


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
           remat: str = "layer") -> torch.Tensor:
    """frames (B,F,d) from the stub frontend -> encoder output (B,F,d).
    Under grad with ``remat != "none"`` each layer is checkpointed, as in
    the reference (:func:`~repro_torch.models.common.checkpointed`)."""
    F = frames.shape[1]
    x = frames + sinusoidal_positions(F, cfg.d_model,
                                      device=frames.device).to(frames.dtype)
    positions = torch.arange(F, device=frames.device)
    for i in range(cfg.encoder_layers):
        x = checkpointed(remat, _enc_layer, cfg, params["encoder"], i, x,
                         positions)
    return _norm(cfg, params["enc_norm"], x)


def _dec_layer(cfg: ModelConfig, layers: Params, i: int, x: torch.Tensor,
               positions: torch.Tensor, enc_out: torch.Tensor
               ) -> torch.Tensor:
    """Decoder layer ``i`` of the stack, sliced here (as
    :func:`_enc_layer`)."""
    p = layer_slice(layers, i)
    a = cfg.attention
    x = x + attn.gqa_forward(p["self_attn"], a, _norm(cfg, p["ln1"], x),
                             positions, None, causal=True)
    x = x + attn.gqa_forward(p["cross_attn"], a, _norm(cfg, p["ln_x"], x),
                             positions, None, kv_source=enc_out)
    return x + apply_mlp(p["mlp"], _norm(cfg, p["ln2"], x), cfg.act)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None,
            remat: str = "layer") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) and the stub's frame embeddings ``extra_embeds``
    (B,F,d) -> (logits over the decoder positions (B,S,V), aux loss 0).
    Under grad with ``remat != "none"`` each encoder and each decoder
    layer is checkpointed, as in the reference."""
    if extra_embeds is None:
        raise ValueError("whisper needs frame embeddings (extra_embeds)")
    enc_out = encode(params, cfg, extra_embeds, remat)
    x = embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    x = x + sinusoidal_positions(S, cfg.d_model,
                                 device=x.device).to(x.dtype)
    positions = torch.arange(S, device=x.device)
    for i in range(cfg.num_layers):
        x = checkpointed(remat, _dec_layer, cfg, params["decoder"], i, x,
                         positions, enc_out)
    x = _norm(cfg, params["final_norm"], x)
    return (logits_from_hidden(params, cfg, x),
            x.new_zeros((), dtype=torch.float32))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None):
    """Self-attention rings of ``max_len`` slots (stacked over the
    decoder layers) and zeroed cross K/V rows for the F frames, in
    ``dtype`` (default the model's)."""
    dtype = dtype or to_dtype(cfg.dtype)
    a, dev = cfg.attention, resolve_device(device)
    F = cfg.frontend.num_positions
    cross = (cfg.num_layers, batch, F, a.num_kv_heads, a.head_dim)
    return {
        "self": _stacked(lambda: attn.init_kv_cache(
            batch, max_len, a.num_kv_heads, a.head_dim, dtype, dev),
            cfg.num_layers),
        "cross_k": torch.zeros(cross, dtype=dtype, device=dev),
        "cross_v": torch.zeros(cross, dtype=dtype, device=dev),
    }


def prime_cross_cache(params: Params, cfg: ModelConfig, cache,
                      enc_out: torch.Tensor):
    """Write every decoder layer's cross K/V of the encoder output
    ``enc_out`` (B,F,d) into the cache, in place; returns the cache."""
    for i in range(cfg.num_layers):
        p = layer_slice(params["decoder"], i)["cross_attn"]
        cache["cross_k"][i].copy_(attn._project(enc_out, p["wk"]))
        cache["cross_v"][i].copy_(attn._project(enc_out, p["wv"]))
    return cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                pos: torch.Tensor, cache):
    """tokens (B,1); pos () or (B,) absolute position of each row.
    Returns (logits (B,1,V), cache), the self rings written in place."""
    x = embed_tokens(params, cfg, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    x = x + sinusoidal_positions(1, cfg.d_model, pos).to(x.dtype)
    a = cfg.attention
    for i in range(cfg.num_layers):
        p = layer_slice(params["decoder"], i)
        c_self = _at(cache["self"], i)
        y, _ = attn.gqa_decode(p["self_attn"], a, _norm(cfg, p["ln1"], x),
                               pos, c_self, None)
        x = x + y
        y, _ = attn.gqa_decode(p["cross_attn"], a, _norm(cfg, p["ln_x"], x),
                               pos, c_self, None,
                               cross_kv=(cache["cross_k"][i],
                                         cache["cross_v"][i]))
        x = x + y
        x = x + apply_mlp(p["mlp"], _norm(cfg, p["ln2"], x), cfg.act)
    x = _norm(cfg, params["final_norm"], x)
    return logits_from_hidden(params, cfg, x), cache
