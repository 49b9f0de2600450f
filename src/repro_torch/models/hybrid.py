"""zamba2-style hybrid: a stack of Mamba2 blocks with ONE shared
transformer block (attention + MLP, a single parameter set) applied
after every complete run of ``shared_attn_every`` Mamba2 layers
[arXiv:2411.15242].  Counterpart of ``repro/models/hybrid.py``, with its
simplifications (no per-invocation LoRA on the shared block, no
concat-with-embedding input).

The parameter tree is the JAX one, key for key: ``embed/table``,
``final_norm/scale``, ``mamba_layers/{ln, mamba/...}`` with a leading
layer axis, and ``shared/{ln1, attn, ln2, mlp}``.  A python loop over the
layers replaces ``lax.scan``.  On the card the forward's Mamba2 scans run
in ``ops.mamba_chunk_scan`` and its shared attention in
``ops.flash_attention``; the decode step's shared attention runs in
``ops.decode_attention`` and its Mamba2 recurrence is plain PyTorch.  The
cache ``{"mamba": SSMState with a leading layer axis, "shared": {str(k):
KVCache}}`` (one ring per complete segment k) is written in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamInit, checkpointed,
                                       layer_slice, to_dtype)
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       init_embedding, init_mlp, init_norm,
                                       logits_from_hidden)
from repro_torch.models.rope import rope_frequencies
from repro_torch.models.ssm import (SSMState, init_mamba2, init_ssm_state,
                                    mamba2_decode, mamba2_forward)

Params = Dict[str, Any]


def _segments(cfg: ModelConfig) -> List[Tuple[int, int, bool]]:
    """Split layer indices into runs of ``shared_attn_every``; the shared
    attention block runs after each *complete* run."""
    k = cfg.shared_attn_every
    L = cfg.num_layers
    segs, start = [], 0
    while start < L:
        end = min(start + k, L)
        segs.append((start, end, end - start == k))
        start = end
    return segs


def _inv_freq(cfg: ModelConfig, device) -> torch.Tensor:
    a = cfg.attention
    return torch.from_numpy(rope_frequencies(
        a.head_dim, a.rope_theta, a.rope_fraction)).to(device)


def _window(cfg: ModelConfig):
    return cfg.attention.window or None


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None,
                with_axes: bool = False) -> Params:
    """Fresh parameters in ``cfg.param_dtype`` (``A_log``, ``D`` and
    ``dt_bias`` in fp32), each leaf drawn where ``generator`` lives and
    moved to ``device`` before the next (``models/common.py``)."""
    pi = ParamInit(generator, to_dtype(cfg.param_dtype),
                   resolve_device(device))
    d, L = cfg.d_model, cfg.num_layers
    init_embedding(pi, cfg)
    init_norm(pi, "mamba_layers/ln", d, cfg.norm, stack=L)
    init_mamba2(pi, "mamba_layers/mamba", d, cfg.ssm, stack=L)
    init_norm(pi, "shared/ln1", d, cfg.norm)
    attn.init_gqa(pi, "shared/attn", d, cfg.attention)
    init_norm(pi, "shared/ln2", d, cfg.norm)
    init_mlp(pi, "shared/mlp", d, cfg.d_ff, cfg.act)
    init_norm(pi, "final_norm", d, cfg.norm)
    return pi.build() if with_axes else pi.params


def _mamba_layer(cfg: ModelConfig, p: Params, x: torch.Tensor
                 ) -> torch.Tensor:
    h = apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    return x + mamba2_forward(p["mamba"], cfg.d_model, cfg.ssm, h)


def _shared_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor
                ) -> torch.Tensor:
    h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg.act)


def _stacked_mamba_layer(cfg: ModelConfig, layers: Params, i: int,
                         x: torch.Tensor) -> torch.Tensor:
    """:func:`_mamba_layer` of layer ``i`` of the stack, sliced here so
    that a checkpointed layer re-slices when it is recomputed."""
    return _mamba_layer(cfg, layer_slice(layers, i), x)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            remat: str = "layer") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (logits (B,S,V), aux loss 0).  Under grad with
    ``remat != "none"`` each Mamba2 layer is checkpointed; the shared
    attention block is not, as in the reference
    (:func:`~repro_torch.models.common.checkpointed`)."""
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    inv_freq, window = _inv_freq(cfg, x.device), _window(cfg)
    sp = params["shared"]
    for s, e, complete in _segments(cfg):
        for i in range(s, e):
            x = checkpointed(remat, _stacked_mamba_layer, cfg,
                             params["mamba_layers"], i, x)
        if complete:
            h = apply_norm(sp["ln1"], x, cfg.norm, cfg.norm_eps)
            x = x + attn.gqa_forward(sp["attn"], cfg.attention, h, positions,
                                     inv_freq, window=window)
            x = _shared_mlp(cfg, sp, x)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return (logits_from_hidden(params, cfg, x),
            x.new_zeros((), dtype=torch.float32))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None):
    """Fresh decode cache: an fp32 :class:`SSMState` (all zeros) per
    Mamba2 layer, stacked along a leading layer axis, and a ring
    :class:`~attention.KVCache` of capacity ``min(max_len, window)`` in
    ``dtype`` (default the model's) per complete segment."""
    dtype = dtype or to_dtype(cfg.dtype)
    a, dev = cfg.attention, resolve_device(device)
    cap = min(max_len, a.window) if a.window else max_len
    states = [init_ssm_state(batch, cfg.d_model, cfg.ssm, device=dev)
              for _ in range(cfg.num_layers)]
    return {
        "mamba": SSMState(*(torch.stack(xs) for xs in zip(*states))),
        "shared": {str(k): attn.init_kv_cache(batch, cap, a.num_kv_heads,
                                              a.head_dim, dtype, dev)
                   for k, (_, _, complete) in enumerate(_segments(cfg))
                   if complete},
    }


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                pos: torch.Tensor, cache):
    """tokens (B,1); pos () or (B,) absolute position of each row (the
    shared block's rope and window; the Mamba2 recurrence has none).
    Returns (logits (B,1,V), cache), the cache written in place."""
    x = embed_tokens(params, cfg, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    inv_freq, window = _inv_freq(cfg, x.device), _window(cfg)
    sp, states = params["shared"], cache["mamba"]
    for k, (s, e, complete) in enumerate(_segments(cfg)):
        for i in range(s, e):
            p = layer_slice(params["mamba_layers"], i)
            h = apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
            y, _ = mamba2_decode(p["mamba"], cfg.d_model, cfg.ssm, h,
                                 SSMState(states.conv[i], states.s[i]))
            x = x + y
        if complete:
            h = apply_norm(sp["ln1"], x, cfg.norm, cfg.norm_eps)
            y, _ = attn.gqa_decode(sp["attn"], cfg.attention, h, pos,
                                   cache["shared"][str(k)], inv_freq,
                                   window=window)
            x = _shared_mlp(cfg, sp, x + y)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x), cache
