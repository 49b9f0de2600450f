"""Decoder-only transformer of the dense, moe and vlm families (stablelm,
h2o-danube, gemma3, llama3-405b, internvl2's language model,
deepseek-v2-lite, qwen2-moe): the counterpart of
``repro/models/transformer.py``.

Parameters keep the JAX tree: ``embed/table``, ``lm_head/w``,
``final_norm``, the unstacked leading dense layers ``lead/{i}`` of an MoE
config (deepseek's first layer, FFN width ``dense_d_ff``), and
``layers/...`` with a leading layer axis (MoE layers when the config has
``moe``).  A python loop over the layers replaces ``lax.scan``; each
layer takes its own window and rope table from the per-layer metadata
(:func:`layer_window`, :func:`layer_theta`: gemma3's 5 local : 1 global
layers, local ones windowed at 512 with rope base 10k, global ones
unwindowed at 1M).  Caches keep the JAX layout: ``{"lead": {...},
"layers": stacked}`` when every layer has the same cache geometry, else
(gemma3) ``"layers"`` is a dict of per-layer rings keyed by the layer's
index, local layers keeping only ``min(max_len, window)`` slots.  The
paged cache is uniform for every config (windows are masks there).
Caches are written in place (see ``models/attention.py``).  MLA layers
rotate ``qk_rope_head_dim`` dims, as JAX's ``stacked_rope`` does.  A
config with ``rope_theta == 0`` rotates nothing and adds
:func:`sinusoidal_positions` to the embeddings instead, in every path.
:func:`forward` and :func:`prefill` take the vlm family's prefix
(``extra_embeds`` (B,P,d), the stub's patch embeddings) before the
tokens.
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
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.rope import rope_frequencies

FULL_WINDOW = 1 << 30
Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    if cfg.attention.kind not in ("full", "swa", "local_global", "mla"):
        raise NotImplementedError(
            f"attention kind {cfg.attention.kind!r} {attn.NOT_PORTED}")


# ---------------------------------------------------------------------------
# per-layer metadata
# ---------------------------------------------------------------------------

def layer_is_global(cfg: ModelConfig, i: int) -> bool:
    a = cfg.attention
    if a.kind != "local_global":
        return True
    return (i + 1) % (a.local_global_ratio + 1) == 0


def layer_window(cfg: ModelConfig, i: int) -> int:
    """The window layer ``i`` masks with (``FULL_WINDOW``: none)."""
    a = cfg.attention
    if a.kind == "swa":
        return a.window
    if a.kind == "local_global" and not layer_is_global(cfg, i):
        return a.window
    if a.kind == "full" and a.window:          # zamba2 shared block long mode
        return a.window
    return FULL_WINDOW


def layer_theta(cfg: ModelConfig, i: int) -> float:
    a = cfg.attention
    if a.kind == "local_global" and not layer_is_global(cfg, i):
        return a.rope_theta_local or a.rope_theta
    return a.rope_theta


def _uniform_cache_geometry(cfg: ModelConfig) -> bool:
    return len({layer_window(cfg, i) for i in range(cfg.num_layers)}) == 1


def cache_capacity(cfg: ModelConfig, i: int, max_len: int) -> int:
    w = layer_window(cfg, i)
    return min(max_len, w) if w != FULL_WINDOW else max_len


def _n_lead(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense_layers if cfg.moe else 0


def _is_mla(cfg: ModelConfig) -> bool:
    return cfg.attention.kind == "mla"


def sinusoidal_positions(S: int, d: int, offset=0,
                         device=None) -> torch.Tensor:
    """(S, d) position encodings of positions ``offset`` .. ``offset`` +
    S - 1: the sines then the cosines (concatenated, not interleaved) of
    angles p / 10000 ** (2k / d), k < d / 2, in fp32.  An ``offset`` of
    shape (B,) gives (B, S, d), each row from its own offset (JAX vmaps
    the scalar form over the rows)."""
    off = torch.as_tensor(offset, device=device)
    p = torch.arange(S, device=off.device) + off[..., None]
    k = torch.arange(d // 2, device=off.device)
    ang = p[..., None] / (10000.0 ** (2 * k / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _with_positions(cfg: ModelConfig, x: torch.Tensor,
                    offset=0) -> torch.Tensor:
    """``x`` (B,S,d) plus the sinusoidal positions from ``offset`` (()
    or (B,)) when the config has no rope, else ``x``."""
    if cfg.attention.rope_theta != 0.0:
        return x
    return x + sinusoidal_positions(x.shape[1], cfg.d_model, offset,
                                    x.device).to(x.dtype)


def _inv_freq(cfg: ModelConfig, device, i: int = 0):
    """Layer ``i``'s rope frequencies; None without rope."""
    a = cfg.attention
    if layer_theta(cfg, i) == 0.0:
        return None
    dim = a.mla.qk_rope_head_dim if _is_mla(cfg) else a.head_dim
    return torch.from_numpy(rope_frequencies(
        dim, layer_theta(cfg, i), a.rope_fraction)).to(device)


def _at(cache, i: int):
    """Layer ``i`` of a stacked cache, as views (writes go through)."""
    return type(cache)(*(x[i] for x in cache))


def _layers(params: Params, cfg: ModelConfig, device, cache=None):
    """Every layer in order, the ``lead/{i}`` dense layers first: (its
    params, whether it is an MoE layer, its cache or None, its window,
    its rope frequencies; :func:`_layer_meta`)."""
    n_lead = _n_lead(cfg)
    for i, moe_layer, window, inv_freq in _layer_meta(cfg, device):
        if i < n_lead:
            p = params["lead"][str(i)]
            c = None if cache is None else cache["lead"][str(i)]
        else:
            p = layer_slice(params["layers"], i - n_lead)
            if cache is None:
                c = None
            elif isinstance(cache["layers"], dict):
                c = cache["layers"][str(i)]
            else:
                c = _at(cache["layers"], i - n_lead)
        yield p, moe_layer, c, window, inv_freq


def _layer_meta(cfg: ModelConfig, device):
    """Every layer's (index, whether it is an MoE layer, window, rope
    frequencies), the ``lead/{i}`` dense layers first.  Each distinct
    rope base is moved to ``device`` once a call."""
    n_lead = _n_lead(cfg)
    freqs: Dict[float, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        theta = layer_theta(cfg, i)
        if theta not in freqs:
            freqs[theta] = _inv_freq(cfg, device, i)
        moe_layer = i >= n_lead and cfg.moe is not None
        yield i, moe_layer, layer_window(cfg, i), freqs[theta]


def _block(cfg: ModelConfig, p: Params, x: torch.Tensor, y: torch.Tensor,
           moe_layer: bool, groups: int = 1, with_aux: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rest of a layer after its attention output ``y``: residual,
    norm and the MLP or MoE, plus the layer's aux loss."""
    x = x + y
    h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    if moe_layer:
        y, aux = apply_moe(p["moe"], cfg.moe, h, cfg.act, groups=groups,
                           with_aux=with_aux)
    else:
        y, aux = apply_mlp(p["mlp"], h, cfg.act), x.new_zeros(
            (), dtype=torch.float32)
    return x + y, aux


def _ln1(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(pi: ParamInit, cfg: ModelConfig, path: str, moe_layer: bool,
                d_ff: int, stack: int = 0) -> None:
    init_norm(pi, f"{path}/ln1", cfg.d_model, cfg.norm, stack=stack)
    if _is_mla(cfg):
        attn.init_mla(pi, f"{path}/attn", cfg.d_model, cfg.attention,
                      stack=stack)
    else:
        attn.init_gqa(pi, f"{path}/attn", cfg.d_model, cfg.attention,
                      stack=stack)
    init_norm(pi, f"{path}/ln2", cfg.d_model, cfg.norm, stack=stack)
    if moe_layer:
        init_moe(pi, f"{path}/moe", cfg.d_model, cfg.moe, cfg.act,
                 stack=stack)
    else:
        init_mlp(pi, f"{path}/mlp", cfg.d_model, d_ff, cfg.act, stack=stack)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None,
                with_axes: bool = False) -> Params:
    """Fresh parameters in ``cfg.param_dtype`` (MoE routers in fp32).
    Each leaf is drawn where ``generator`` lives (a CPU generator draws
    on the host, a CUDA one on the card) and moved to ``device`` before
    the next (``models/common.py``)."""
    check_supported(cfg)
    pi = ParamInit(generator, to_dtype(cfg.param_dtype),
                   resolve_device(device))
    n_lead = _n_lead(cfg)
    init_embedding(pi, cfg)
    for i in range(n_lead):
        _init_layer(pi, cfg, f"lead/{i}", False,
                    cfg.moe.dense_d_ff or cfg.d_ff)
    _init_layer(pi, cfg, "layers", cfg.moe is not None, cfg.d_ff,
                stack=cfg.num_layers - n_lead)
    init_norm(pi, "final_norm", cfg.d_model, cfg.norm)
    return pi.build() if with_axes else pi.params


def _head(params, cfg, x):
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           extra_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings after the prefix ``extra_embeds`` (if any), with
    the sinusoidal positions of a config without rope."""
    x = embed_tokens(params, cfg, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return _with_positions(cfg, x)


def _layer_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   positions: torch.Tensor, inv_freq: torch.Tensor, window,
                   moe_layer: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of :func:`forward`: (its output, its MoE aux loss)."""
    a = cfg.attention
    h = _ln1(cfg, p, x)
    if _is_mla(cfg):
        y = attn.mla_forward(p["attn"], a, h, positions, inv_freq)
    else:
        y = attn.gqa_forward(p["attn"], a, h, positions, inv_freq,
                             window=window)
    return _block(cfg, p, x, y, moe_layer, with_aux=True)


def _stacked_layer_forward(cfg: ModelConfig, layers: Params, k: int,
                           *args) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_layer_forward` of layer ``k`` of the stack, sliced here so
    that a checkpointed layer re-slices when it is recomputed."""
    return _layer_forward(cfg, layer_slice(layers, k), *args)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None,
            remat: str = "layer") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S), after the prefix ``extra_embeds`` (B,P,d) if given
    -> (logits (B,P+S,V), aux loss summed over the MoE layers; 0 without
    MoE).  Under grad with ``remat != "none"`` each layer of the stack
    ``params["layers"]`` is checkpointed, its aux loss returned from
    inside; the ``lead/{i}`` dense layers are not, as in the reference
    (:func:`~repro_torch.models.common.checkpointed`)."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens, extra_embeds)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    n_lead = _n_lead(cfg)
    aux_total = x.new_zeros((), dtype=torch.float32)
    for i, moe_layer, window, inv_freq in _layer_meta(cfg, x.device):
        if i < n_lead:
            x, aux = _layer_forward(cfg, params["lead"][str(i)], x,
                                    positions, inv_freq, window, moe_layer)
        else:
            x, aux = checkpointed(remat, _stacked_layer_forward, cfg,
                                  params["layers"], i - n_lead, x,
                                  positions, inv_freq, window, moe_layer)
        aux_total = aux_total + aux
    return _head(params, cfg, x), aux_total


# ---------------------------------------------------------------------------
# dense ring cache: prefill + decode
# ---------------------------------------------------------------------------

def _stacked(make, n: int):
    """A cache NamedTuple whose leaves gain a leading layer axis."""
    per = [make() for _ in range(n)]
    return type(per[0])(*(torch.stack(xs) for xs in zip(*per)))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None):
    """{"lead": {str(i): cache of lead layer i}, "layers": cache with a
    leading layer axis}: a ring :class:`~attention.KVCache` per GQA
    layer, a latent :class:`~attention.MLACache` per MLA layer.  When the
    layers' windows differ (gemma3), "layers" is instead {str(i): ring of
    layer i}, each of :func:`cache_capacity` slots, as in JAX."""
    check_supported(cfg)
    dtype = dtype or to_dtype(cfg.dtype)
    a, dev = cfg.attention, resolve_device(device)

    def one(i):
        cap = cache_capacity(cfg, i, max_len)
        if _is_mla(cfg):
            return attn.init_mla_cache(batch, cap, a, dtype, dev)
        return attn.init_kv_cache(batch, cap, a.num_kv_heads, a.head_dim,
                                  dtype, dev)

    n_lead = _n_lead(cfg)
    lead = {str(i): one(i) for i in range(n_lead)}
    if _uniform_cache_geometry(cfg):
        return {"lead": lead, "layers": _stacked(
            lambda: one(n_lead), cfg.num_layers - n_lead)}
    return {"lead": lead, "layers": {str(i): one(i) for i in
                                     range(n_lead, cfg.num_layers)}}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache,
            length: Optional[int] = None,
            extra_embeds: Optional[torch.Tensor] = None):
    """One-shot prefill: the full-sequence pass of :func:`forward`, and
    every layer writes its cache for positions ``[0, length)`` in one
    scatter.  ``tokens`` (B,S) may be right-padded beyond ``length`` (pad
    tokens still enter the MoE dispatch, as in JAX); returns (logits
    (B,S,V), cache ready for decode at ``length``).  With a prefix
    ``extra_embeds`` (B,P,d) the positions run over the P + S embeddings
    while ``length`` still defaults to S, as in JAX."""
    check_supported(cfg)
    length = tokens.shape[1] if length is None else int(length)
    x = _embed(params, cfg, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    a = cfg.attention
    for p, moe_layer, c, window, inv_freq in _layers(params, cfg, x.device,
                                                     cache):
        h = _ln1(cfg, p, x)
        if _is_mla(cfg):
            y, _ = attn.mla_prefill(p["attn"], a, h, positions, length, c,
                                    inv_freq)
        else:
            y, _ = attn.gqa_prefill(p["attn"], a, h, positions, length, c,
                                    inv_freq, window=window)
        x, _ = _block(cfg, p, x, y, moe_layer)
    return _head(params, cfg, x), cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                pos: torch.Tensor, cache, moe_per_row: bool = False):
    """tokens (B,1); pos () or (B,) absolute position of each row.
    Returns (logits (B,1,V), cache).  With ``moe_per_row`` every row's
    MoE dispatch gets its own capacity, as a batch-1 step vmapped over
    the rows would (the dense engine's decode); without it the B tokens
    share one capacity, as in one JAX call at batch B."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    x = _with_positions(cfg, x, pos)
    a = cfg.attention
    groups = x.shape[0] if moe_per_row else 1
    for p, moe_layer, c, window, inv_freq in _layers(params, cfg, x.device,
                                                     cache):
        h = _ln1(cfg, p, x)
        if _is_mla(cfg):
            y, _ = attn.mla_decode(p["attn"], a, h, pos, c, inv_freq)
        else:
            y, _ = attn.gqa_decode(p["attn"], a, h, pos, c, inv_freq,
                                   window=window)
        x, _ = _block(cfg, p, x, y, moe_layer, groups=groups)
    return _head(params, cfg, x), cache


# ---------------------------------------------------------------------------
# paged cache: prefill + decode
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype=None, device: DeviceLike = None):
    """Paged cache for every layer, in :func:`init_cache`'s layout and
    indexed by the same page ids the pool hands out."""
    check_supported(cfg)
    dtype = dtype or to_dtype(cfg.dtype)
    a, dev = cfg.attention, resolve_device(device)

    def one():
        if _is_mla(cfg):
            return attn.init_paged_mla_cache(num_pages, page_size, a, dtype,
                                             dev)
        return attn.init_paged_kv_cache(num_pages, page_size, a.num_kv_heads,
                                        a.head_dim, dtype, dev)

    n_lead = _n_lead(cfg)
    return {"lead": {str(i): one() for i in range(n_lead)},
            "layers": _stacked(one, cfg.num_layers - n_lead)}


def paged_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  cache, block_tables: torch.Tensor,
                  length: Optional[int] = None):
    """One-shot prefill through the block table: the math of
    :func:`prefill`, cache writes scattered into pool pages.  ``tokens``
    (B,S) right-padded past ``length``; ``block_tables`` (B,
    pages_per_seq) pool page ids.  Returns (logits (B,S,V), cache)."""
    check_supported(cfg)
    length = tokens.shape[1] if length is None else int(length)
    x = _embed(params, cfg, tokens, None)
    positions = torch.arange(x.shape[1], device=x.device)
    a = cfg.attention
    for p, moe_layer, c, window, inv_freq in _layers(params, cfg, x.device,
                                                     cache):
        h = _ln1(cfg, p, x)
        if _is_mla(cfg):
            y, _ = attn.paged_mla_prefill(p["attn"], a, h, positions, length,
                                          c, block_tables, inv_freq)
        else:
            y, _ = attn.paged_gqa_prefill(p["attn"], a, h, positions, length,
                                          c, block_tables, inv_freq,
                                          window=window)
        x, _ = _block(cfg, p, x, y, moe_layer)
    return _head(params, cfg, x), cache


def paged_decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      pos: torch.Tensor, cache, block_tables: torch.Tensor):
    """Batched paged decode: one pass advances every row, and the rows
    share one MoE capacity (free rows too, which point their block table
    at the scratch page), as in JAX's one program.  ``tokens`` (B,1);
    ``pos`` (B,) per-row positions.  Returns (logits (B,1,V), cache)."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    x = _with_positions(cfg, x, pos)
    a = cfg.attention
    for p, moe_layer, c, window, inv_freq in _layers(params, cfg, x.device,
                                                     cache):
        h = _ln1(cfg, p, x)
        if _is_mla(cfg):
            y, _ = attn.paged_mla_decode(p["attn"], a, h, pos, c,
                                         block_tables, inv_freq)
        else:
            y, _ = attn.paged_gqa_decode(p["attn"], a, h, pos, c,
                                         block_tables, inv_freq,
                                         window=window)
        x, _ = _block(cfg, p, x, y, moe_layer)
    return _head(params, cfg, x), cache
