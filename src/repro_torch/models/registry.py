"""Unified model API of the port: one entry point per architecture
family.  Counterpart of ``repro/models/registry.py``, for every family
the JAX package has:

  - rnn (paper):   batch = {"windows": (B,T,1) f32, "targets": (B,1) f32}
  - dense, moe:    batch = {"tokens": (B,S) int, "labels": (B,S) int};
                   the moe family's loss adds the routers' aux loss
  - vlm:           + "patches": (B,P,d) stub patch embeddings, a prefix
                   whose P label positions the loss pads with -100
  - audio:         + "frames": (B,F,d) stub frame embeddings (encoder)
  - hybrid, ssm:   the LM batch; plain CE loss

As in the JAX package, the hybrid (zamba2), ssm (xLSTM) and audio
(whisper) families have no one-shot ``prefill`` and no paged entries:
the serving engine prefills them token by token through
``decode_step``, and a paged engine refuses them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import (encdec, gru, hybrid, sharded,
                                transformer, xlstm)
from repro_torch.models.common import to_dtype


class ModelApi(NamedTuple):
    cfg: ArchConfig
    #: (generator, device=None, with_axes=False) -> params, or (params,
    #: logical-axes tree) with ``with_axes``: the tree the launch layer
    #: maps to DTensor placements (``launch/shardings.py``)
    init_params: Callable[..., Any]
    forward: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    loss: Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]
    #: (batch, max_len, device=None) -> cache, None for the GRU
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]
    # one-shot full-sequence prefill writing the KV cache
    prefill: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None
    # paged-cache path (block-table pool): (num_pages, page_size,
    # device=None) -> cache, and its prefill and decode step
    init_paged_cache: Optional[Callable[..., Any]] = None
    paged_prefill: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None
    paged_decode_step: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab_size: int) -> torch.Tensor:
    """Mean next-token CE; ignores label positions >= vocab_size or < 0
    (``repro/models/layers.py``)."""
    logits = logits.float()
    valid = (labels >= 0) & (labels < vocab_size)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    if sharded.is_dtensor(logits):
        # the label's logit as a masked sum over the (maybe split) vocab:
        # a gather along a split dim is what DTensor cannot reduce
        ids = torch.arange(logits.shape[-1], device=labels.device)
        picked = torch.where(ids == safe[..., None], logits, 0.0).sum(-1)
    else:
        picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (torch.logsumexp(logits, -1) - picked) * valid
    return nll.sum() / valid.sum().clamp(min=1)


def _rnn_api(cfg: ArchConfig) -> ModelApi:
    m = cfg.model

    def fwd(params, batch):
        pred = gru.forward(params, m, batch["windows"])
        return pred, pred.new_zeros(())

    def loss(params, batch):
        return gru.mse_loss(params, m, batch["windows"], batch["targets"])

    return ModelApi(
        cfg=cfg,
        init_params=lambda generator, device=None, with_axes=False:
            gru.init_params(generator, m, device, with_axes),
        forward=fwd,
        loss=loss,
        init_cache=lambda b, n, device=None: None,
        decode_step=lambda params, tokens, pos, cache, **kw:
            gru.decode_step(params, m, tokens, pos, cache),
    )


def _cache_dtype(cfg: ArchConfig):
    """The run's cache dtype, or None for the model's."""
    return to_dtype(cfg.run.cache_dtype) if cfg.run.cache_dtype else None


def _extra(batch: Dict[str, torch.Tensor], m) -> Optional[torch.Tensor]:
    if m.family == "vlm":
        return batch.get("patches")
    if m.family == "audio":
        return batch.get("frames")
    return None


def _lm_forward_and_loss(cfg: ArchConfig, mod):
    """The LM families' forward and loss (CE plus the MoE aux loss), the
    prefix of the vlm and audio families taken from the batch.  The run's
    ``remat`` reaches every family's forward (the four the reference
    checkpoints: transformer, hybrid, xlstm, encdec), as at
    ``repro/models/registry.py:83``."""
    m = cfg.model
    remat = cfg.run.remat

    def fwd(params, batch):
        extra = _extra(batch, m)
        kw = {} if extra is None else {"extra_embeds": extra}
        return mod.forward(params, m, batch["tokens"], remat=remat, **kw)

    def loss(params, batch):
        logits, aux = fwd(params, batch)
        labels = batch["labels"]
        if m.family == "vlm" and "patches" in batch:
            pad = labels.new_full((labels.shape[0],
                                   batch["patches"].shape[1]), -100)
            labels = torch.cat([pad, labels], dim=1)
        return cross_entropy_loss(logits, labels, m.vocab_size) + aux

    return fwd, loss


def _transformer_api(cfg: ArchConfig) -> ModelApi:
    m = cfg.model
    transformer.check_supported(m)
    cache_dtype = _cache_dtype(cfg)
    fwd, loss = _lm_forward_and_loss(cfg, transformer)

    return ModelApi(
        cfg=cfg,
        init_params=lambda generator, device=None, with_axes=False:
            transformer.init_params(generator, m, device, with_axes),
        forward=fwd,
        loss=loss,
        init_cache=lambda b, n, device=None: transformer.init_cache(
            m, b, n, dtype=cache_dtype, device=device),
        decode_step=lambda params, tokens, pos, cache, moe_per_row=False:
            transformer.decode_step(params, m, tokens, pos, cache,
                                    moe_per_row=moe_per_row),
        prefill=lambda params, tokens, cache, length=None, **kw:
            transformer.prefill(params, m, tokens, cache, length=length,
                                **kw),
        init_paged_cache=lambda num_pages, page_size, device=None:
            transformer.init_paged_cache(m, num_pages, page_size,
                                         dtype=cache_dtype, device=device),
        paged_prefill=lambda params, tokens, cache, block_tables, length=None:
            transformer.paged_prefill(params, m, tokens, cache, block_tables,
                                      length=length),
        paged_decode_step=lambda params, tokens, pos, cache, block_tables:
            transformer.paged_decode_step(params, m, tokens, pos, cache,
                                          block_tables),
    )


def _recurrent_api(cfg: ArchConfig, mod) -> ModelApi:
    """The families served through the decode step alone: no one-shot
    prefill and no paged cache."""
    m = cfg.model
    cache_dtype = _cache_dtype(cfg)
    fwd, loss = _lm_forward_and_loss(cfg, mod)

    return ModelApi(
        cfg=cfg,
        init_params=lambda generator, device=None, with_axes=False:
            mod.init_params(generator, m, device, with_axes),
        forward=fwd,
        loss=loss,
        init_cache=lambda b, n, device=None: mod.init_cache(
            m, b, n, dtype=cache_dtype, device=device),
        # the dense engine asks every family for per-row MoE capacity;
        # these have no MoE layer, so the flag changes nothing
        decode_step=lambda params, tokens, pos, cache, moe_per_row=False:
            mod.decode_step(params, m, tokens, pos, cache),
    )


#: the module of each family served through its decode step alone
_RECURRENT = {"hybrid": hybrid, "ssm": xlstm, "audio": encdec}


def make_model(cfg: ArchConfig) -> ModelApi:
    family = cfg.model.family
    if family == "rnn":
        return _rnn_api(cfg)
    if family in ("dense", "moe", "vlm"):
        return _transformer_api(cfg)
    if family in _RECURRENT:
        return _recurrent_api(cfg, _RECURRENT[family])
    raise ValueError(f"unknown model family {family!r}")
