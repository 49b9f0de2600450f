"""Unified model API of the port: one entry point per architecture
family.  Counterpart of ``repro/models/registry.py``; the families
ported so far:

  - rnn (paper):   batch = {"windows": (B,T,1) f32, "targets": (B,1) f32}
  - dense, moe:    batch = {"tokens": (B,S) int, "labels": (B,S) int};
                   the moe family's loss adds the routers' aux loss
  - hybrid:        the same batch; plain CE loss.  Like the JAX
                   package's, it has no one-shot ``prefill`` and no paged
                   entries: the serving engine prefills it token by token
                   through ``decode_step``

The ssm, vlm and audio families wait for their slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import gru, hybrid, transformer
from repro_torch.models.common import to_dtype


class ModelApi(NamedTuple):
    cfg: ArchConfig
    #: (generator, device=None) -> params; no logical-axis tree yet, as
    #: the port does not shard
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
    nll = (torch.logsumexp(logits, -1)
           - torch.gather(logits, -1, safe[..., None])[..., 0]) * valid
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
        init_params=lambda generator, device=None:
            gru.init_params(generator, m, device),
        forward=fwd,
        loss=loss,
        init_cache=lambda b, n, device=None: None,
        decode_step=lambda params, tokens, pos, cache, **kw:
            gru.decode_step(params, m, tokens, pos, cache),
    )


def _cache_dtype(cfg: ArchConfig):
    """The run's cache dtype, or None for the model's."""
    return to_dtype(cfg.run.cache_dtype) if cfg.run.cache_dtype else None


def _transformer_api(cfg: ArchConfig) -> ModelApi:
    m = cfg.model
    transformer.check_supported(m)
    cache_dtype = _cache_dtype(cfg)

    def fwd(params, batch):
        return transformer.forward(params, m, batch["tokens"])

    def loss(params, batch):
        logits, aux = fwd(params, batch)
        return cross_entropy_loss(logits, batch["labels"], m.vocab_size) + aux

    return ModelApi(
        cfg=cfg,
        init_params=lambda generator, device=None:
            transformer.init_params(generator, m, device),
        forward=fwd,
        loss=loss,
        init_cache=lambda b, n, device=None: transformer.init_cache(
            m, b, n, dtype=cache_dtype, device=device),
        decode_step=lambda params, tokens, pos, cache, moe_per_row=False:
            transformer.decode_step(params, m, tokens, pos, cache,
                                    moe_per_row=moe_per_row),
        prefill=lambda params, tokens, cache, length=None:
            transformer.prefill(params, m, tokens, cache, length=length),
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


def _hybrid_api(cfg: ArchConfig) -> ModelApi:
    m = cfg.model
    cache_dtype = _cache_dtype(cfg)

    def fwd(params, batch):
        return hybrid.forward(params, m, batch["tokens"])

    def loss(params, batch):
        logits, _ = fwd(params, batch)
        return cross_entropy_loss(logits, batch["labels"], m.vocab_size)

    return ModelApi(
        cfg=cfg,
        init_params=lambda generator, device=None:
            hybrid.init_params(generator, m, device),
        forward=fwd,
        loss=loss,
        init_cache=lambda b, n, device=None: hybrid.init_cache(
            m, b, n, dtype=cache_dtype, device=device),
        # the dense engine asks every family for per-row MoE capacity; a
        # hybrid has no MoE layer, so the flag changes nothing
        decode_step=lambda params, tokens, pos, cache, moe_per_row=False:
            hybrid.decode_step(params, m, tokens, pos, cache),
    )


def make_model(cfg: ArchConfig) -> ModelApi:
    family = cfg.model.family
    if family == "rnn":
        return _rnn_api(cfg)
    if family in ("dense", "moe"):
        return _transformer_api(cfg)
    if family == "hybrid":
        return _hybrid_api(cfg)
    raise NotImplementedError(
        f"family {family!r} is not ported to PyTorch yet; see ROADMAP.md "
        "for the order of slices")
