"""Unified model API of the port: one entry point per architecture
family.  Counterpart of ``repro/models/registry.py``; only the paper's
GRU (family ``rnn``) is ported so far.

  - rnn (paper):   batch = {"windows": (B,T,1) f32, "targets": (B,1) f32}
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import gru


class ModelApi(NamedTuple):
    cfg: ArchConfig
    #: (generator, device=None) -> params; no logical-axis tree yet, as
    #: the port does not shard
    init_params: Callable[..., Any]
    forward: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    loss: Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]
    init_cache: Callable[[int, int], Any]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]


def make_model(cfg: ArchConfig) -> ModelApi:
    m = cfg.model
    if m.family != "rnn":
        raise NotImplementedError(
            f"family {m.family!r} is not ported to PyTorch yet; see "
            "ROADMAP.md for the order of slices")

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
        init_cache=lambda b, n: None,
        decode_step=lambda params, tokens, pos, cache, **kw:
            gru.decode_step(params, m, tokens, pos, cache),
    )
