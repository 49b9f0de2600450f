"""The paper's own model (§V-B1): stacked GRU for univariate traffic-speed
forecasting on METR-LA-style windows.  Counterpart of
``repro/models/gru.py``, with the same parameter tree.

2 layers, hidden 128, batch 16, lr 1e-4 in the paper; serialized size
~594 KB — the payload of every HFL model exchange (§V-D cost model).

The input projection of each layer is one ``torch.matmul`` (the JAX
package leaves it to XLA); the recurrence goes through
:func:`repro_torch.kernels.ops.gru_seq`, which launches the CUDA kernel
for tensors on the card and runs its plain version on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.params import tree_map

Params = Dict[str, Any]


def _fan_in_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Normal scaled by 1/sqrt(fan_in), fan_in = shape[0]
    (``repro/models/common.py`` ParamBuilder, init="fan_in")."""
    std = 1.0 / np.sqrt(max(shape[0], 1))
    return torch.randn(shape, generator=generator) * std


def param_axes(cfg: ModelConfig) -> Params:
    """The logical axes of every leaf, as ``repro/models/gru.py`` gives
    them to its ``ParamBuilder``."""
    gru = {str(i): {"w_x": (None, "mlp"), "w_h": (None, "mlp"),
                    "b": ("mlp",)} for i in range(cfg.rnn_layers)}
    return {"gru": gru, "head": {"w": ("mlp", None), "b": (None,)}}


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None, with_axes: bool = False) -> Params:
    """Fresh float32 parameters; ``generator`` is a CPU generator.  The
    draws differ from ``repro``'s for the same seed: parity goes through
    weights carried over with :func:`repro_torch.params.from_numpy_tree`.
    ``with_axes`` returns (params, :func:`param_axes`)."""
    dev = resolve_device(device)
    h = cfg.rnn_hidden
    gru = {}
    for i in range(cfg.rnn_layers):
        din = 1 if i == 0 else h
        # fused gates: reset, update, candidate
        gru[str(i)] = {"w_x": _fan_in_normal((din, 3 * h), generator),
                       "w_h": _fan_in_normal((h, 3 * h), generator),
                       "b": torch.zeros(3 * h)}
    params = {"gru": gru, "head": {"w": _fan_in_normal((h, 1), generator),
                                   "b": torch.zeros(1)}}
    params = tree_map(lambda t: t.to(dev), params)
    return (params, param_axes(cfg)) if with_axes else params


def _gru_layer(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B,T,din) -> (B,T,h)."""
    xw = torch.matmul(x, p["w_x"]) + p["b"]
    h0 = x.new_zeros((x.shape[0], p["w_h"].shape[0]))
    return ops.gru_seq(xw.contiguous(), h0, p["w_h"].contiguous())


def forward(params: Params, cfg: ModelConfig,
            windows: torch.Tensor) -> torch.Tensor:
    """windows (B,T,1) -> prediction (B,1) of the next value."""
    x = windows
    for i in range(cfg.rnn_layers):
        x = _gru_layer(params["gru"][str(i)], x)
    last = x[:, -1, :]
    return last @ params["head"]["w"] + params["head"]["b"]


def mse_loss(params: Params, cfg: ModelConfig, windows: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
    pred = forward(params, cfg, windows)
    return torch.mean(torch.square(pred - targets))


def decode_step(params: Params, cfg: ModelConfig, windows: torch.Tensor,
                pos=None, cache: Optional[Any] = None):
    """Inference = one forward over the window (the paper's per-request
    unit of work)."""
    return forward(params, cfg, windows), cache
