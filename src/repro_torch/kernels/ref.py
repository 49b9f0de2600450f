"""Plain PyTorch versions of the port's kernels, the counterparts of
``repro/kernels/ref.py``.

The wrappers in this package run these for tensors on the CPU, and
``chip_smoke.py`` holds every kernel against them on the card."""
from __future__ import annotations

import torch


def gru_seq_ref(xw: torch.Tensor, h0: torch.Tensor,
                w_h: torch.Tensor) -> torch.Tensor:
    """Fused-gate GRU over time: xw (B,T,3h) = x@w_x+b precomputed;
    h0 (B,h); w_h (h,3h).  Returns (B,T,h)."""
    h = h0
    outs = []
    for t in range(xw.shape[1]):
        xr, xz, xn = xw[:, t].chunk(3, dim=-1)
        hr, hz, hn = (h @ w_h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h
        outs.append(h)
    if not outs:
        return xw.new_empty((xw.shape[0], 0, h0.shape[-1]))
    return torch.stack(outs, dim=1)


def fedavg_reduce_ref(stacked: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """stacked (C, N); weights (C,) -> (N,) weighted average, summed in
    float32 and returned in the dtype of ``stacked``."""
    w = (weights / weights.sum()).float()
    return (w[:, None] * stacked.float()).sum(dim=0).to(stacked.dtype)
