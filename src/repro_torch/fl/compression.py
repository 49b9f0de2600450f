"""int8-quantized global aggregation with error feedback, the
counterpart of ``repro/fl/compression.py``.

Each cluster quantizes the delta of its replica since the last global
round (plus the residual it kept from earlier rounds) to int8 with one
scale per cluster and leaf; the residual of the rounding stays with the
cluster (error feedback), so the scheme is unbiased in the long run.
The weighted mean of the dequantized deltas goes through
:func:`repro_torch.kernels.ops.fedavg_reduce`: every leaf's float32
deltas in one (C, N) matrix, one launch.

``compressed_global_sync_shardmap`` and ``compressed_global_sync_manual``
(the int8 payload on the wire between devices) belong to the distributed
layer, not yet ported."""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.fl.collectives import weighted_mean
from repro_torch.params import flatten_with_path, tree_map, unflatten

Tree = Any


class EFState(NamedTuple):
    anchor: Tree                     # params at last global sync (fp32)
    residual: Tree                   # accumulated quantization error


def init_ef_state(stacked_params: Tree) -> EFState:
    return EFState(
        anchor=tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                        stacked_params),
        residual=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                device=x.device),
                          stacked_params))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scale for the whole tensor; rounds half to even, as
    ``jnp.round`` does."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_global_sync(stacked: Tree, ef: EFState,
                           weights: Optional[Any] = None
                           ) -> Tuple[Tree, EFState]:
    """Global round with int8 delta exchange + error feedback.

    Each cluster quantizes (params - anchor + residual); the mean of the
    dequantized deltas updates the anchor; every cluster adopts
    anchor + mean_delta.  Returns new trees; the inputs are untouched."""
    flat = flatten_with_path(stacked)
    paths = [p for p, _ in flat]
    xs = [x.detach() for _, x in flat]
    anchors = [a for _, a in flatten_with_path(ef.anchor)]
    resids = [r for _, r in flatten_with_path(ef.residual)]
    C = xs[0].shape[0]
    offs = np.cumsum([0] + [x[0].numel() for x in xs]).tolist()
    new_r = []
    with torch.no_grad():
        dq_all = torch.empty((C, offs[-1]), dtype=torch.float32,
                             device=xs[0].device)
        for i, (x, a, r) in enumerate(zip(xs, anchors, resids)):
            delta = x.float() - a + r
            res = torch.empty_like(delta)
            for c in range(C):           # per-cluster quantization
                dq = dequantize_int8(*quantize_int8(delta[c]))
                dq_all[c, offs[i]:offs[i + 1]] = dq.reshape(-1)
                res[c] = delta[c] - dq
            new_r.append(res)
            del delta
        mean_delta = weighted_mean(dq_all, weights)
        del dq_all
        new_a, new_x = [], []
        for i, (x, a) in enumerate(zip(xs, anchors)):
            na = a + mean_delta[offs[i]:offs[i + 1]].reshape(x.shape[1:])
            new_a.append(na)
            new_x.append(na.to(x.dtype, copy=True))
    return unflatten(paths, new_x), EFState(anchor=unflatten(paths, new_a),
                                            residual=unflatten(paths, new_r))


def sync_bytes(stacked: Tree, compressed: bool) -> int:
    """Cross-cluster payload per global round (for the cost accounting)."""
    total = 0
    for _, x in flatten_with_path(stacked):
        per = x.numel() // x.shape[0]
        total += per * (1 if compressed else x.element_size())
    return total
