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
put the int8 payload on the wire: one cluster a rank (or a shard of one,
over a ``DeviceMesh``), every rank quantizes its own delta and gathers
the others' int8 deltas and scales.  Two deviations from the reference,
which XLA needed and ``torch.distributed`` does not: no ``inner_specs``
(a sharding constraint that kept the int8 payload sharded before the
gather; a rank's tensors are never resharded here) and no ``leaf_specs``
(the manual variant's ranks already hold their shards)."""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.fl.collectives import (all_gather_rows, all_reduce_,
                                        rank_leaves, weighted_mean)
from repro_torch.launch.mesh import axes_group
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
    return _quantize_with(x, scale), scale


def _quantize_with(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


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


def _int8_sync(local: Tree, ef: EFState, mesh, axis: str,
               scale_axes: tuple) -> Tuple[Tree, EFState]:
    """The int8 sync of one rank's leaves (leading dim 1).  Each leaf's
    delta ``x - anchor + residual`` is quantized with one scale: the
    leaf's own largest magnitude, or with ``scale_axes`` the largest
    over those mesh axes (one ``all_reduce(MAX)`` of every leaf's local
    maximum).  The residual keeps what the int8 levels lost (the rank's
    own dequantized delta is what the others receive, bit for bit).
    Every leaf's int8 goes into one buffer and its scale into one fp32
    vector, so the cluster axis sees two ``all_gather`` calls a sync;
    the (C, N) fp32 matrix of dequantized deltas is averaged by
    ``fedavg_reduce``, and the rank adopts ``anchor + mean``."""
    flat = flatten_with_path(local)
    paths = [p for p, _ in flat]
    xs = rank_leaves(local)
    anchors = [a for _, a in flatten_with_path(ef.anchor)]
    resids = [r for _, r in flatten_with_path(ef.residual)]
    offs = np.cumsum([0] + [x.numel() for x in xs]).tolist()
    dev = xs[0].device
    with torch.no_grad():
        if scale_axes:
            top = torch.stack([(x.float() - a + r).abs().max()
                               for x, a, r in zip(xs, anchors, resids)])
            all_reduce_(top, dist.ReduceOp.MAX,
                        axes_group(mesh, scale_axes), scale_axes)
            scales = torch.clamp(top, min=1e-12) / 127.0
        else:
            scales = torch.empty(len(xs), dtype=torch.float32, device=dev)
        payload = torch.empty(offs[-1], dtype=torch.int8, device=dev)
        new_r = []
        for i, (x, a, r) in enumerate(zip(xs, anchors, resids)):
            delta = x.float() - a + r
            if scale_axes:
                q = _quantize_with(delta, scales[i])
            else:
                q, scales[i] = quantize_int8(delta)
            new_r.append(delta - dequantize_int8(q, scales[i]))
            payload[offs[i]:offs[i + 1]] = q.reshape(-1)
            del delta, q
        group = mesh.get_group(axis)
        dq = all_gather_rows(payload, group, (axis,))
        del payload
        sg = all_gather_rows(scales, group, (axis,))
        dq = dq.float()
        for i in range(len(xs)):
            dq[:, offs[i]:offs[i + 1]] *= sg[:, i:i + 1]
        mean_delta = weighted_mean(dq, None)
        del dq
        new_a, new_x = [], []
        for i, (x, a) in enumerate(zip(xs, anchors)):
            na = a + mean_delta[offs[i]:offs[i + 1]].view(a.shape)
            new_a.append(na)
            new_x.append(na.to(x.dtype, copy=True))
    return unflatten(paths, new_x), EFState(anchor=unflatten(paths, new_a),
                                            residual=unflatten(paths, new_r))


def compressed_global_sync_shardmap(local: Tree, ef: EFState, mesh,
                                    axis: str = "cluster"
                                    ) -> Tuple[Tree, EFState]:
    """int8 global sync with the quantized payload on the wire, one
    cluster a rank: each leaf (leading dim 1, as are the anchor and
    residual) quantized with its own scale, as
    :func:`compressed_global_sync` quantizes each cluster's; the int8
    deltas and scales gathered over ``axis`` (1 byte a parameter and 4
    a leaf); their fp32 mean through ``fedavg_reduce``.  Bit-identical
    to :func:`compressed_global_sync` over the stacked clusters.  The
    reference's ``inner_specs`` has no counterpart (module docstring).
    Returns new trees; the inputs are untouched."""
    return _int8_sync(local, ef, mesh, axis, ())


def compressed_global_sync_manual(local: Tree, ef: EFState, mesh,
                                  axis: str = "cluster"
                                  ) -> Tuple[Tree, EFState]:
    """The fully manual int8 sync: each rank holds its true local shard
    of every leaf (leading cluster dim 1; the other dims cut over the
    mesh's other axes as the caller placed them), so the ``all_gather``
    over ``axis`` carries only the shard's int8 bytes.  A leaf's scale
    is the largest magnitude of its whole cluster delta: one
    ``all_reduce(MAX)`` of the shards' maxima over every other mesh
    axis (flattened into one group).  So the shards come out as the
    matching pieces of :func:`compressed_global_sync_shardmap`'s
    result.  No ``leaf_specs``: the ranks already hold their shards."""
    scale_axes = tuple(a for a in mesh.mesh_dim_names if a != axis)
    return _int8_sync(local, ef, mesh, axis, scale_axes)


def sync_bytes(stacked: Tree, compressed: bool) -> int:
    """Cross-cluster payload per global round (for the cost accounting)."""
    total = 0
    for _, x in flatten_with_path(stacked):
        per = x.numel() // x.shape[0]
        total += per * (1 if compressed else x.element_size())
    return total
