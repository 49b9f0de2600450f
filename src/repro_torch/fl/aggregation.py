"""FedAvg and hierarchical aggregation over stacked client parameters.
Counterpart of ``repro/fl/aggregation.py``, with its semantics.

Clients are stacked on a leading axis of every leaf.  Each average
flattens the stacked tree to one (C, N) matrix and reduces it with
:func:`repro_torch.kernels.ops.fedavg_reduce` (the CUDA kernel on the
card, its plain version on the CPU): one launch per non-empty cluster
for the cluster models, one more for the global model.

Weights are normalised per cluster, and the global round weights each
cluster model by its cluster's total member weight.  A cluster id with
no members (ids ``[0, 0, 2, 2]``) has weight 0 and no model: as in the
JAX package it adds nothing to the global model, and it is never
reduced, so it cannot turn into 0/0."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.params import flatten_with_path, tree_map, unflatten

Tree = Any


def _flatten(stacked: Tree) -> Tuple[torch.Tensor, list, list]:
    """Stacked tree -> (C, N) matrix, plus what :func:`_unflatten` needs."""
    flat = flatten_with_path(stacked)
    paths = [p for p, _ in flat]
    leaves = [x for _, x in flat]
    if len({x.dtype for x in leaves}) != 1:
        raise TypeError("all leaves must share one dtype to be averaged "
                        "as one (C, N) matrix")
    C = leaves[0].shape[0]
    mat = torch.cat([x.reshape(C, -1) for x in leaves], dim=1)
    return mat, paths, [tuple(x.shape[1:]) for x in leaves]


def _unflatten(mat: torch.Tensor, paths: list, shapes: list) -> Tree:
    """(R, N) matrix -> tree whose leaves are (R, *shape)."""
    sizes = [int(np.prod(s)) for s in shapes]
    cols = torch.split(mat, sizes, dim=1)
    return unflatten(paths, [c.reshape((mat.shape[0],) + s)
                             for c, s in zip(cols, shapes)])


def _weights(w: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(w, np.float32), device=device)


def fedavg(stacked: Tree, weights: Optional[Any] = None) -> Tree:
    """Weighted average over the leading (client) axis; uniform without
    weights.  Returns the averaged tree without the client axis."""
    mat, paths, shapes = _flatten(stacked)
    w = np.ones(mat.shape[0]) if weights is None else (
        weights.detach().cpu().numpy() if torch.is_tensor(weights)
        else np.asarray(weights))
    avg = ops.fedavg_reduce(mat, _weights(w, mat.device))
    return tree_map(lambda x: x[0], _unflatten(avg[None], paths, shapes))


def _cluster_models(mat: torch.Tensor, ids: np.ndarray, w: np.ndarray):
    """One weighted average per non-empty cluster id: returns the ids
    present (ascending) and their models (K, N)."""
    present = np.unique(ids)
    models = [ops.fedavg_reduce(mat[torch.as_tensor(np.flatnonzero(ids == s),
                                                    device=mat.device)],
                                _weights(w[ids == s], mat.device))
              for s in present]
    return present, torch.stack(models)


def _ids_and_weights(cluster_ids, weights, C: int):
    ids = np.asarray(cluster_ids)
    if ids.shape != (C,):
        raise ValueError(f"cluster_ids must have one id per client ({C}), "
                         f"got shape {ids.shape}")
    w = np.ones(C) if weights is None else np.asarray(weights, float)
    return ids, w


def cluster_fedavg(stacked: Tree, cluster_ids: np.ndarray,
                   weights: Optional[np.ndarray] = None) -> Tree:
    """Per-cluster FedAvg (local aggregation round).

    Returns stacked params where client i's slot holds its *cluster
    model* — exactly what each aggregator redistributes to its members."""
    mat, paths, shapes = _flatten(stacked)
    ids, w = _ids_and_weights(cluster_ids, weights, mat.shape[0])
    present, models = _cluster_models(mat, ids, w)
    slot = torch.as_tensor(np.searchsorted(present, ids), device=mat.device)
    return _unflatten(models[slot], paths, shapes)


def global_fedavg(stacked: Tree, cluster_ids: np.ndarray,
                  weights: Optional[np.ndarray] = None) -> Tree:
    """Global aggregation round: average the *cluster* models (one vote
    per cluster, weighted by cluster data size), then broadcast back to
    every client slot."""
    mat, paths, shapes = _flatten(stacked)
    ids, w = _ids_and_weights(cluster_ids, weights, mat.shape[0])
    present, models = _cluster_models(mat, ids, w)
    cw = np.array([w[ids == s].sum() for s in present])   # cluster weights
    glob = ops.fedavg_reduce(models, _weights(cw, mat.device))
    return _unflatten(glob.expand(mat.shape[0], -1).contiguous(),
                      paths, shapes)
