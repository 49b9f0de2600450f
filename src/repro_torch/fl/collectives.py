"""Cluster-replicated parameters for hierarchical FL on one device, the
single-device half of ``repro/fl/collectives.py``.

Every leaf of a *stacked* tree carries a leading cluster axis: one
replica per FL cluster, trained on its own between global rounds.  The
global round is a weighted mean over that axis, computed by
:func:`repro_torch.kernels.ops.fedavg_reduce` (the CUDA kernel on the
card, its plain version on the CPU): the leaves are grouped by dtype,
each group flattened to one (C, N) matrix and reduced in one launch.

JAX's ``broadcast_to`` is a value; an ``expand`` view here would make the
replicas share memory, so that a cluster's in-place optimizer step wrote
into all of them.  :func:`stack_for_clusters` and :func:`global_sync`
return tensors of their own, one replica after another.

The ``shard_map`` half of the reference (``global_sync_shardmap``,
``make_hfl_local_step_shardmap``, ``hierarchical_allreduce``,
``flat_allreduce``) belongs to the distributed layer, not yet ported."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.params import flatten_with_path, tree_map, unflatten

Tree = Any


def _map(fn, tree: Tree) -> Tree:
    """``tree_map`` that keeps ``None`` subtrees (SGD without momentum)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, t) for t in tree))
    return tree_map(fn, tree)


def stack_for_clusters(params: Tree, n_clusters: int) -> Tree:
    """Replicate params with a leading cluster dim (divergent replicas,
    each in memory of its own)."""
    return tree_map(
        lambda x: x.detach().unsqueeze(0).repeat(
            (n_clusters,) + (1,) * x.dim()), params)


def cluster_slice(stacked: Tree, k: int) -> Tree:
    """Cluster ``k``'s replica: views into the stacked leaves, so an
    in-place write to it lands in the stack."""
    return _map(lambda x: x[k], stacked)


def dtype_groups(leaves: List[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    """Leaf indices by dtype, in first-seen order: one (C, N) matrix and
    one reduction each."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, x in enumerate(leaves):
        groups.setdefault(x.dtype, []).append(i)
    return groups


def weighted_mean(mats: torch.Tensor, weights: Optional[Any]
                  ) -> torch.Tensor:
    """(C, N) -> (N,): the weighted mean over replicas (uniform without
    weights; ``fedavg_reduce`` normalises them), one launch."""
    if weights is None:
        w = torch.ones(mats.shape[0], dtype=torch.float32, device=mats.device)
    else:
        w = torch.as_tensor(weights, dtype=torch.float32).to(mats.device)
    return ops.fedavg_reduce(mats.contiguous(), w)


def global_sync(stacked: Tree, weights: Optional[Any] = None) -> Tree:
    """Global aggregation round: weighted mean over the cluster dim,
    summed in float32 and cast back to each leaf's dtype, then copied
    back to every cluster."""
    flat = flatten_with_path(stacked)
    paths = [p for p, _ in flat]
    leaves = [x.detach() for _, x in flat]
    C = leaves[0].shape[0]
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    with torch.no_grad():
        for idx in dtype_groups(leaves).values():
            mat = torch.cat([leaves[i].reshape(C, -1) for i in idx], dim=1)
            mean = weighted_mean(mat, weights)
            del mat
            sizes = [leaves[i][0].numel() for i in idx]
            for i, col in zip(idx, torch.split(mean, sizes)):
                shape = leaves[i].shape
                out[i] = col.reshape(shape[1:]).unsqueeze(0).repeat(
                    (C,) + (1,) * (len(shape) - 1))
    return unflatten(paths, out)


def cluster_divergence(stacked: Tree) -> torch.Tensor:
    """Max abs deviation of any cluster replica from the mean — how far
    the clusters drifted between global rounds (a float32 scalar)."""
    with torch.no_grad():
        devs = []
        for _, x in flatten_with_path(stacked):
            x32 = x.detach().float()
            devs.append((x32 - x32.mean(dim=0, keepdim=True)).abs().max())
        return torch.stack(devs).max()
