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

The ``shard_map`` half of the reference runs one FL cluster a process:
its functions take the rank's own slice of each leaf (leading cluster
dim 1) and a ``DeviceMesh`` of ``repro_torch.launch.mesh``, whose named
axes are process groups.  ``global_sync_shardmap`` gathers every
cluster's row into the same (C, N) matrix that :func:`global_sync`
reduces, so its result is bit-identical to it; the local step issues
no collective; ``hierarchical_allreduce`` and ``flat_allreduce`` are
the raw reductions the HFL-versus-flat comparison is built on.

The collectives are ``torch.distributed`` calls on the tensors where
they lie.  Ranks that share one card run gloo (NCCL refuses two ranks
on one device); gloo takes the CUDA tensors itself (``all_gather`` of
int8, bf16 and fp32, ``all_reduce`` SUM and MAX:
``scripts/torch_collectives_probe.py``) and moves them through host
memory inside the backend, so the payload crosses PCIe and the loopback
device.  The quantizing, the dequantizing, ``fedavg_reduce`` and the
local step stay on the card; nothing is moved to the CPU here.  NCCL,
for ranks with a card each, is untested.

The reference reads its collectives' bytes from the compiled HLO
(``repro/launch/roofline.py:collective_stats``); the port has no HLO,
so every collective these functions issue adds the bytes it hands over
to :func:`collective_bytes`, by kind and mesh axis."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.launch.mesh import axes_group, mesh_sizes
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


# ---------------------------------------------------------------------------
# the distributed half: one cluster a rank, over a DeviceMesh
# ---------------------------------------------------------------------------

_BYTES: Dict[str, Dict[str, int]] = {}


def collective_bytes() -> Dict[str, Dict[str, int]]:
    """Bytes this process handed to collectives through the functions
    below since the last :func:`reset_collective_bytes`: kind
    (``all_gather``, ``all_reduce``) -> mesh axes (``"cluster"``,
    ``"pod,data"``) -> bytes of the rank's own input."""
    return {k: dict(v) for k, v in _BYTES.items()}


def reset_collective_bytes() -> None:
    _BYTES.clear()


def _account(kind: str, axes: Sequence[str], x: torch.Tensor) -> None:
    by_axis = _BYTES.setdefault(kind, {})
    key = ",".join(axes)
    by_axis[key] = by_axis.get(key, 0) + x.numel() * x.element_size()


def all_gather_rows(row: torch.Tensor, group, axes: Sequence[str]
                    ) -> torch.Tensor:
    """(n,) on every rank of ``group`` -> the (C, n) matrix of all of
    them, by rank in the group, in one ``all_gather``."""
    _account("all_gather", axes, row)
    C = dist.get_world_size(group)
    mat = torch.empty((C, row.numel()), dtype=row.dtype, device=row.device)
    dist.all_gather(list(mat.unbind(0)), row.contiguous(), group=group)
    return mat


def all_reduce_(x: torch.Tensor, op, group, axes: Sequence[str]
                ) -> torch.Tensor:
    """``x`` reduced in place over ``group``."""
    _account("all_reduce", axes, x)
    dist.all_reduce(x, op=op, group=group)
    return x


def rank_leaves(tree: Tree) -> List[torch.Tensor]:
    """A rank's leaves, each with its leading cluster dim of 1 checked."""
    leaves = [x.detach() for _, x in flatten_with_path(tree)]
    bad = [tuple(x.shape) for x in leaves if x.dim() == 0 or x.shape[0] != 1]
    if bad:
        raise ValueError(f"a rank's leaves carry a leading cluster dim of "
                         f"1; got shapes {bad}")
    return leaves


def global_sync_shardmap(local: Tree, mesh, axis: str = "cluster") -> Tree:
    """:func:`global_sync` with one cluster a rank (the reference runs it
    under ``shard_map`` over ``axis``).  Each leaf is the rank's replica
    with a leading dim of 1.  A dtype group's leaves are flattened into
    one row, one ``all_gather`` over ``axis`` stacks the clusters' rows
    into a (C, N) matrix, and ``fedavg_reduce`` takes its mean (uniform
    weights), as :func:`global_sync` does on the stacked tree: every
    rank reduces the same matrix in the same kernel, so the replicas
    come out bit-identical, and equal to :func:`global_sync`'s.  The
    reference's ``psum(x.astype(f32)) / n`` agrees within fp32 / bf16
    rounding.  Returns a new tree (each leaf a view into its group's
    mean); the input is untouched."""
    flat = flatten_with_path(local)
    paths = [p for p, _ in flat]
    leaves = rank_leaves(local)
    group = mesh.get_group(axis)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    with torch.no_grad():
        for idx in dtype_groups(leaves).values():
            row = torch.cat([leaves[i].reshape(-1) for i in idx])
            mat = all_gather_rows(row, group, (axis,))
            del row
            mean = weighted_mean(mat, None)
            del mat
            sizes = [leaves[i].numel() for i in idx]
            for i, col in zip(idx, torch.split(mean, sizes)):
                out[i] = col.view(leaves[i].shape)
    return unflatten(paths, out)


def make_hfl_local_step_shardmap(base_step: Callable, mesh,
                                 axis: str = "cluster") -> Callable:
    """Wrap a (params, opt, batch) -> (params, opt, loss) step so that
    each rank runs it on its own cluster's replica: the leading dim of 1
    is taken off every leaf of the three trees, ``base_step`` runs, and
    the dim is put back on its results (the loss becomes (1,)).  It
    issues no collective, so nothing crosses clusters in a local round
    (:func:`collective_bytes` stays where it was)."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis!r}")
    squeeze = lambda t: _map(lambda x: x[0], t)  # noqa: E731
    expand = lambda t: _map(lambda x: x.unsqueeze(0), t)  # noqa: E731

    def stepped(local_params, local_opt, local_batch):
        new_params, new_opt, loss = base_step(
            squeeze(local_params), squeeze(local_opt), squeeze(local_batch))
        return expand(new_params), expand(new_opt), loss.reshape(1)

    return stepped


def hierarchical_allreduce(x: torch.Tensor, mesh, local_axis: str = "data",
                           global_axis: Optional[str] = "pod",
                           do_global: bool = True) -> torch.Tensor:
    """Mean of ``x`` over the cheap intra-pod axis, then (optionally)
    over the expensive cross-pod axis: a sum over each group in turn,
    then one division by the number of blocks.  ``x`` is this rank's
    dim-0 block, dim 0 co-sharded over (``local_axis``, ``global_axis``)
    (``local_axis`` alone without the global step), as the reference's
    in_specs place it; every rank gets the mean block.  The input is
    untouched."""
    sizes = mesh_sizes(mesh)
    total = x.detach().clone()
    all_reduce_(total, dist.ReduceOp.SUM, mesh.get_group(local_axis),
                (local_axis,))
    size = sizes[local_axis]
    if global_axis and do_global:
        all_reduce_(total, dist.ReduceOp.SUM, mesh.get_group(global_axis),
                    (global_axis,))
        size *= sizes[global_axis]
    return total / size


def flat_allreduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """The centralized-FL baseline: one flat sum over every aggregation
    axis present (``pod``, ``data``) as a single group, then the mean.
    ``x`` is this rank's dim-0 block, dim 0 sharded over those axes."""
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    total = x.detach().clone()
    all_reduce_(total, dist.ReduceOp.SUM, axes_group(mesh, axes), axes)
    size = 1
    for a in axes:
        size *= sizes[a]
    return total / size
