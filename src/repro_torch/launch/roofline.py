"""Roofline analysis of a dry-run trace (no card), the counterpart of
``repro/launch/roofline.py``:

  compute    = per-device flops / PEAK_FLOPS_BF16
  memory     = per-device bytes / HBM_BW
  collective = per-device collective operand bytes / link rate, by
               where the group runs: inside one 8-GPU node at
               NVLINK_BW, across nodes at IB_BW, across pods at IB_BW
               (the last reported apart as ``cross_pod_bytes``)

The reference reads a compiled XLA program (``cost_analysis()`` and the
HLO text); the port reads a trace.  :class:`TraceCounter` is a
``TorchDispatchMode`` that lets DTensor desugar each op first (it
returns ``NotImplemented`` for a DTensor op, as ``CommDebugMode`` does)
and then sees the ops each rank runs on its local shards, the
collectives DTensor inserts among them.  So every number is one rank's
(rank 0 of the fake world), the convention held throughout:

- flops: PyTorch's flop formulas (``torch.utils.flop_counter``) on the
  local shapes: matrix products and attention products, as
  ``FlopCounterMode`` counts them.  (``FlopCounterMode`` itself counts
  a DTensor op once at its global shape, but ops inside ``local_map`` at
  their local shapes; the counter here counts both locally.)
- bytes: each aten op's operand and result bytes, summed over every op
  traced, views and non-aten ops (``prim.device``, ``wait_tensor``)
  excluded.  It is a count with no fusion, an upper bound
  on what a fused program moves, and is labelled so.
- collectives: each functional collective's operand bytes (all-gather:
  the input shard; reduce-scatter: the full input; all-reduce: the
  buffer), its kind and its group's ranks.

``collective_stats(hlo_text)`` of the reference has no counterpart:
there is no HLO text here; :class:`TraceCounter` takes its place.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import (GPUS_PER_NODE, HBM_BW, IB_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16, POD_RANKS)

_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    cross_pod_bytes: float = 0.0      # traffic whose groups span pods
    #: of the rest: groups inside one node, and groups across nodes
    nvlink_bytes: float = 0.0
    ib_bytes: float = 0.0

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))


def link_of(ranks: Iterable[int]) -> str:
    """Where a group of ranks talks: ``"nvlink"`` inside one node of
    ``GPUS_PER_NODE``, ``"ib"`` across nodes of one pod, ``"cross_pod"``
    across pods of ``POD_RANKS``."""
    ranks = list(ranks)
    if len({r // POD_RANKS for r in ranks}) > 1:
        return "cross_pod"
    if len({r // GPUS_PER_NODE for r in ranks}) > 1:
        return "ib"
    return "nvlink"


def _group_ranks(name) -> list:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(name))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class TraceCounter(TorchDispatchMode):
    """Counts one rank's flops, bytes and collectives over everything run
    inside it (see the module docstring).  ``scale`` multiplies what is
    counted from then on (a traced microbatch standing for several)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.scale = 1.0
        self.coll = CollectiveStats()
        self.groups: Dict[str, int] = defaultdict(int)

    def __enter__(self):
        # DTensor infers each op's global output shape by running the op
        # on global-shaped fake tensors (private
        # ``ShardingPropagator._propagate_tensor_meta_non_cached``): those
        # runs are not a rank's work, and are not counted
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        self._patched = SP._propagate_tensor_meta_non_cached
        counter = self

        def propagate(prop, op_schema):
            counter._inferring += 1
            try:
                return counter._patched(prop, op_schema)
            finally:
                counter._inferring -= 1

        self._inferring = 0
        SP._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        SP._propagate_tensor_meta_non_cached = self._patched
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor desugar to local ops
        out = func(*args, **kwargs)
        if self._inferring:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        self.ops += 1
        if name in _KINDS:
            self._collective(_KINDS[name], args, kwargs)
            return out
        if packet in flop_registry:
            self.flops += self.scale * flop_registry[packet](
                *args, **kwargs, out_val=out)
        if func.namespace == "aten" and not func.is_view:
            self.bytes += self.scale * (
                sum(_nbytes(t) for t in tree_leaves((args, kwargs)))
                + sum(_nbytes(t) for t in tree_leaves(out)))
        return out

    def _collective(self, kind: str, args, kwargs) -> None:
        x = args[0]
        nb = self.scale * sum(_nbytes(t) for t in tree_leaves(x))
        # the group's name is the last string argument (a reduce op comes
        # before it)
        names = [a for a in list(args[1:]) + list(kwargs.values())
                 if isinstance(a, str)]
        group = names[-1] if names else None
        ranks = _group_ranks(group) if group is not None else []
        link = link_of(ranks) if ranks else "nvlink"
        st = self.coll
        st.bytes_by_kind[kind] = st.bytes_by_kind.get(kind, 0.0) + nb
        st.count_by_kind[kind] = st.count_by_kind.get(kind, 0) + 1
        if link == "cross_pod":
            st.cross_pod_bytes += nb
        elif link == "ib":
            st.ib_bytes += nb
        else:
            st.nvlink_bytes += nb
        self.groups[f"{kind} x{len(ranks)} {link}"] += 1


@dataclass
class Roofline:
    flops: float                      # per-device flops
    bytes_accessed: float             # per-device bytes, no fusion
    collectives: CollectiveStats
    n_chips: int
    model_flops: float = 0.0          # 6*N*D (or 6*N_active*D) global

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        c = self.collectives
        return (c.nvlink_bytes / NVLINK_BW + c.ib_bytes / IB_BW
                + c.cross_pod_bytes / IB_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (per-device flops * chips): remat/redundancy."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "bytes_per_device_is": "aten operand + result bytes, no fusion",
            "collective_bytes_per_device": self.collectives.total_bytes,
            "collective_bytes_by_kind": self.collectives.bytes_by_kind,
            "collective_counts": self.collectives.count_by_kind,
            "cross_pod_bytes": self.collectives.cross_pod_bytes,
            "nvlink_bytes": self.collectives.nvlink_bytes,
            "ib_bytes": self.collectives.ib_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def analyze(trace: TraceCounter, mesh, model_flops: float = 0.0
            ) -> Roofline:
    """The roofline of a finished trace on ``mesh`` (its size is the
    chip count)."""
    return Roofline(flops=trace.flops, bytes_accessed=trace.bytes,
                    collectives=trace.coll, n_chips=mesh.size(),
                    model_flops=model_flops)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6 * N(active) * D  (train);  2 * N * D_new (decode);
    2 * N * D (prefill)."""
    n_active = cfg.model.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
