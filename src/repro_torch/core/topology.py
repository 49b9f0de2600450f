"""Cluster topology produced by an HFLOP solution — the bridge between the
placement layer (core), the FL runtime (fl/), the inference router
(routing/) and the TPU mesh mapping (launch/)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.core.hflop import HFLOPInstance, HFLOPSolution


@dataclass
class ClusterTopology:
    """assign[i] = edge aggregator of device i (-1: not participating)."""
    assign: np.ndarray
    n_devices: int
    n_edges: int
    lam: np.ndarray                     # per-device inference rates
    r: np.ndarray                       # per-edge serving capacities
    l: int = 2                          # local rounds per global round

    @classmethod
    def from_solution(cls, inst: HFLOPInstance,
                      sol: HFLOPSolution) -> "ClusterTopology":
        return cls(assign=np.asarray(sol.assign), n_devices=inst.n,
                   n_edges=inst.m, lam=inst.lam, r=inst.r, l=inst.l)

    @classmethod
    def flat(cls, n_devices: int, lam: Optional[np.ndarray] = None
             ) -> "ClusterTopology":
        """Degenerate topology for centralized FL (no edge aggregators)."""
        return cls(assign=np.full(n_devices, -1), n_devices=n_devices,
                   n_edges=0,
                   lam=lam if lam is not None else np.zeros(n_devices),
                   r=np.zeros(0), l=1)

    @property
    def open_edges(self) -> np.ndarray:
        return np.unique(self.assign[self.assign >= 0])

    def members(self, j: int) -> np.ndarray:
        return np.nonzero(self.assign == j)[0]

    def clusters(self) -> Dict[int, np.ndarray]:
        return {int(j): self.members(int(j)) for j in self.open_edges}

    def cluster_loads(self) -> Dict[int, float]:
        return {int(j): float(np.sum(self.lam[self.members(int(j))]))
                for j in self.open_edges}

    def participant_count(self) -> int:
        return int(np.sum(self.assign >= 0))

    def describe(self) -> str:
        lines = [f"ClusterTopology: {self.participant_count()}/"
                 f"{self.n_devices} devices, "
                 f"{len(self.open_edges)} aggregators, l={self.l}"]
        for j, mem in self.clusters().items():
            load = float(np.sum(self.lam[mem]))
            cap = self.r[j] if self.r.size else float("inf")
            lines.append(f"  edge {j}: {len(mem)} devices, "
                         f"load {load:.2f}/{cap:.2f} req/s")
        return "\n".join(lines)
