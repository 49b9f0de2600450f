"""General-purpose-orchestrator (GPO) interface — paper §III.

The paper delegates infrastructure inventory to a GPO such as Kubernetes.
Here the GPO is an in-process inventory of nodes (devices, edge hosts,
cloud) exposing exactly the information the HFL-specific orchestrator
needs: node resource states, network costs, and inference workloads."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.hflop import HFLOPInstance


@dataclass
class DeviceNode:
    id: int
    lam: float                       # inference request rate (req/s)
    lan_edge: Optional[int] = None   # edge reachable at zero cost
    reliable: bool = True


@dataclass
class EdgeNode:
    id: int
    capacity_rps: float              # inference processing capacity r_j
    cloud_cost: float = 1.0          # c^e_j
    trusted_by_all: bool = True


@dataclass
class Inventory:
    devices: List[DeviceNode]
    edges: List[EdgeNode]
    unit_cost: float = 1.0           # device->non-LAN edge cost

    @classmethod
    def from_arrays(cls, lam: np.ndarray, r: np.ndarray,
                    lan_edge: Optional[np.ndarray] = None,
                    unit_cost: float = 1.0) -> "Inventory":
        """Build an inventory from the array form the benchmarks use
        (per-device rates, per-edge capacities, optional LAN edge;
        negative LAN entries — assign-style 'no edge' markers — map to
        None, not to a bogus zero-cost link)."""
        devices = [DeviceNode(i, lam=float(l),
                              lan_edge=(int(lan_edge[i])
                                        if lan_edge is not None
                                        and int(lan_edge[i]) >= 0
                                        else None))
                   for i, l in enumerate(np.asarray(lam, float))]
        edges = [EdgeNode(j, capacity_rps=float(c))
                 for j, c in enumerate(np.asarray(r, float))]
        return cls(devices, edges, unit_cost=unit_cost)

    def to_instance(self, l: int = 2,
                    T: Optional[int] = None) -> HFLOPInstance:
        n, m = len(self.devices), len(self.edges)
        c_d = np.full((n, m), self.unit_cost)
        rows = np.asarray([d.id for d in self.devices
                           if d.lan_edge is not None], int)
        cols = np.asarray([d.lan_edge for d in self.devices
                           if d.lan_edge is not None], int)
        c_d[rows, cols] = 0.0
        c_e = np.asarray([e.cloud_cost for e in self.edges])
        lam = np.asarray([d.lam for d in self.devices])
        r = np.asarray([e.capacity_rps for e in self.edges])
        return HFLOPInstance(c_d, c_e, lam, r, l=l, T=T)


def random_inventory(n: int, m: int, seed: int = 0,
                     capacity_slack: float = 1.5) -> Inventory:
    rng = np.random.default_rng(seed)
    devices = [DeviceNode(i, lam=float(rng.uniform(0.1, 1.0)),
                          lan_edge=int(rng.integers(0, m)))
               for i in range(n)]
    total = sum(d.lam for d in devices)
    raw = rng.uniform(0.5, 1.5, m)
    caps = raw / raw.sum() * total * capacity_slack
    edges = [EdgeNode(j, capacity_rps=float(caps[j])) for j in range(m)]
    return Inventory(devices, edges)
