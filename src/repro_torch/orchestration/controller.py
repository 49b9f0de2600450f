"""The HFL-specific service orchestrator (paper §III, Fig. 1):

  learning controller  — solves HFLOP, produces a deployment, monitors the
                         pipeline and re-clusters on environment events
  inference controller — deploys an inference service + routing agent per
                         node, monitors serving accuracy, and triggers a
                         new HFL task when accuracy degrades
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, Optional, Sequence

import numpy as np

from repro_torch.core.hflop import HFLOPInstance, HFLOPSolution, is_feasible
from repro_torch.core.solvers import solve_bnb, solve_decomposed, solve_heuristic
from repro_torch.core.topology import ClusterTopology
from repro_torch.orchestration.gpo import Inventory
from repro_torch.telemetry.tracer import wall_clock

if TYPE_CHECKING:   # deployments without serving tiers never import jax
    from repro_torch.serving.replica import ReplicaPool, TierSpec


@dataclass
class Deployment:
    """The containerized deployment the GPO would realize: one aggregator
    service per open edge, one client + inference service + routing agent
    per participating device — plus the tiered serving replicas HFL
    leaves behind "for free" (one model copy per tier)."""
    topology: ClusterTopology
    aggregator_nodes: List[int]
    client_nodes: List[int]
    inference_services: List[str]
    replica_pool: Optional["ReplicaPool"] = None
    created_at: float = field(default_factory=wall_clock)

    @classmethod
    def from_topology(cls, topo: ClusterTopology,
                      serving_tiers: Optional[Sequence["TierSpec"]] = None,
                      device=None) -> "Deployment":
        aggs = [int(j) for j in topo.open_edges]
        clients = [int(i) for i in np.nonzero(topo.assign >= 0)[0]]
        services = ([f"aggregator/edge-{j}" for j in aggs]
                    + [f"inference/edge-{j}" for j in aggs]
                    + [f"client/device-{i}" for i in clients]
                    + [f"routing-agent/device-{i}" for i in clients]
                    + ["aggregator/global", "inference/global"])
        pool = None
        if serving_tiers is not None:
            from repro_torch.serving.replica import ReplicaPool
            pool = ReplicaPool(serving_tiers, device=device)
            services += [f"replica/{t}" for t in pool.tiers]
        return cls(topology=topo, aggregator_nodes=aggs,
                   client_nodes=clients, inference_services=services,
                   replica_pool=pool)

    def calibrated_latency(self, decode_tokens: int = 0, **kwargs):
        """Measure this deployment's replicas and return a
        ``CalibratedLatencyModel`` for the routing simulator (the
        serving -> simulation bridge)."""
        from repro_torch.routing.latency import LatencyModel
        if self.replica_pool is None:
            raise ValueError("deployment has no replica pool "
                             "(pass serving_tiers to deploy())")
        return LatencyModel.from_measurements(
            self.replica_pool.measure(), decode_tokens=decode_tokens,
            **kwargs)


@dataclass
class LearningController:
    inventory: Inventory
    l: int = 2
    T: Optional[int] = None
    exact: bool = False              # exact B&B vs heuristic clustering
    decompose_above: int = 5000      # inventories at/above this size go
    #                                  through the decomposed solver
    accuracy_threshold: float = 0.06 # MSE above this triggers retraining
    serving_tiers: Optional[Sequence["TierSpec"]] = None  # None -> no pool
    device: Optional[str] = None     # the pool's device; None -> the GPU
    deployment: Optional[Deployment] = None
    solution: Optional[HFLOPSolution] = None
    recluster_count: int = 0

    def _solve(self, inst: HFLOPInstance) -> HFLOPSolution:
        if self.exact:
            return solve_bnb(inst)
        if inst.n >= self.decompose_above:
            return solve_decomposed(inst)
        return solve_heuristic(inst)

    def cluster(self) -> ClusterTopology:
        inst = self.inventory.to_instance(l=self.l, T=self.T)
        reliable = np.asarray([d.reliable for d in self.inventory.devices],
                              bool)
        if reliable.all():
            sol = self._solve(inst)
            if not is_feasible(inst, sol.assign):
                raise RuntimeError("clustering produced infeasible topology")
            self.solution = sol
            return ClusterTopology.from_solution(inst, sol)
        # solve over the reliable subset only: persistently
        # deadline-missing devices keep serving inference but no longer
        # gate training rounds (assign stays -1 -> the router treats
        # them like any non-participant)
        idx = np.nonzero(reliable)[0]
        sub = HFLOPInstance(inst.c_d[idx], inst.c_e, inst.lam[idx],
                            inst.r, l=inst.l,
                            T=(min(self.T, int(idx.size))
                               if self.T is not None else None))
        sub_sol = self._solve(sub)
        if not is_feasible(sub, sub_sol.assign):
            raise RuntimeError("clustering produced infeasible topology")
        assign = np.full(inst.n, -1, int)
        assign[idx] = sub_sol.assign
        self.solution = HFLOPSolution(
            assign, sub_sol.cost, optimal=sub_sol.optimal,
            solver=sub_sol.solver,
            meta=dict(sub_sol.meta, reliable_devices=int(idx.size)))
        return ClusterTopology(assign=assign, n_devices=inst.n,
                               n_edges=inst.m, lam=inst.lam, r=inst.r,
                               l=inst.l)

    def deploy(self) -> Deployment:
        topo = self.cluster()
        self.deployment = Deployment.from_topology(
            topo, serving_tiers=self.serving_tiers, device=self.device)
        return self.deployment

    # -- reactions to environment / service events (paper §III last para) --

    def drop_edge(self, edge_id: int) -> None:
        """Remove a dead edge from the inventory.  Edge ids above the
        removed one shift down by one, so device ``lan_edge`` references
        must be remapped the same way — only the dead edge's devices
        lose their LAN edge."""
        self.inventory.edges = [e for e in self.inventory.edges
                                if e.id != edge_id]
        for k, e in enumerate(self.inventory.edges):
            e.id = k
        for d in self.inventory.devices:
            if d.lan_edge is None:
                continue
            if d.lan_edge == edge_id:
                d.lan_edge = None
            elif d.lan_edge > edge_id:
                d.lan_edge -= 1

    def on_node_failure(self, edge_id: int,
                        redeploy: bool = True) -> Optional[Deployment]:
        """An edge host died: drop it from the inventory and re-cluster.
        ``redeploy=False`` records the loss without solving — the
        reactive loop uses it when a reconfiguration budget defers the
        re-deploy (the stale topology keeps serving meanwhile)."""
        self.drop_edge(edge_id)
        if not redeploy:
            return None
        self.recluster_count += 1
        return self.deploy()

    def on_capacity_change(self, edge_id: int, new_rps: float) -> Deployment:
        self.inventory.edges[edge_id].capacity_rps = new_rps
        self.recluster_count += 1
        return self.deploy()

    def on_device_move(self, device_id: int, new_edge: Optional[int],
                       redeploy: bool = True) -> Optional[Deployment]:
        """A device handed over to a different LAN edge (mobility):
        update its zero-cost association and, unless ``redeploy`` is
        False (budget-deferred or inside the recluster cooldown),
        re-solve HFLOP around the new cost structure."""
        self.inventory.devices[device_id].lan_edge = new_edge
        if not redeploy:
            return None
        self.recluster_count += 1
        return self.deploy()

    def on_unreliable_devices(self, device_ids: Sequence[int],
                              redeploy: bool = True
                              ) -> Optional[Deployment]:
        """Persistent stragglers: mark them unreliable so the next
        clustering excludes them from training, and (unless the budget
        defers it) re-solve HFLOP over the reliable subset right away."""
        for i in device_ids:
            self.inventory.devices[int(i)].reliable = False
        if not redeploy:
            return None
        self.recluster_count += 1
        return self.deploy()

    def on_accuracy_alarm(self, mse: float) -> bool:
        """Inference controller hook: True -> trigger a new HFL task."""
        return mse > self.accuracy_threshold
