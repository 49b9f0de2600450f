"""Reactive orchestration loop — closes the monitor -> controller ->
re-deploy cycle the paper describes (§III last paragraph) inside the
co-simulation.

Monitors emit telemetry on the shared event core and drive the
``LearningController`` hooks mid-simulation:

  accuracy monitor   modeled validation MSE (drift onset ramps it up,
                     each retraining round *started after the onset*
                     closes part of the gap) -> ``on_accuracy_alarm``
                     -> retraining burst
  latency monitor    windowed p95 over the request log; sustained
                     violations pick the bottleneck edge and call
                     ``on_capacity_change`` with its training-degraded
                     effective rate -> HFLOP re-clusters -> the co-sim
                     swaps the deployment (with migration cost)
  failure monitor    ``NODE_FAILURE`` events -> ``on_node_failure`` ->
                     re-cluster around the dead edge
  straggler monitor  ``STRAGGLER`` events -> deadline check -> drop the
                     device from rounds it can no longer finish in time
                     (partial aggregation); devices that keep missing
                     deadlines are marked unreliable and HFLOP is
                     re-solved without them (``unreliable_after_drops``)
  mobility monitor   ``DEVICE_MOVE`` events -> update the inventory's
                     LAN association and re-cluster, budget permitting

Every re-deploy stamps the shared recluster cooldown, and every
*optional* one (latency derate, idle restore, mobility) is metered by
the co-sim's :class:`~repro_torch.sim.budget.ReconfigBudget` when one is
attached — an exhausted budget defers the reaction instead of paying
``migration_share`` + ``reconfig_penalty_ms`` again.

The loop keeps an explicit topology-edge -> inventory-index mapping:
the two numberings coincide right after a deployment goes live, but
drift apart when a node failure renumbers the inventory while the
budget holds back the re-deploy — reactions must keep landing on the
right physical host regardless.

All reactions are deterministic functions of the event stream, so a
reactive run is reproducible seed-for-seed like any other.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


from repro_torch.fl.schedule import round_schedule
from repro_torch.sim.events import Event, EventKind, Simulation


@dataclass
class AccuracyModel:
    """Closed-form serving-accuracy telemetry: base MSE until drift
    onset, then a ramp toward ``drift_mse`` over ``ramp_s`` seconds;
    every completed retraining round that *started after the onset*
    multiplies the remaining gap by ``1 - recovery_per_round``
    (continual learning re-fits the model).  Rounds trained entirely on
    pre-drift data cannot recover post-drift MSE, so they earn no
    credit."""
    base_mse: float = 0.03
    drift_mse: float = 0.12
    ramp_s: float = 30.0
    recovery_per_round: float = 0.5
    drift_t: Optional[float] = None
    gap_scale: float = 1.0

    def on_drift(self, t: float, drift_mse: Optional[float] = None) -> None:
        self.drift_t = t
        self.gap_scale = 1.0
        if drift_mse is not None:
            self.drift_mse = float(drift_mse)

    def on_round_complete(self, round_start: Optional[float] = None) -> None:
        if self.drift_t is None:
            return
        if round_start is not None and round_start < self.drift_t:
            return                   # trained on pre-drift data: no credit
        self.gap_scale *= (1.0 - self.recovery_per_round)

    def mse(self, t: float) -> float:
        if self.drift_t is None or t < self.drift_t:
            return self.base_mse
        ramp = min((t - self.drift_t) / max(self.ramp_s, 1e-9), 1.0)
        return self.base_mse + self.gap_scale * ramp * (self.drift_mse
                                                        - self.base_mse)


@dataclass
class ReactivePolicy:
    p95_threshold_ms: float = 40.0   # sustained p95 above this -> recluster
    window_s: float = 10.0           # telemetry window for p95
    min_window_requests: int = 20
    cooldown_s: float = 30.0         # between reclusterings
    capacity_derate: float = 0.6     # edge_agg_share estimate used when
    #                                  reporting effective capacity
    feasibility_slack: float = 1.05  # keep sum(r) >= slack * sum(lam)
    burst_rounds: int = 4            # retraining burst on accuracy alarm
    burst_local_epochs: int = 5
    burst_epoch_s: float = 4.0
    burst_upload_s: float = 1.5
    restore_idle_s: float = 20.0     # training idle this long -> restore
    #                                  nominal capacities (and re-cluster)
    drop_stragglers: bool = True     # deadline-based partial aggregation
    unreliable_after_drops: Optional[int] = None  # total deadline drops
    #                                  before a device is marked unreliable
    #                                  and re-clustered out (None: off)
    recluster_on_move: bool = True   # re-solve HFLOP after a handover
    budget_exempt_failures: bool = True  # failure reclusters are
    #                                  correctness, not optimization: they
    #                                  go through even on a spent budget


class ReactiveLoop:
    """Binds a ``LearningController`` to a running :class:`CoSim`."""

    def __init__(self, controller, accuracy: Optional[AccuracyModel] = None,
                 policy: Optional[ReactivePolicy] = None):
        self.controller = controller
        self.acc = accuracy if accuracy is not None else AccuracyModel()
        self.policy = policy if policy is not None else ReactivePolicy()
        self.mse_series: List[Tuple[float, float]] = []
        self.actions: List[Tuple[float, str]] = []
        self.burst_until = -math.inf
        self.last_recluster_t = -math.inf
        # nominal (pre-derate) capacity per INVENTORY index: derates are
        # computed from here so repeated alarms don't compound, and
        # capacities are restored once training goes idle
        self._nominal_caps: Dict[int, float] = {}
        # device -> cumulative deadline drops (straggler monitor)
        self._drop_counts: Dict[int, int] = {}
        # topology edge id -> inventory index.  Identity right after a
        # deployment goes live; diverges when a failure renumbers the
        # inventory while the budget defers the re-deploy.
        self._edge_to_inv: Dict[int, int] = {}
        self.cosim = None
        self.tel = None

    def bind(self, cosim) -> None:
        self.cosim = cosim
        # already resolved by the co-sim: None unless enabled.  The
        # audit log is additive observation — `actions` strings and the
        # budget ledger are byte-identical with telemetry on or off.
        self.tel = cosim.tel
        self._edge_to_inv = {j: j for j in
                             range(len(self.controller.inventory.edges))}
        sim: Simulation = cosim.sim
        sim.on(EventKind.TELEMETRY, self.on_telemetry)
        sim.on(EventKind.DRIFT_ONSET, self.on_drift)
        sim.on(EventKind.NODE_FAILURE, self.on_node_failure)
        sim.on(EventKind.CAPACITY_CHANGE, self.on_capacity_change)
        sim.on(EventKind.ROUND_END, self.on_round_end)
        sim.on(EventKind.STRAGGLER, self.on_straggler)
        sim.on(EventKind.DEVICE_MOVE, self.on_device_move)
        tick = cosim.cfg.telemetry_s
        n_ticks = int(cosim.cfg.duration_s / tick)
        for k in range(1, n_ticks + 1):
            sim.schedule(k * tick, EventKind.TELEMETRY)

    # -- topology-edge -> inventory mapping ---------------------------------

    def _inv_index(self, topo_edge: int) -> Optional[int]:
        idx = self._edge_to_inv.get(int(topo_edge))
        if idx is None or idx >= len(self.controller.inventory.edges):
            return None
        return idx

    def _mapping_is_identity(self) -> bool:
        # identity must cover the live topology's whole id space: after
        # a deferred failure drops the highest-numbered edge, the
        # surviving {0:0,...} entries alone are NOT identity — the
        # renumbering still has to be composed into alias/demand keys
        n = self.cosim.proc.topo.n_edges
        return (len(self._edge_to_inv) == n
                and all(self._edge_to_inv.get(j) == j for j in range(n)))

    def _budget_allows(self, t: float, reason: str) -> bool:
        """Pre-flight check for *optional* reclusterings: when the
        budget can't cover another migration, record the veto and defer
        (the alarm will re-fire after the cooldown if it persists).
        The check uses the inventory size as an upper bound on the
        re-solved deployment's open edges, so once it passes the actual
        charge in ``apply_deployment`` cannot fail — the controller is
        never mutated for a swap that then gets vetoed."""
        budget = self.cosim.budget
        if budget is None:
            return True
        cost = self.cosim.reconfig_cost(
            n_edges=len(self.controller.inventory.edges))
        if budget.can_afford(cost):
            return True
        budget.charge(t, cost, reason, forced=False)   # records the veto
        if self.tel is not None:
            self.tel.audit.record(
                t, "deployment_swap", trigger=reason, outcome="deferred",
                cost=cost, charged=False,
                evidence={"budget_remaining": budget.remaining,
                          "budget_total": budget.total})
        self.actions.append(
            (t, f"{reason} deferred: reconfig budget exhausted "
             f"({budget.summary()})"))
        return False

    def _apply(self, dep, t: float, reason: str,
               forced: bool = False) -> bool:
        """Swap a controller-produced deployment into the co-sim.  The
        new topology uses the (possibly renumbered) inventory ids, so
        external edge demand keyed by old topology ids is re-keyed
        first, and on success the mapping collapses back to identity.
        Stamps the shared recluster cooldown — every re-deploy pays the
        same migration window, whichever monitor asked for it."""
        old_map = dict(self._edge_to_inv)
        if not self._mapping_is_identity():
            self.cosim.interference.remap_tier("edge", old_map.get)
            self.cosim.remap_edge_alias(old_map.get)
        applied = self.cosim.apply_deployment(dep, reason=reason,
                                              forced=forced)
        if applied:
            self._edge_to_inv = {j: j for j in
                                 range(len(self.controller.inventory.edges))}
            self.last_recluster_t = t
        return applied

    # -- environment events -> controller hooks -----------------------------

    def on_drift(self, sim: Simulation, ev: Event) -> None:
        self.acc.on_drift(ev.t, drift_mse=ev.payload)
        self.actions.append((ev.t, "drift onset"))
        if self.tel is not None:
            self.tel.audit.record(
                ev.t, "drift_alarm", trigger="drift_onset",
                outcome="noted",
                evidence={"drift_mse": self.acc.drift_mse,
                          "base_mse": self.acc.base_mse})

    def on_round_end(self, sim: Simulation, ev: Event) -> None:
        sid, w = ev.payload
        # credit only rounds that trained on post-drift data AND (under
        # an armed chaos plan with a quorum) aggregated enough devices
        # — a below-quorum partial aggregate earns no recovery
        if not self.cosim.last_round_quorum_ok:
            return
        self.acc.on_round_complete(round_start=w.start)

    def on_node_failure(self, sim: Simulation, ev: Event) -> None:
        # events name edges by injection-time id: resolve to the
        # current topology numbering first
        failed = self.cosim.resolve_edge(ev.node)
        inv_idx = self._inv_index(failed) if failed is not None else None
        if inv_idx is None:
            self.actions.append((ev.t, f"edge {ev.node} failed but is "
                                 "not in the inventory — ignored"))
            return

        def shift(y: int) -> Optional[int]:
            # inventory indices after removing inv_idx
            return None if y == inv_idx else (y - 1 if y > inv_idx else y)

        budget = self.cosim.budget
        exempt = self.policy.budget_exempt_failures
        # a failure landing inside an in-flight deployment swap folds
        # into that swap: the open migration window already paid, so
        # the budget is not charged again (and the re-solve below runs
        # against the controller's current — post-swap — inventory, so
        # it can never recluster the pre-swap topology)
        in_window = ev.t < self.cosim.reconfig_until
        # bound: the re-solved deployment opens at most the surviving
        # inventory edges
        fail_cost = self.cosim.reconfig_cost(
            n_edges=len(self.controller.inventory.edges) - 1)
        if (not exempt and not in_window and budget is not None
                and not budget.can_afford(fail_cost)):
            # the edge is gone either way: record the truth in the
            # inventory, but defer the re-deploy — the stale topology
            # keeps serving (the dead edge's requests spill to the
            # cloud) and the edge mapping tracks the renumbering
            budget.charge(ev.t, fail_cost,
                          f"failure recluster (edge {failed})",
                          forced=False)
            if self.tel is not None:
                self.tel.audit.record(
                    ev.t, "deployment_swap",
                    trigger=f"failure recluster (edge {failed})",
                    outcome="deferred", cost=fail_cost, charged=False,
                    evidence={"failed_edge": failed,
                              "budget_remaining": budget.remaining})
            self.controller.on_node_failure(inv_idx, redeploy=False)
            self._edge_to_inv = {
                tj: s for tj, y in self._edge_to_inv.items()
                if (s := shift(y)) is not None}
            self._nominal_caps = {
                s: cap for j, cap in self._nominal_caps.items()
                if (s := shift(j)) is not None}
            self.actions.append(
                (ev.t, f"edge {failed} failed; recluster deferred "
                 f"(reconfig budget exhausted, {budget.summary()})"))
            return

        old_map = dict(self._edge_to_inv)
        dep = self.controller.on_node_failure(inv_idx)
        self._nominal_caps = {
            s: cap for j, cap in self._nominal_caps.items()
            if (s := shift(j)) is not None}

        def to_new(x: int) -> Optional[int]:
            # old topology id -> old inventory idx -> post-removal idx,
            # which is the new topology numbering
            return shift(old_map[x]) if x in old_map else None

        # external (tenant/handover) edge demand and the scheduled-event
        # alias both follow their physical hosts into the new numbering
        self.cosim.interference.remap_tier("edge", to_new)
        self.cosim.remap_edge_alias(to_new)
        self._edge_to_inv = {j: j for j in
                             range(len(self.controller.inventory.edges))}
        if self.cosim.apply_deployment(
                dep, reason=f"failure recluster (edge {failed})",
                forced=exempt, absorb=in_window):
            self.last_recluster_t = ev.t         # cooldown covers the
            #                                      open migration window
        self.actions.append((ev.t, f"edge {failed} failed -> reclustered "
                             f"to {len(dep.topology.open_edges)} edges"
                             + (" (folded into in-flight migration)"
                                if in_window else "")))

    def on_capacity_change(self, sim: Simulation, ev: Event) -> None:
        topo_j = self.cosim.resolve_edge(ev.node)
        inv_idx = self._inv_index(topo_j) if topo_j is not None else None
        if inv_idx is None:
            self.actions.append(
                (ev.t, f"edge {ev.node} capacity change outside the "
                 "inventory — admission updated only"))
            return
        # a real hardware capacity change supersedes any derated nominal
        # we recorded — _restore_capacity must not revert it later
        self._nominal_caps.pop(inv_idx, None)
        if not self._budget_allows(
                ev.t, f"capacity recluster (edge {topo_j})"):
            # record the new truth without re-deploying
            self.controller.inventory.edges[inv_idx].capacity_rps = \
                float(ev.payload)
            return
        dep = self.controller.on_capacity_change(inv_idx,
                                                 float(ev.payload))
        if self._apply(dep, ev.t,
                       reason=f"capacity recluster (edge {topo_j})"):
            self.actions.append(
                (ev.t, f"edge {topo_j} capacity -> "
                 f"{float(ev.payload):.2f} rps, reclustered"))

    def on_straggler(self, sim: Simulation, ev: Event) -> None:
        """The co-sim has already re-timed the device's remaining
        epochs; decide whether it can still make each round's upload
        deadline, and drop it from rounds it cannot (partial
        aggregation — the paper's deadline-based fallback)."""
        i, factor = int(ev.node), float(ev.payload)
        info = self.cosim.straggler_info(i)
        self.actions.append(
            (ev.t, f"device {i} straggling x{factor:.1f} "
             f"({len(info)} active round(s) affected)"))
        if not self.policy.drop_stragglers:
            return
        rounds_dropped = 0
        for sid, w, projected_end in info:
            if projected_end > w.upload_end + 1e-9:
                dropped = self.cosim.drop_from_round(i, sid, w.index)
                if dropped:
                    rounds_dropped += 1
                    self.actions.append(
                        (ev.t, f"device {i} projected to finish round "
                         f"{w.index} at t={projected_end:.1f}s > deadline "
                         f"{w.upload_end:.1f}s -> dropped ({dropped} "
                         "epochs cancelled, partial aggregation)"))
                    if self.tel is not None:
                        self.tel.audit.record(
                            ev.t, "straggler_drop",
                            trigger="deadline_miss", outcome="applied",
                            evidence={"device": i, "round": w.index,
                                      "epochs_dropped": dropped,
                                      "projected_end_s": projected_end,
                                      "deadline_s": w.upload_end})
        if rounds_dropped:
            self._note_drops(ev.t, i, rounds_dropped)

    def _note_drops(self, t: float, i: int, rounds_dropped: int) -> None:
        """Straggler re-clustering: a device that keeps missing upload
        deadlines is marked ``reliable=False`` in the inventory and
        HFLOP is re-solved without it (it keeps serving inference, but
        stops gating rounds).  The re-deploy is metered like any other
        optional recluster — on a spent budget or inside the cooldown
        only the mark is recorded, and the next recluster from any
        monitor picks it up."""
        thresh = self.policy.unreliable_after_drops
        if thresh is None:
            return
        self._drop_counts[i] = self._drop_counts.get(i, 0) + rounds_dropped
        devices = self.controller.inventory.devices
        if (self._drop_counts[i] < thresh or i >= len(devices)
                or not devices[i].reliable):
            return
        reason = f"unreliable recluster (device {i})"
        if self.tel is not None:
            self.tel.audit.record(
                t, "unreliable_mark", trigger="deadline_drops",
                outcome="noted",
                evidence={"device": i, "drops": self._drop_counts[i],
                          "threshold": thresh})
        if (t - self.last_recluster_t < self.policy.cooldown_s
                or not self._budget_allows(t, reason)):
            self.controller.on_unreliable_devices([i], redeploy=False)
            self.actions.append(
                (t, f"device {i} marked unreliable after "
                 f"{self._drop_counts[i]} deadline drops; recluster "
                 "deferred"))
            return
        dep = self.controller.on_unreliable_devices([i])
        if dep is not None and self._apply(dep, t, reason=reason):
            self.actions.append(
                (t, f"device {i} marked unreliable after "
                 f"{self._drop_counts[i]} deadline drops -> re-clustered "
                 "without it"))

    def on_device_move(self, sim: Simulation, ev: Event) -> None:
        """The co-sim has already re-homed the device's requests and
        started the handover window; mirror the move into the
        inventory's LAN association and re-solve HFLOP around the new
        cost structure — budget and cooldown permitting."""
        i = int(ev.node)
        new_topo_edge = self.cosim.resolve_edge(ev.payload)
        if new_topo_edge is None:
            return                   # target host gone: co-sim dropped it
        inv_idx = self._inv_index(new_topo_edge)
        self.actions.append(
            (ev.t, f"device {i} handed over to edge {ev.payload}"))
        recluster = (self.policy.recluster_on_move
                     and ev.t - self.last_recluster_t
                     >= self.policy.cooldown_s)
        if recluster and not self._budget_allows(
                ev.t, f"mobility recluster (device {i})"):
            self.last_recluster_t = ev.t         # defer past the cooldown
            recluster = False
        dep = self.controller.on_device_move(i, inv_idx,
                                             redeploy=recluster)
        if dep is not None and self._apply(
                dep, ev.t, reason=f"mobility recluster (device {i})"):
            self.actions.append(
                (ev.t, f"re-clustered around device {i}'s new LAN edge"))

    # -- telemetry tick ------------------------------------------------------

    def on_telemetry(self, sim: Simulation, ev: Event) -> None:
        t = ev.t
        mse = self.acc.mse(t)
        self.mse_series.append((t, mse))
        if (self.controller.on_accuracy_alarm(mse)
                and t >= self.burst_until):
            self._trigger_retraining(t, mse)
        p95 = self._window_p95(t)
        if (p95 is not None and p95 > self.policy.p95_threshold_ms
                and t - self.last_recluster_t >= self.policy.cooldown_s):
            self._recluster_for_latency(t, p95)
        elif (self._nominal_caps and not self.cosim.training_active
                and t - self.cosim.last_round_end
                >= self.policy.restore_idle_s
                and t - self.last_recluster_t >= self.policy.cooldown_s):
            self._restore_capacity(t)

    def _trigger_retraining(self, t: float, mse: float) -> None:
        p = self.policy
        burst = round_schedule(p.burst_rounds, l=self.controller.l,
                               local_epochs=p.burst_local_epochs,
                               epoch_s=p.burst_epoch_s,
                               upload_s=p.burst_upload_s, start_s=t)
        self.cosim.add_training(burst)
        self.burst_until = burst[-1].end
        self.actions.append((t, f"accuracy alarm (mse={mse:.3f}) -> "
                             f"retraining burst of {p.burst_rounds} rounds"))
        if self.tel is not None:
            self.tel.audit.record(
                t, "retraining_burst", trigger="drift_alarm",
                outcome="applied",
                evidence={"mse": mse, "rounds": p.burst_rounds,
                          "local_epochs": p.burst_local_epochs,
                          "burst_until_s": self.burst_until})
            self.tel.metrics.counter("alarms.accuracy").inc()

    def _window_p95(self, t: float) -> Optional[float]:
        # incremental over the columnar log: each tick binary-searches
        # the window start from a monotone cursor (O(log n + window)),
        # so telemetry cost no longer grows with total request history
        return self.cosim.proc.recent_percentile(
            t, self.policy.window_s, 95,
            min_requests=self.policy.min_window_requests)

    def _recluster_for_latency(self, t: float, p95: float) -> None:
        """Pick the busiest edge in the window and report its effective
        (training-degraded) capacity to the controller, which re-solves
        HFLOP — load moves off the bottleneck."""
        if self.tel is not None:
            self.tel.audit.record(
                t, "latency_alarm", trigger="windowed_p95_breach",
                outcome="noted",
                evidence={"p95_ms": p95,
                          "threshold_ms": self.policy.p95_threshold_ms,
                          "window_s": self.policy.window_s})
            self.tel.metrics.counter("alarms.latency").inc()
        proc = self.cosim.proc
        edges = proc.edges
        if not edges:
            return
        # bottleneck = edge with the highest assigned request load,
        # in the *topology* numbering — translate before touching the
        # inventory (after a deferred failure re-deploy they differ)
        loads = self.cosim.proc.topo.cluster_loads()
        if not loads:
            return
        bottleneck = max(loads, key=loads.get)
        inv_idx = self._inv_index(bottleneck)
        if inv_idx is None:
            self.actions.append(
                (t, f"latency alarm (p95={p95:.1f}ms) but bottleneck "
                 f"edge {bottleneck} is not in the inventory — skipped"))
            self.last_recluster_t = t            # don't re-log every tick
            return
        inv_edges = self.controller.inventory.edges
        cur = inv_edges[inv_idx].capacity_rps
        # derate from the NOMINAL capacity, not the current value —
        # repeated alarms must not compound toward zero
        nominal = self._nominal_caps.get(inv_idx, cur)
        eff = nominal * (1.0 - self.policy.capacity_derate)
        # never report a capacity that makes the instance infeasible
        lam_total = sum(d.lam for d in self.controller.inventory.devices)
        others = sum(e.capacity_rps for e in inv_edges) - cur
        eff = max(eff, self.policy.feasibility_slack * lam_total - others)
        if eff >= cur * 0.999:
            return                   # no meaningful reduction possible
        if not self._budget_allows(t, "latency recluster"):
            self.last_recluster_t = t            # defer past the cooldown
            return
        self._nominal_caps.setdefault(inv_idx, nominal)
        dep = self.controller.on_capacity_change(inv_idx, float(eff))
        if self._apply(dep, t, reason="latency recluster"):
            self.actions.append(
                (t, f"latency alarm (p95={p95:.1f}ms) -> edge "
                 f"{bottleneck} effective capacity {eff:.2f} rps, "
                 "reclustered"))

    def _restore_capacity(self, t: float) -> None:
        """Training has been idle long enough: the interference the
        derated capacities modeled is gone, so hand the controller its
        nominal rates back and re-cluster once."""
        inv_edges = self.controller.inventory.edges
        items = [(j, cap) for j, cap in sorted(self._nominal_caps.items())
                 if j < len(inv_edges)]
        if not items:
            self._nominal_caps.clear()
            return
        if not self._budget_allows(t, "restore recluster"):
            self.last_recluster_t = t            # defer past the cooldown
            return
        for j, cap in items[:-1]:
            inv_edges[j].capacity_rps = cap
        last_j, last_cap = items[-1]
        dep = self.controller.on_capacity_change(last_j, float(last_cap))
        if self._apply(dep, t, reason="restore recluster"):
            # clear the bookkeeping only once the swap went live — a
            # (defensive) veto keeps the derate on record for a retry
            self._nominal_caps.clear()
            self.actions.append(
                (t, "training idle -> nominal edge capacities restored, "
                 "reclustered"))
