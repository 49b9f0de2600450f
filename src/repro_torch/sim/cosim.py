"""Unified training–inference co-simulation.

Runs continual HFL training rounds and inference serving on the *same*
per-node compute timeline: the round schedule (``fl.hierarchy.
round_schedule``) becomes typed events on the shared event core, each
participating device's local epochs mark it busy (rule R1 offloads its
requests) and claim compute, aggregation uploads occupy the edges (and
the cloud on global rounds), and the interference model stretches
service times for whatever the node still serves.  Inference requests
ride the same heap via the ``RequestProcessor`` that also powers the
inference-only ``routing.simulator``.

An optional reactive loop (``sim.reactive.ReactiveLoop``) watches the
telemetry this engine emits and drives the learning controller's
``on_node_failure`` / ``on_capacity_change`` / ``on_accuracy_alarm``
hooks mid-simulation, swapping re-clustered deployments back in with a
modeled replica-migration cost.

Determinism: all randomness flows through one ``np.random.Generator``
seeded from ``CoSimConfig.seed`` (device speed factors first, then the
arrival streams, then per-request RTT draws in arrival order), so the
same seed yields an identical event trace and request log.

Engines: the heap carries only the sparse *control plane* (round /
epoch / aggregation windows, failures, moves, stragglers, tenant load,
drift, reconfig, telemetry).  With the default ``engine="batched"``
the dense *request plane* is processed in vectorized batches over the
windows between control events (``repro_torch.sim.request_plane``); with
``engine="heap"`` every request rides the heap as two events — the
parity reference.  Routing and service are deterministic here and the
batched RTT draws consume the generator stream in heap order, so the
two engines produce **bit-identical** request logs, reactions and
control traces for the same seed (asserted in
``tests/test_event_engine.py``; admission arithmetic agrees up to a
measure-zero threshold-coincidence caveat — see
``request_plane.bucket_admissions``); only wall-clock differs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.topology import ClusterTopology
from repro_torch.fl.schedule import RoundWindow
from repro_torch.routing.latency import LatencyModel
from repro_torch.routing.rules import EdgeState, RouteDecision
from repro_torch.routing.simulator import RequestLog, RequestProcessor
from repro_torch.serving.workload import poisson_request_arrays
from repro_torch.sim.budget import ReconfigBudget
from repro_torch.sim.budget import BudgetEntry
from repro_torch.sim.events import Event, EventKind, Simulation
from repro_torch.sim.interference import InterferenceConfig, InterferenceModel
from repro_torch.sim.request_plane import TIER_DEVICE
from repro_torch.telemetry import Telemetry, maybe as _maybe_tel

# interference-demand source-name prefixes for load that is *external*
# to the training pipeline — it survives the edge-tier rebuild on a
# re-deploy (a tenant job doesn't vanish because HFL re-clustered)
EXTERNAL_DEMAND_PREFIXES = ("tenant:", "handover:")


@dataclass
class CoSimConfig:
    duration_s: float = 300.0
    seed: int = 0
    rate_scale: float = 1.0
    latency: LatencyModel = field(default_factory=LatencyModel)
    interference: InterferenceConfig = field(
        default_factory=InterferenceConfig)
    speed_spread: float = 0.3        # device heterogeneity: fastest device
    #                                  runs an epoch in (1-spread) x nominal
    telemetry_s: float = 2.0         # reactive monitor tick period
    reconfig_s: float = 5.0          # replica migration duration
    reconfig_penalty_ms: float = 25.0  # per-request cost while migrating
    handover_s: float = 3.0          # device-mobility handover duration
    handover_penalty_ms: float = 15.0  # per-request cost while handing over
    record_trace: bool = True
    engine: str = "batched"          # "batched" | "heap" (parity)
    fuse_windows: bool = True        # fuse request-plane windows across
    #                                  effect-free control events (trace-
    #                                  equivalent; False = flush at every
    #                                  control event, the pre-fusion path)
    telemetry: Optional[Telemetry] = None  # metrics/spans/audit sink;
    #                                  pure observation — event ordering,
    #                                  RNG streams, logs and fingerprints
    #                                  are bit-identical with or without


@dataclass
class CoSimResult:
    log: RequestLog
    trace: List[Tuple[float, str, int]]
    rounds_completed: int
    reconfig_times: List[float]
    mse_series: np.ndarray           # (k, 2) [t, modeled val MSE]
    actions: List[Tuple[float, str]]  # reactive-loop decisions
    budget: Optional[ReconfigBudget] = None  # reconfig accountant, if any
    drop_log: List[Tuple[float, int, int, int]] = field(
        default_factory=list)        # (t, device, round idx, epochs dropped)
    move_log: List[Tuple[float, int, int, int]] = field(
        default_factory=list)        # (t, device, old edge, new edge)
    fault_stats: Dict[str, int] = field(default_factory=dict)
    #                                  chaos accounting: attempts failed,
    #                                  retries, failovers, promotions, ...


class CoSim:
    """One co-simulation run over a topology.  ``schedule`` is the
    training timeline (None -> serving only); ``reactive`` an optional
    ``ReactiveLoop`` bound to a ``LearningController``."""

    def __init__(self, topo: ClusterTopology, cfg: CoSimConfig,
                 schedule: Optional[Sequence[RoundWindow]] = None,
                 reactive=None, budget: Optional[ReconfigBudget] = None):
        self.cfg = cfg
        self.sim = Simulation(record_trace=cfg.record_trace,
                              fuse_windows=cfg.fuse_windows)
        self.sim.flush_gate = self._flush_gate
        self.tel = _maybe_tel(cfg.telemetry)
        self.rng = np.random.default_rng(cfg.seed)
        n = topo.n_devices
        # per-device epoch-time multiplier in [1-spread, 1]: every device
        # finishes its local epochs by the round's nominal compute_end
        self.speed = 1.0 - cfg.speed_spread * self.rng.random(n)
        self.interference = InterferenceModel(cfg.latency, cfg.interference)
        self.proc = RequestProcessor(
            topo, self.rng, latency=cfg.latency, busy_fn=self._busy,
            service_fn=self.interference.service_ms,
            extra_ms_fn=self._request_penalty,
            engine=cfg.engine,
            busy_mask_fn=self._busy_mask,
            stretch_fn=self.interference.stretch_array,
            extra_ms_vec_fn=self._request_penalty_vec,
            telemetry=cfg.telemetry)
        self.proc.bind(self.sim)

        self._busy_count = np.zeros(n, dtype=int)
        self._epochs_left: Dict[Tuple[int, int], np.ndarray] = {}
        # per-window per-device epoch plan [(start, end, token), ...]
        # so a STRAGGLER can re-time the epochs that have not started yet
        self._epoch_sched: Dict[Tuple[int, int],
                                Tuple[RoundWindow,
                                      Dict[int, List[List]]]] = {}
        self._cancelled: Set[int] = set()   # tokens of re-timed epochs
        self._tok = 0
        self._straggler_info: Dict[int, List[Tuple[int, RoundWindow,
                                                   float]]] = {}
        self._handover_until = np.full(n, -math.inf)
        # injection-time edge id -> current topology id (None once the
        # host is gone).  Scheduled events (moves, tenant jobs,
        # failures) name edges as they were numbered when scheduled; a
        # failure-driven recluster renumbers the topology, and the
        # reactive loop composes that shift into this alias so pending
        # events keep landing on the same physical host (or are dropped
        # when it is dead).
        self.edge_alias: Dict[int, Optional[int]] = {
            j: j for j in range(topo.n_edges)}
        self._active_rounds = 0
        self._active_aggs: Set[Tuple[int, int]] = set()
        self._sched_count = 0
        # chaos subsystem (repro_torch.sim.faults): inert until
        # schedule_faults arms it — no draws, no events, no branches on
        # the request path, so fingerprints stay bit-identical to a
        # fault-free build (tests/test_faults.py pins this)
        self._faults_armed = False
        self._standby_enabled = True
        self.quorum = 0.0                # min fraction of devices whose
        #                                  edge is up for round credit
        self.max_stale_rounds = 2        # staleness bound: consecutive
        #                                  below-quorum rounds tolerated
        self.stale_rounds = 0
        self.rounds_below_quorum = 0
        self.stale_bound_exceeded = 0
        self.last_round_quorum_ok = True
        self.standby_promotions = 0
        # fault-window bookkeeping: widx -> (kind, param, resolved edge
        # ids at start time); standby snapshots per widx for restore
        self._active_faults: Dict[int, Tuple[str, float, Tuple[int, ...]]]\
            = {}
        self._standby: Dict[int, List[Tuple[int, int, np.ndarray]]] = {}
        self.fault_log: List[Tuple[float, str, str,
                                   Tuple[int, ...]]] = []
        self.rounds_completed = 0
        self.last_round_end = -math.inf
        self.reconfig_until = -math.inf
        self.reconfig_times: List[float] = []
        self.drop_log: List[Tuple[float, int, int, int]] = []
        self.move_log: List[Tuple[float, int, int, int]] = []
        self.tenant_log: List[Tuple[float, int, str, float]] = []
        self.reactive = reactive
        self.budget = budget
        if budget is not None and self.tel is not None:
            # mirror the budget ledger into registry metrics: every
            # charge/veto updates the spend counters and gauges below
            m = self.tel.metrics
            m.gauge("reconfig.budget_total").set(budget.total)
            m.gauge("reconfig.budget_spent").set(budget.spent)
            m.gauge("reconfig.budget_overrun").set(0.0)
            # the observer hook only mirrors charges into metrics —
            # the ledger's accept/veto decisions never read it
            # (sanctioned site, see CONTRACTS.md)
            budget.observer = self._on_budget_charge  # contract: ok TEL001

        s = self.sim
        s.on(EventKind.ROUND_START, self._on_round_start)
        s.on(EventKind.EPOCH_START, self._on_epoch_start)
        s.on(EventKind.EPOCH_END, self._on_epoch_end)
        s.on(EventKind.AGG_START, self._on_agg_start)
        s.on(EventKind.AGG_END, self._on_agg_end)
        s.on(EventKind.ROUND_END, self._on_round_end)
        s.on(EventKind.NODE_FAILURE, self._on_node_failure)
        s.on(EventKind.CAPACITY_CHANGE, self._on_capacity_change)
        s.on(EventKind.RECONFIG_END, self._on_reconfig_end)
        s.on(EventKind.STRAGGLER, self._on_straggler)
        s.on(EventKind.DEVICE_MOVE, self._on_device_move)
        s.on(EventKind.TENANT_LOAD, self._on_tenant_load)
        s.on(EventKind.FAULT_START, self._on_fault_start)
        s.on(EventKind.FAULT_END, self._on_fault_end)
        if self.tel is not None:
            # observation-only handler: DRIFT_ONSET otherwise has no
            # CoSim handler (the reactive loop registers its own).
            # Handlers never affect the trace or flush decisions, so
            # registering one conditionally preserves determinism.
            s.on(EventKind.DRIFT_ONSET, self._on_drift_telemetry)

        arr_t, arr_dev = poisson_request_arrays(
            topo.lam * cfg.rate_scale, cfg.duration_s, self.rng)
        if cfg.engine == "heap":
            for t, d in zip(arr_t, arr_dev):
                s.schedule(t, EventKind.REQUEST_ARRIVAL, node=int(d))
        else:
            self.proc.add_arrivals(arr_t, arr_dev)
        if schedule is not None:
            self.add_training(schedule)
        if reactive is not None:
            reactive.bind(self)

    # -- environment / workload injection -----------------------------------

    def add_training(self, windows: Sequence[RoundWindow]) -> int:
        """Schedule a training burst: round/epoch/aggregation events for
        every window.  Returns the schedule id (sources in the
        interference model are tagged with it, so overlapping bursts
        compose instead of clobbering each other)."""
        sid = self._sched_count
        self._sched_count += 1
        for w in windows:
            self.sim.schedule(w.start, EventKind.ROUND_START,
                              payload=(sid, w))
            self.sim.schedule(w.compute_end, EventKind.AGG_START,
                              payload=(sid, w))
            self.sim.schedule(w.upload_end, EventKind.AGG_END,
                              payload=(sid, w))
            self.sim.schedule(w.upload_end, EventKind.ROUND_END,
                              payload=(sid, w))
        return sid

    def schedule_failure(self, t: float, edge_id: int) -> None:
        self.sim.schedule(t, EventKind.NODE_FAILURE, node=edge_id)

    def schedule_capacity_change(self, t: float, edge_id: int,
                                 new_rps: float) -> None:
        self.sim.schedule(t, EventKind.CAPACITY_CHANGE, node=edge_id,
                          payload=float(new_rps))

    def schedule_drift(self, t: float, drift_mse: Optional[float] = None,
                       ) -> None:
        self.sim.schedule(t, EventKind.DRIFT_ONSET, payload=drift_mse)

    def schedule_straggler(self, t: float, device_id: int,
                           factor: float) -> None:
        """At ``t`` device ``device_id``'s not-yet-started local epochs
        take ``factor``x their nominal duration (thermal throttling, a
        co-located job, a slow link) for every round active at ``t``."""
        if factor <= 0.0:
            raise ValueError(f"straggler factor must be positive, "
                             f"got {factor}")
        self.sim.schedule(t, EventKind.STRAGGLER, node=int(device_id),
                          payload=float(factor))

    def schedule_device_move(self, t: float, device_id: int,
                             new_edge: int) -> None:
        """Device mobility: at ``t`` the device's LAN association changes
        to ``new_edge`` (its requests route there), paying a modeled
        handover — ``handover_penalty_ms`` per request for
        ``handover_s`` seconds plus ``handover_share`` demand on the
        receiving edge."""
        self.sim.schedule(t, EventKind.DEVICE_MOVE, node=int(device_id),
                          payload=int(new_edge))

    def schedule_tenant_load(self, t: float, edge_id: int, share: float,
                             duration_s: Optional[float] = None,
                             tenant: str = "t0") -> None:
        """Multi-tenant edge: a third-party job claims ``share`` of edge
        ``edge_id``'s compute from ``t`` (for ``duration_s`` seconds, or
        until a later call sets the same tenant's share to 0)."""
        src = f"tenant:{tenant}"
        self.sim.schedule(t, EventKind.TENANT_LOAD, node=int(edge_id),
                          payload=(src, float(share)))
        if duration_s is not None:
            self.sim.schedule(t + duration_s, EventKind.TENANT_LOAD,
                              node=int(edge_id), payload=(src, 0.0))

    def schedule_faults(self, plan, retry=None, standby: bool = True,
                        quorum: float = 0.0,
                        max_stale_rounds: int = 2):
        """Arm the chaos subsystem: compile ``plan`` (a
        ``repro_torch.sim.faults.FaultPlan``) into fault windows using the
        shared per-run generator — the draws happen *here*, after the
        speed and arrival draws, so both engines see the identical
        timeline — and schedule a ``FAULT_START``/``FAULT_END`` pair
        per window.  ``retry`` is the request plane's
        :class:`~repro_torch.sim.request_plane.RetryPolicy` (default policy
        when None); ``standby`` enables aggregator warm-standby
        promotion on crash windows; ``quorum`` > 0 enables
        partial-aggregation round credit with ``max_stale_rounds`` as
        the staleness bound.  Returns the compiled windows."""
        from repro_torch.sim.faults import compile_plan
        from repro_torch.sim.request_plane import RetryPolicy
        self.proc.enable_faults(retry if retry is not None
                                else RetryPolicy())
        self._faults_armed = True
        self._standby_enabled = bool(standby)
        self.quorum = float(quorum)
        self.max_stale_rounds = int(max_stale_rounds)
        wins = compile_plan(plan, self.rng,
                            n_edges=self.proc.topo.n_edges,
                            duration_s=self.cfg.duration_s)
        for k, w in enumerate(wins):
            node = w.edges[0] if w.edges else -1
            self.sim.schedule(w.t0, EventKind.FAULT_START, node=node,
                              payload=(k, w))
            self.sim.schedule(w.t1, EventKind.FAULT_END, node=node,
                              payload=(k, w))
        if self.tel is not None:
            self.tel.metrics.gauge("faults.windows_planned").set(
                float(len(wins)))
        return wins

    # -- training timeline handlers -----------------------------------------

    def _on_round_start(self, sim: Simulation, ev: Event) -> None:
        sid, w = ev.payload
        self._active_rounds += 1
        nominal = (w.compute_end - w.start) / max(w.local_epochs, 1)
        assign = self.proc.topo.assign
        participants = np.nonzero(assign >= 0)[0]
        if participants.size == 0:   # flat FL: every device trains
            participants = np.arange(len(assign))
        left = np.zeros(len(assign), dtype=int)
        per_dev: Dict[int, List[List]] = {}
        for i in participants:
            e_i = nominal * self.speed[i]
            plan = []
            for k in range(w.local_epochs):
                tok = self._tok
                self._tok += 1
                s_k = w.start + k * e_i
                sim.schedule(s_k, EventKind.EPOCH_START, node=int(i),
                             payload=(sid, w, tok))
                sim.schedule(s_k + e_i, EventKind.EPOCH_END, node=int(i),
                             payload=(sid, w, tok))
                plan.append([s_k, s_k + e_i, tok])
            per_dev[int(i)] = plan
            left[i] = w.local_epochs
        self._epochs_left[(sid, w.index)] = left
        self._epoch_sched[(sid, w.index)] = (w, per_dev)
        if self.tel is not None:
            self.tel.tracer.open(
                ("round", sid, w.index), f"round {w.index}", ev.t,
                cat="round", tid=sid, sid=sid,
                local_epochs=w.local_epochs, is_global=bool(w.is_global),
                participants=int(participants.size))
            self.tel.metrics.counter("training.rounds_started").inc()

    def _on_epoch_start(self, sim: Simulation, ev: Event) -> None:
        sid, w, tok = ev.payload
        if tok in self._cancelled:
            return                   # re-timed or dropped by a straggler
        i = ev.node
        self._busy_count[i] += 1
        self.interference.set_demand(("device", i), "epoch",
                                     self.cfg.interference.device_train_share)
        if self.tel is not None:
            # one track per device (offset past the round/agg tracks);
            # cancelled tokens returned above, so only real epochs span
            self.tel.tracer.open(("epoch", tok), f"epoch d{i}", ev.t,
                                 cat="epoch", tid=100 + i, device=i,
                                 round=w.index, sid=sid)

    def _on_epoch_end(self, sim: Simulation, ev: Event) -> None:
        sid, w, tok = ev.payload
        if tok in self._cancelled:
            return
        i = ev.node
        self._busy_count[i] -= 1
        if self.tel is not None:
            self.tel.tracer.close(("epoch", tok), ev.t)
            self.tel.metrics.counter("training.epochs_completed").inc()
        left = self._epochs_left.get((sid, w.index))
        if left is None:             # straggler epoch outlived its round
            if self._busy_count[i] == 0:
                self.interference.set_demand(("device", i), "epoch", 0.0)
            return
        left[i] -= 1
        if self._busy_count[i] == 0:
            self.interference.set_demand(("device", i), "epoch", 0.0)
            if left[i] == 0:
                # epochs done, round still open: residual work (checkpoint,
                # next-window data prep) degrades on-device serving
                self.interference.set_demand(
                    ("device", i), f"res{sid}:{w.index}",
                    self.cfg.interference.device_residual_share)

    def _on_agg_start(self, sim: Simulation, ev: Event) -> None:
        sid, w = ev.payload
        self._active_aggs.add((sid, w.index))
        share = self.cfg.interference.edge_agg_share
        for j in self.proc.edges:
            self.interference.set_demand(("edge", j), f"agg{sid}:{w.index}",
                                         share)
        if w.is_global:
            self.interference.set_demand(("cloud", 0),
                                         f"agg{sid}:{w.index}",
                                         self.cfg.interference.
                                         cloud_agg_share)
        if self.tel is not None:
            self.tel.tracer.open(("agg", sid, w.index), f"agg {w.index}",
                                 ev.t, cat="aggregation", tid=sid,
                                 sid=sid, is_global=bool(w.is_global))

    def _on_agg_end(self, sim: Simulation, ev: Event) -> None:
        sid, w = ev.payload
        self._active_aggs.discard((sid, w.index))
        src = f"agg{sid}:{w.index}"
        for j in self.proc.edges:
            self.interference.set_demand(("edge", j), src, 0.0)
        self.interference.set_demand(("cloud", 0), src, 0.0)
        if self.tel is not None:
            self.tel.tracer.close(("agg", sid, w.index), ev.t)
            self.tel.metrics.counter("training.aggs_completed").inc()

    def _on_round_end(self, sim: Simulation, ev: Event) -> None:
        sid, w = ev.payload
        self._active_rounds -= 1
        src = f"res{sid}:{w.index}"
        for i in range(len(self._busy_count)):
            self.interference.set_demand(("device", i), src, 0.0)
        self._epochs_left.pop((sid, w.index), None)
        self._epoch_sched.pop((sid, w.index), None)
        self.rounds_completed += 1
        self.last_round_end = sim.now
        # partial-aggregation quorum: a round whose upload window closed
        # with too many devices behind a down aggregator aggregates a
        # partial model — it completes, but earns no accuracy credit
        # (the reactive loop checks last_round_quorum_ok, set here
        # because CoSim's handler runs before the loop's) and counts
        # toward the staleness bound
        self.last_round_quorum_ok = True
        if self._faults_armed and self.quorum > 0.0:
            assign = self.proc.topo.assign
            down = self.proc._down
            frac_ok = 1.0
            if down and assign.size:
                bad = np.isin(assign, np.array(sorted(down),
                                               dtype=assign.dtype))
                frac_ok = 1.0 - float(np.mean(bad))
            if frac_ok < self.quorum:
                self.last_round_quorum_ok = False
                self.rounds_below_quorum += 1
                self.stale_rounds += 1
                if self.stale_rounds > self.max_stale_rounds:
                    self.stale_bound_exceeded += 1
                if self.tel is not None:
                    self.tel.metrics.counter("rounds.below_quorum").inc()
                    self.tel.metrics.gauge("rounds.stale_streak").set(
                        float(self.stale_rounds))
            else:
                self.stale_rounds = 0
        if self.tel is not None:
            self.tel.tracer.close(("round", sid, w.index), ev.t)
            self.tel.metrics.counter("training.rounds_completed").inc()

    def resolve_edge(self, edge_id: int) -> Optional[int]:
        """Current topology id of an edge named by its injection-time
        id; None when the host has been dropped since."""
        return self.edge_alias.get(int(edge_id))

    def remap_edge_alias(self, remap) -> None:
        """Compose a topology renumbering (old current id -> new
        current id, None once dead) into the injection-time alias.
        Keys are kept so a dead host stays distinguishable from an id
        that never existed."""
        self.edge_alias = {
            k: (None if v is None else remap(v))
            for k, v in self.edge_alias.items()}

    def _on_node_failure(self, sim: Simulation, ev: Event) -> None:
        cur = self.resolve_edge(ev.node)
        if cur is not None:
            self.proc.fail_edge(cur)
        if self.tel is not None:
            self.tel.tracer.instant("node_failure", ev.t, cat="fault",
                                    edge=ev.node, resolved_edge=cur)
            self.tel.metrics.counter("events.node_failure").inc()

    # -- chaos / fault-domain handlers --------------------------------------

    def _on_fault_start(self, sim: Simulation, ev: Event) -> None:
        from repro_torch.sim.faults import DOWN_KINDS, FAULT_CRASH
        widx, w = ev.payload
        # resolve injection-time edge ids to the current topology once,
        # at window open — a mid-window recluster must not retarget it
        resolved = tuple(cur for cur in
                         (self.resolve_edge(e) for e in w.edges)
                         if cur is not None and cur in self.proc.edges)
        self._active_faults[widx] = (w.kind, w.param, resolved)
        if w.kind == FAULT_CRASH and self._standby_enabled:
            for cur in resolved:
                self._promote_standby(ev.t, widx, cur)
        self._refresh_fault_state()
        self.fault_log.append((ev.t, "start", w.kind, resolved))
        if self.tel is not None:
            self.tel.tracer.instant("fault_start", ev.t, cat="fault",
                                    kind=w.kind, edges=list(resolved),
                                    param=w.param)
            self.tel.metrics.counter("faults.windows_started").inc()
            if w.kind in DOWN_KINDS:
                self.tel.metrics.counter("faults.edges_down").inc(
                    float(len(resolved)))

    def _on_fault_end(self, sim: Simulation, ev: Event) -> None:
        widx, w = ev.payload
        entry = self._active_faults.pop(widx, None)
        if entry is None:
            return
        for failed, backup, moved in self._standby.pop(widx, []):
            # devices still parked on the standby go home; a recluster
            # in between rewrote the assignment wholesale, in which
            # case nothing matches and nothing moves
            assign = self.proc.topo.assign
            if failed in self.proc.edges:
                back = moved[assign[moved] == backup]
                assign[back] = failed
        self._refresh_fault_state()
        self.fault_log.append((ev.t, "end", w.kind, entry[2]))
        if self.tel is not None:
            self.tel.tracer.instant("fault_end", ev.t, cat="fault",
                                    kind=w.kind, edges=list(entry[2]))
            self.tel.metrics.counter("faults.windows_ended").inc()

    def _refresh_fault_state(self) -> None:
        """Recompute the request plane's fault view from the currently
        open windows — overlapping windows compose (union of down
        edges, max of drop/spike params) and closing one window never
        clears a fault another still imposes."""
        from repro_torch.sim.faults import DOWN_KINDS, FAULT_DROP, FAULT_SPIKE
        proc = self.proc
        down: Set[int] = set()
        drop: Dict[int, float] = {}
        spike: Dict[int, float] = {}
        for widx in sorted(self._active_faults):
            kind, param, edges = self._active_faults[widx]
            for cur in edges:
                if kind in DOWN_KINDS:
                    down.add(cur)
                elif kind == FAULT_DROP:
                    drop[cur] = max(drop.get(cur, 0.0), param)
                elif kind == FAULT_SPIKE:
                    spike[cur] = max(spike.get(cur, 0.0), param)
        proc._down = down
        proc._drop_p = drop
        proc._spike_ms = spike
        proc._recompute_fault_active()

    def _promote_standby(self, t: float, widx: int, failed: int) -> None:
        """Aggregator warm-standby promotion: the crashed edge's
        devices re-associate to a healthy backup edge for the outage —
        their R1 traffic and round uploads land there — instead of
        forcing a full budget-metered recluster.  Restored at
        ``FAULT_END``; a permanent ``NODE_FAILURE`` still takes the
        recluster path."""
        from repro_torch.sim.faults import DOWN_KINDS
        already = self._active_faults  # down set not yet refreshed
        down_now = {c for e in already.values()
                    if e[0] in DOWN_KINDS for c in e[2]}
        backups = [j for j in sorted(self.proc.edges)
                   if j != failed and j not in down_now]
        if not backups:
            return
        backup = backups[0]
        assign = self.proc.topo.assign
        moved = np.flatnonzero(assign == failed)
        if moved.size == 0:
            return
        assign[moved] = backup
        self._standby.setdefault(widx, []).append(
            (failed, backup, moved))
        self.standby_promotions += 1
        if self.tel is not None:
            self.tel.tracer.instant("standby_promotion", t, cat="fault",
                                    failed_edge=failed, backup=backup,
                                    devices=int(moved.size))
            self.tel.metrics.counter("faults.standby_promotions").inc()

    def _on_capacity_change(self, sim: Simulation, ev: Event) -> None:
        """Apply the new rate to the edge's admission state even without
        a reactive loop (which would additionally re-cluster): the edge
        host genuinely got slower/faster, reactions or not."""
        cur = self.resolve_edge(ev.node)
        st = self.proc.edges.get(cur) if cur is not None else None
        if st is not None:
            st.capacity_rps = float(ev.payload)
            st.tokens = min(st.tokens, st.capacity_rps * st.burst_s)
        if self.tel is not None:
            self.tel.tracer.instant("capacity_change", ev.t, cat="fault",
                                    edge=ev.node,
                                    new_rps=float(ev.payload))
            self.tel.metrics.counter("events.capacity_change").inc()

    # -- scenario events: stragglers, mobility, multi-tenant edges ----------

    def _on_straggler(self, sim: Simulation, ev: Event) -> None:
        """Re-time the device's not-yet-started epochs in every active
        round: each takes ``factor``x its planned duration and they run
        back-to-back from the straggle onset (or from the end of the
        epoch currently in flight).  A reactive loop registered after
        this handler reads :meth:`straggler_info` for the projected
        finish times and applies its deadline-based drop policy."""
        i, factor, t = int(ev.node), float(ev.payload), ev.t
        info: List[Tuple[int, RoundWindow, float]] = []
        for (sid, widx), (w, per_dev) in self._epoch_sched.items():
            plan = per_dev.get(i)
            if not plan:
                continue
            kept = [e for e in plan if e[0] <= t]
            pending = [e for e in plan if e[0] > t]
            if not pending:
                continue             # nothing left to slow this round
            resume = max(t, kept[-1][1]) if kept else t
            for start, end, tok in pending:
                self._cancelled.add(tok)
                dur = (end - start) * factor
                new_tok = self._tok
                self._tok += 1
                sim.schedule(resume, EventKind.EPOCH_START, node=i,
                             payload=(sid, w, new_tok))
                sim.schedule(resume + dur, EventKind.EPOCH_END, node=i,
                             payload=(sid, w, new_tok))
                kept.append([resume, resume + dur, new_tok])
                resume += dur
            per_dev[i] = kept
            info.append((sid, w, kept[-1][1]))
        self._straggler_info[i] = info
        if self.tel is not None:
            self.tel.tracer.instant("straggler", t, cat="fault",
                                    device=i, factor=factor,
                                    rounds_affected=len(info))
            self.tel.metrics.counter("events.straggler").inc()

    def straggler_info(self, device_id: int,
                       ) -> List[Tuple[int, RoundWindow, float]]:
        """(schedule id, round window, projected epoch-finish time) per
        round the last STRAGGLER event on ``device_id`` touched."""
        return list(self._straggler_info.get(int(device_id), []))

    def drop_from_round(self, device_id: int, sid: int, round_index: int,
                        ) -> int:
        """Deadline-based partial aggregation: cancel the device's
        not-yet-started epochs in one round (the epoch in flight, if
        any, finishes and is wasted work).  Returns the number of epochs
        dropped."""
        entry = self._epoch_sched.get((sid, round_index))
        if entry is None:
            return 0
        _, per_dev = entry
        now = self.sim.now
        dropped, kept = 0, []
        for start, end, tok in per_dev.get(int(device_id), []):
            if start > now and tok not in self._cancelled:
                self._cancelled.add(tok)
                dropped += 1
            else:
                kept.append([start, end, tok])
        per_dev[int(device_id)] = kept
        if dropped:
            self.drop_log.append((now, int(device_id), int(round_index),
                                  dropped))
        return dropped

    def _on_device_move(self, sim: Simulation, ev: Event) -> None:
        """Mobility handover: re-home the device's requests on the new
        LAN edge and pay the modeled handover cost.  A reactive loop
        additionally updates the controller inventory (and may
        re-cluster, budget permitting).  The target edge is named by
        its injection-time id; if that host has been dropped since, the
        handover is abandoned (the device stays where it is)."""
        i, j_raw, t = int(ev.node), int(ev.payload), ev.t
        assign = self.proc.topo.assign
        if not (0 <= i < len(assign)):
            return
        if j_raw >= 0 and j_raw not in self.edge_alias:
            raise ValueError(f"device {i} moved to unknown edge {j_raw} "
                             f"(never part of the topology)")
        j_new = self.resolve_edge(j_raw) if j_raw >= 0 else j_raw
        if j_new is None:
            return                   # target host died before the handover
        j_old = int(assign[i])
        assign[i] = j_new
        if j_new >= 0 and j_new not in self.proc.edges:
            # the target edge had no cluster yet: open admission state
            # with its physical capacity
            r = self.proc.topo.r
            self.proc.edges[j_new] = EdgeState(
                capacity_rps=float(r[j_new]) if r.size else np.inf)
        # a device has at most one handover in flight: a new move
        # supersedes the previous one's edge load everywhere
        src = f"handover:{i}"
        self.interference.clear_tier("edge", source=src)
        self._handover_until[i] = t + self.cfg.handover_s
        if j_new >= 0:
            self.interference.set_demand(
                ("edge", j_new), src, self.cfg.interference.handover_share)
            sim.schedule(t + self.cfg.handover_s, EventKind.TENANT_LOAD,
                         node=j_raw, payload=(src, 0.0))
        self.move_log.append((t, i, j_old, j_new))
        if self.tel is not None:
            self.tel.tracer.instant("device_move", t, cat="mobility",
                                    device=i, old_edge=j_old,
                                    new_edge=j_new)
            self.tel.metrics.counter("events.device_move").inc()

    def _on_tenant_load(self, sim: Simulation, ev: Event) -> None:
        """External edge demand change: a third-party tenant job starts
        (share > 0) or ends (share == 0) on the edge — also reused to
        clear handover load.  Edge named by injection-time id (dropped
        hosts swallow their jobs); a handover clear is skipped when a
        newer handover of the same device extended the window."""
        src, share = ev.payload
        src = str(src)
        if src.startswith("handover:") and share == 0.0:
            dev = int(src.split(":", 1)[1])
            if ev.t < self._handover_until[dev] - 1e-9:
                return               # superseded by a newer handover
        j = self.resolve_edge(ev.node)
        if j is None:
            return
        self.interference.set_demand(("edge", j), src, float(share))
        self.tenant_log.append((ev.t, j, src, float(share)))
        if self.tel is not None:
            self.tel.metrics.counter("events.tenant_load").inc()

    def _on_drift_telemetry(self, sim: Simulation, ev: Event) -> None:
        self.tel.tracer.instant("drift_onset", ev.t, cat="fault",
                                drift_mse=ev.payload)
        self.tel.metrics.counter("events.drift_onset").inc()

    def _on_budget_charge(self, entry: BudgetEntry) -> None:
        """ReconfigBudget observer: mirror every ledger entry into the
        registry (spend/deferral counters + running budget gauges) so
        grid cells report budget accounting as metrics, not only as
        scenario-result fields."""
        m = self.tel.metrics
        m.counter("reconfig.attempts").inc()
        if entry.applied:
            m.counter("reconfig.applied").inc()
            m.counter("reconfig.cost_spent").inc(entry.cost)
        else:
            m.counter("reconfig.deferred").inc()
        if entry.forced:
            m.counter("reconfig.forced").inc()
        b = self.budget
        m.gauge("reconfig.budget_spent").set(b.spent)
        m.gauge("reconfig.budget_remaining").set(b.remaining)
        m.gauge("reconfig.budget_overrun").set(max(b.spent - b.total, 0.0))

    # -- reactive-deployment plumbing ---------------------------------------

    def reconfig_cost(self, deployment=None,
                      n_edges: Optional[int] = None) -> float:
        """Modeled cost of one deployment swap, in edge-compute-seconds:
        every open edge of the incoming topology carries
        ``migration_share`` demand for ``reconfig_s`` seconds.  Pass
        ``n_edges`` to bound the cost *before* solving (the reactive
        loop pre-checks the budget against the inventory size — an
        upper bound on open edges — so a swap is never vetoed after the
        controller has already been mutated)."""
        if n_edges is None:
            topo = deployment.topology if deployment is not None else \
                self.proc.topo
            n_edges = len(topo.open_edges)
        return (self.cfg.reconfig_s
                * self.cfg.interference.migration_share * max(n_edges, 1))

    def apply_deployment(self, deployment, reason: str = "recluster",
                         forced: bool = False,
                         absorb: bool = False) -> bool:
        """Swap in a re-clustered deployment mid-simulation, paying a
        modeled reconfiguration cost: replicas migrate for
        ``reconfig_s`` seconds during which edges carry migration load
        and every edge-touching request pays ``reconfig_penalty_ms``.

        When a :class:`ReconfigBudget` is attached, the swap is metered
        first — an unaffordable, non-``forced`` swap is vetoed (returns
        False, the deployment does NOT go live).  ``absorb=True`` folds
        the swap into a migration window that is still open (a failure
        recluster superseding an in-flight swap): the budget is *not*
        charged again — the running migration already paid — the
        migration clock just restarts on the new target.

        With telemetry attached, every attempt lands in the decision
        audit log: trigger (the ``reason`` string the reactive loop
        passes), modeled migration cost, whether the budget was
        charged, and applied / forced (overrun) / absorbed / vetoed
        outcome."""
        t = self.sim.now
        cost = self.reconfig_cost(deployment)
        if absorb:
            cost = 0.0               # in-flight window already paid
        affordable = self.budget is None or self.budget.can_afford(cost)
        if self.budget is not None and not absorb and not self.budget.charge(
                t, cost, reason, forced=forced):
            if self.tel is not None:
                self.tel.audit.record(
                    t, "deployment_swap", trigger=reason,
                    outcome="vetoed", cost=cost, charged=False,
                    evidence={"budget_remaining": self.budget.remaining,
                              "budget_total": self.budget.total})
            return False
        self.proc.set_topology(deployment.topology)
        # training demands were keyed by old edge ids: rebuild the edge
        # tier (external tenant/handover load stays — a third-party job
        # doesn't vanish because HFL re-clustered)
        self.interference.clear_tier(
            "edge", keep_prefixes=EXTERNAL_DEMAND_PREFIXES)
        share = self.cfg.interference.edge_agg_share
        for sid, idx in self._active_aggs:
            for j in self.proc.edges:
                self.interference.set_demand(("edge", j),
                                             f"agg{sid}:{idx}", share)
        for j in self.proc.edges:
            self.interference.set_demand(
                ("edge", j), "migration",
                self.cfg.interference.migration_share)
        self.reconfig_until = t + self.cfg.reconfig_s
        self.reconfig_times.append(t)
        self.sim.schedule(self.reconfig_until, EventKind.RECONFIG_END)
        if self.tel is not None:
            evidence = {"n_edges": len(self.proc.topo.open_edges)}
            if self.budget is not None:
                evidence["budget_remaining"] = self.budget.remaining
            self.tel.audit.record(
                t, "deployment_swap", trigger=reason,
                outcome=("absorbed" if absorb
                         else "applied" if affordable else "forced"),
                cost=cost, charged=self.budget is not None and not absorb,
                forced=forced, evidence=evidence)
            # migration window has a known duration — record it whole
            self.tel.tracer.complete(
                "deployment swap", t, self.cfg.reconfig_s,
                cat="reconfig", tid=50, trigger=reason, cost=cost)
            self.tel.metrics.counter("reconfig.swaps").inc()
        return True

    def _on_reconfig_end(self, sim: Simulation, ev: Event) -> None:
        if sim.now >= self.reconfig_until:
            self.interference.clear_tier("edge", "migration")

    # -- pluggable policies for the request processor -----------------------

    def _flush_gate(self, ev: Event) -> Optional[bool]:
        """Dynamic refinement of the static window-fusion table
        (``events.EVENT_EFFECTS``): an epoch boundary only mutates
        routing inputs when it actually flips the device's busy flag.
        A cancelled (straggler-re-timed / deadline-dropped) epoch's
        events are no-ops outright; an ``EPOCH_START`` on an
        already-busy device, or an ``EPOCH_END`` that leaves other
        epochs in flight (overlapping training bursts), changes neither
        the busy mask nor the device's ``epoch`` interference demand —
        those windows fuse.  Decided strictly from state the handlers
        have not yet touched."""
        k = ev.kind
        if k is EventKind.EPOCH_START or k is EventKind.EPOCH_END:
            tok = ev.payload[2]
            if tok in self._cancelled:
                return False
            busy = self._busy_count[ev.node]
            return busy == 0 if k is EventKind.EPOCH_START else busy <= 1
        return None

    @property
    def training_active(self) -> bool:
        return self._active_rounds > 0

    def _busy(self, i: int, t: float) -> bool:
        return self._busy_count[i] > 0

    def _busy_mask(self, devices: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`_busy` for the batched request plane (the
        busy counts change only at control events, so one lookup at
        flush time covers the whole window)."""
        return self._busy_count[devices] > 0

    def _request_penalty(self, dec: RouteDecision, t: float,
                         device: int) -> float:
        extra = 0.0
        if t < self.reconfig_until and dec.edge is not None:
            extra += self.cfg.reconfig_penalty_ms
        # handover churn hits the network path, not on-device serving
        if t < self._handover_until[device] and dec.tier != "device":
            extra += self.cfg.handover_penalty_ms
        return extra

    def _request_penalty_vec(self, ts: np.ndarray, devices: np.ndarray,
                             tiers: np.ndarray, edge_ids: np.ndarray,
                             ) -> np.ndarray:
        """Vectorized :meth:`_request_penalty`: ``edge_ids >= 0`` marks
        requests whose route touched an edge (R1 admission or R3
        forwarding), ``tiers`` uses the request-plane TIER codes."""
        extra = np.zeros(ts.size)
        extra[(edge_ids >= 0) & (ts < self.reconfig_until)] += \
            self.cfg.reconfig_penalty_ms
        extra[(tiers != TIER_DEVICE)
              & (ts < self._handover_until[devices])] += \
            self.cfg.handover_penalty_ms
        return extra

    # -- run ----------------------------------------------------------------

    def run(self) -> CoSimResult:
        self.sim.run(until=self.cfg.duration_s)
        if self.tel is not None:
            m = self.tel.metrics
            m.gauge("sim.duration_s").set(self.sim.now)
            m.gauge("sim.fused_windows").set(self.sim.fused_windows)
            m.gauge("sim.rounds_completed").set(self.rounds_completed)
        mse = (np.asarray(self.reactive.mse_series)
               if self.reactive is not None and self.reactive.mse_series
               else np.zeros((0, 2)))
        actions = (list(self.reactive.actions)
                   if self.reactive is not None else [])
        fault_stats: Dict[str, int] = {}
        if self._faults_armed:
            p = self.proc
            fault_stats = {
                "fault_attempts": p.fault_attempts,
                "fault_drops": p.fault_drops,
                "retries_scheduled": p.retries_scheduled,
                "retries_dispatched": p.retries_dispatched,
                "retries_pending": (p.retries_scheduled
                                    - p.retries_dispatched),
                "failovers": p.failovers,
                "standby_promotions": self.standby_promotions,
                "rounds_below_quorum": self.rounds_below_quorum,
                "stale_bound_exceeded": self.stale_bound_exceeded,
            }
        return CoSimResult(log=self.proc.log(), trace=list(self.sim.trace),
                           rounds_completed=self.rounds_completed,
                           reconfig_times=list(self.reconfig_times),
                           mse_series=mse, actions=actions,
                           budget=self.budget,
                           drop_log=list(self.drop_log),
                           move_log=list(self.move_log),
                           fault_stats=fault_stats)
