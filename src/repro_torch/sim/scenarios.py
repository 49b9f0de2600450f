"""Scenario engine on the co-simulation event core.

A :class:`Scenario` is a deterministic event-injection recipe — it
schedules typed perturbations (stragglers, device mobility, tenant
jobs, node failures, drift) onto a freshly built :class:`CoSim` and
nothing else, so the same scenario composes with any policy:

  static    no reactive loop — the initial deployment rides it out
  reactive  unconstrained reactive loop (no reconfiguration budget)
  budgeted  reactive loop metered by a :class:`ReconfigBudget` —
            optional reclusterings are deferred once the modeled
            migration spend hits the cap

:func:`run_scenario` wires the standard hot-zone continuum (the Fig. 7
setup: 20 devices, 4 edges, one hot cluster) through inventory ->
controller -> reactive loop -> CoSim, injects the scenario, runs it,
and summarizes latency, training progress and budget spend.  Every
piece of randomness flows through generators seeded from the scenario
seed, so a (scenario, policy, seed) triple reproduces its event trace
bit-for-bit — asserted by :meth:`ScenarioResult.fingerprint` in the
tests and the ``perf_scenarios`` benchmark grid.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.topology import ClusterTopology
from repro_torch.routing.latency import LatencyModel
from repro_torch.routing.simulator import RequestLog
from repro_torch.fl.schedule import round_schedule
from repro_torch.orchestration import Inventory, LearningController
from repro_torch.orchestration.controller import Deployment
from repro_torch.sim.budget import ReconfigBudget
from repro_torch.sim.cosim import CoSim, CoSimConfig
from repro_torch.sim.events import control_trace
from repro_torch.sim.faults import (DomainOutagePlan, DropBurstPlan,
                              EdgeOutagePlan, FaultPlan, PartitionPlan)
from repro_torch.sim.reactive import ReactiveLoop, ReactivePolicy

POLICIES = ("static", "reactive", "budgeted")


@dataclass(frozen=True)
class Scenario:
    """A named, deterministic perturbation recipe over a built CoSim."""
    name: str
    description: str
    inject: Callable[[CoSim], None]


@dataclass
class ScenarioResult:
    name: str
    policy: str
    seed: int
    p50: float
    p95: float
    p99: float
    mean_ms: float
    n_requests: int
    rounds_completed: int
    reclusters: int
    budget_total: float
    budget_spent: float
    budget_vetoes: int
    drops: int                       # straggler devices dropped from rounds
    moves: int                       # device handovers executed
    actions: List[Tuple[float, str]]
    trace: List[Tuple[float, str, int]]
    log: RequestLog                  # full request log (timeline plots)

    def fingerprint(self) -> str:
        """Digest of the full event trace + per-request latencies —
        two runs of the same (scenario, policy, seed) must match."""
        h = hashlib.sha256()
        for t, kind, node in self.trace:
            h.update(f"{t!r}|{kind}|{node};".encode())
        h.update(np.ascontiguousarray(self.log.latency_ms).tobytes())
        for t, a in self.actions:
            h.update(f"{t!r}|{a};".encode())
        return h.hexdigest()

    def control_fingerprint(self) -> str:
        """Digest of the *control-plane* trace (request arrivals /
        completions stripped) + per-request latencies + reactive
        actions.  The heap ("parity") engine and the batched engine
        must agree on this bit-for-bit for the same (scenario, policy,
        seed) — the batched engine never materializes request events,
        so the full trace is engine-specific but the control plane is
        not."""
        h = hashlib.sha256()
        for t, kind, node in control_trace(self.trace):
            h.update(f"{t!r}|{kind}|{node};".encode())
        h.update(np.ascontiguousarray(self.log.latency_ms).tobytes())
        for t, a in self.actions:
            h.update(f"{t!r}|{a};".encode())
        return h.hexdigest()


# ---------------------------------------------------------------------------
# the standard continuum the scenarios perturb
# ---------------------------------------------------------------------------

def hot_zone_topology(seed: int = 0, n: int = 20, m: int = 4,
                      hot: float = 3.0, slack: float = 1.35,
                      ) -> Tuple[ClusterTopology, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """The Fig. 7 hot-zone continuum: location clusters with one zone's
    request load inflated by ``hot``x.  When ``m`` does not divide
    ``n``, the first zones absorb the remainder (contiguous zones
    either way; the divisible case matches the Fig. 7 draws exactly)."""
    rng = np.random.default_rng(seed)
    loc = np.repeat(np.arange(m), -(-n // m))[:n]
    lam = rng.uniform(2.0, 4.0, n)
    lam[loc == 0] *= hot
    r = np.full(m, lam.sum() / m * slack)
    topo = ClusterTopology(assign=loc.copy(), n_devices=n, n_edges=m,
                           lam=lam, r=r, l=2)
    return topo, loc, lam, r


def continuum_topology(seed: int = 0, n: int = 200, m: int = 8,
                       capacity_slack: float = 1.3, l: int = 2,
                       T: Optional[int] = None,
                       ) -> Tuple[ClusterTopology, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """A paper-cost continuum whose initial deployment comes from the
    decomposed HFLOP solver instead of the hand-built zone assignment —
    the scenario grid perturbs a topology the solver actually produced,
    at any scale (the LAN instance never materializes an (n, m) cost
    matrix).  Same return shape as :func:`hot_zone_topology`:
    (topology, LAN edge per device, rates, capacities)."""
    from repro_torch.core.partition import paper_cost_lan
    from repro_torch.core.solvers import solve_decomposed
    inst = paper_cost_lan(n, m, seed=seed, l=l,
                          capacity_slack=capacity_slack)
    if T is not None:
        inst = type(inst)(free=inst.free, c_e=inst.c_e, lam=inst.lam,
                          r=inst.r, unit_cost=inst.unit_cost, l=inst.l,
                          T=T)
    sol = solve_decomposed(inst)
    topo = ClusterTopology(assign=np.asarray(sol.assign, int),
                           n_devices=n, n_edges=m, lam=inst.lam,
                           r=inst.r, l=inst.l)
    return topo, inst.free.copy(), inst.lam, inst.r


def continual_training(duration_s: float, l: int = 2,
                       ) -> Sequence:
    """Back-to-back HFL rounds covering the horizon (continual
    learning), the same shape the co-sim benchmarks use."""
    rounds = max(int(duration_s / 20.0), 1)
    return round_schedule(rounds=rounds, l=l, local_epochs=5, epoch_s=3.5,
                          upload_s=2.0, gap_s=2.0)


# ---------------------------------------------------------------------------
# scenario recipes
# ---------------------------------------------------------------------------

def baseline_scenario() -> Scenario:
    return Scenario("baseline", "training-inference interference only, "
                    "no extra perturbations", lambda cosim: None)


def straggler_scenario(times: Sequence[float] = (5.0, 27.0, 48.0),
                       devices: Sequence[int] = (0, 5, 1),
                       factor: float = 4.0) -> Scenario:
    """Devices slow down mid-round (thermal throttling / co-located
    jobs); the reactive drop policy enforces the round deadline."""
    def inject(cosim: CoSim) -> None:
        for t, i in zip(times, devices):
            if t < cosim.cfg.duration_s and i < cosim.proc.topo.n_devices:
                cosim.schedule_straggler(t, i, factor)
    return Scenario("straggler",
                    f"devices {tuple(devices)} slow {factor}x mid-round; "
                    "deadline-based drop", inject)


def mobility_scenario(moves: Sequence[Tuple[float, int, int]] = (
        (25.0, 7, 0), (55.0, 12, 0), (85.0, 17, 0)),
        ) -> Scenario:
    """Devices hand over between LAN edges mid-simulation — by default
    *into* the already-hot zone, compounding its overload — each paying
    the modeled handover cost; the reactive loop re-clusters around the
    new cost structure, budget permitting."""
    def inject(cosim: CoSim) -> None:
        m = cosim.proc.topo.n_edges
        for t, i, j in moves:
            if (t < cosim.cfg.duration_s
                    and i < cosim.proc.topo.n_devices and j < m):
                cosim.schedule_device_move(t, i, j)
    return Scenario("mobility",
                    f"{len(tuple(moves))} device handovers between LAN "
                    "edges (with handover cost)", inject)


def _edge_anchors(m: int) -> np.ndarray:
    """LAN edge anchor points: cell centers of the smallest square grid
    covering ``m`` edges in the unit square.  Deterministic in ``m``
    alone, so the spatial meaning of "edge j" is stable across seeds."""
    g = math.ceil(math.sqrt(m))
    centers = [((i % g + 0.5) / g, (i // g + 0.5) / g) for i in range(m)]
    return np.asarray(centers[:m], dtype=float)


def random_waypoint_moves(n: int, m: int, duration_s: float,
                          seed: int = 0,
                          speed: Tuple[float, float] = (0.005, 0.02),
                          pause_s: float = 5.0,
                          sample_dt: float = 1.0,
                          ) -> List[Tuple[float, int, int]]:
    """Random-waypoint mobility trace as a DEVICE_MOVE event list.

    Devices live in the unit square; each repeatedly picks a uniform
    waypoint and walks there at a uniform speed (fraction of the square
    per second), pausing ``pause_s`` between legs — the classic random
    waypoint model.  A device is associated with its nearest LAN edge
    anchor (:func:`_edge_anchors`); whenever the nearest edge changes
    at a ``sample_dt`` boundary, a ``(t, device, new_edge)`` handover
    is emitted, directly consumable by :func:`mobility_scenario`.

    All randomness comes from ``np.random.default_rng(seed)`` drawn in
    a fixed per-device order, so the trace is bit-reproducible
    (contract DET001): same arguments, same moves.
    """
    if n <= 0 or m <= 0 or duration_s <= 0:
        return []
    rng = np.random.default_rng(seed)
    anchors = _edge_anchors(m)

    def nearest(p: np.ndarray) -> int:
        d2 = ((anchors - p) ** 2).sum(axis=1)
        return int(np.argmin(d2))

    moves: List[Tuple[float, int, int]] = []
    for dev in range(n):
        pos = rng.uniform(0.0, 1.0, 2)
        edge = nearest(pos)
        t = 0.0
        next_sample = sample_dt
        while t < duration_s:
            target = rng.uniform(0.0, 1.0, 2)
            v = rng.uniform(speed[0], speed[1])
            leg = float(np.linalg.norm(target - pos))
            leg_end = t + leg / max(v, 1e-12)
            direction = (target - pos) / max(leg, 1e-12)
            # sample the walk at dt boundaries; handovers fire there
            while next_sample <= min(leg_end, duration_s):
                p = pos + direction * v * (next_sample - t)
                e = nearest(p)
                if e != edge:
                    moves.append((next_sample, dev, e))
                    edge = e
                next_sample += sample_dt
            pos = target
            t = leg_end + pause_s
            next_sample = max(next_sample,
                              math.floor(t / sample_dt) * sample_dt
                              + sample_dt)
    moves.sort()
    return moves


def multi_tenant_scenario(job_rate_per_edge: float = 1.0 / 25.0,
                          share: float = 0.45,
                          mean_duration_s: float = 8.0,
                          seed_offset: int = 7919) -> Scenario:
    """Co-located third-party workloads: each edge receives its own
    Poisson stream of tenant jobs, each claiming ``share`` of the edge's
    compute for an exponential duration — extra interference-model
    demand sources that serving (and aggregation) must time-share
    with.  Drawn from a child generator of the co-sim seed, so the
    stream is deterministic and does not perturb the co-sim's own
    draws."""
    def inject(cosim: CoSim) -> None:
        rng = np.random.default_rng(cosim.cfg.seed + seed_offset)
        horizon = cosim.cfg.duration_s
        tid = 0
        for j in sorted(cosim.proc.edges):
            t = 0.0
            while True:
                t += rng.exponential(1.0 / job_rate_per_edge)
                if t >= horizon:
                    break
                dur = rng.exponential(mean_duration_s)
                cosim.schedule_tenant_load(t, j, share, duration_s=dur,
                                           tenant=f"{j}.{tid}")
                tid += 1
    return Scenario("multi_tenant",
                    f"Poisson tenant jobs per edge ({share:.0%} share, "
                    f"~{mean_duration_s:.0f}s each)", inject)


def churn_scenario(drift_t: float = 30.0,
                   straggler: Tuple[float, int, float] = (22.0, 0, 4.0),
                   move: Tuple[float, int, int] = (50.0, 7, 2),
                   ) -> Scenario:
    """Everything at once — drift, a straggler and a handover on top of
    the tenant stream — the regime where an unmetered reactive loop
    overspends on migrations and the budget has to ration them."""
    tenants = multi_tenant_scenario()

    def inject(cosim: CoSim) -> None:
        tenants.inject(cosim)
        if drift_t < cosim.cfg.duration_s:
            cosim.schedule_drift(drift_t)
        t, i, f = straggler
        if t < cosim.cfg.duration_s:
            cosim.schedule_straggler(t, i, f)
        t, i, j = move
        if t < cosim.cfg.duration_s and j < cosim.proc.topo.n_edges:
            cosim.schedule_device_move(t, i, j)
    return Scenario("churn", "drift + straggler + handover + tenant "
                    "jobs (budget stress)", inject)


def outage_scenario(mttf_s: float = 18.0, mttr_s: float = 5.0,
                    edges: Tuple[int, ...] = (0,),
                    partition_edges: Tuple[int, ...] = (1,),
                    quorum: float = 0.5,
                    plan: Optional[FaultPlan] = None,
                    standby: bool = True) -> Scenario:
    """Edge/aggregator crash-and-recover chaos: ``edges`` cycle through
    exponential MTTF/MTTR *crash* outages — absorbed by warm-standby
    aggregator promotion, which re-homes their devices before any
    request can fail — while ``partition_edges`` cycle through
    *partition* outages the standby machinery cannot see (the host is
    up but unreachable), so their R1/R3 traffic exercises the retry +
    cloud-failover path.  The round machinery enforces the
    participation quorum throughout.  Pass ``plan`` to substitute any
    composed :class:`~repro_torch.sim.faults.FaultPlan`."""
    def inject(cosim: CoSim) -> None:
        p = plan
        if p is None:
            p = EdgeOutagePlan(mttf_s=mttf_s, mttr_s=mttr_s,
                               edges=tuple(edges))
            if partition_edges:
                # anchored inside round *compute* spans, not horizon
                # fractions or a renewal draw: a partitioned edge only
                # strands traffic while its devices are busy training
                # (idle devices serve R2-local), so the retry/failover
                # path must be exercised where devices are computing —
                # and the schedule is a pure function of the horizon,
                # so this stays deterministic at any grid duration
                T = cosim.cfg.duration_s
                spans = [(w.start, min(w.compute_end, T))
                         for w in continual_training(
                             T, l=cosim.proc.topo.l)
                         if w.start < T]
                anchors = (spans[0],) if len(spans) == 1 else (
                    spans[0], spans[-1])
                wins = []
                for s0, s1 in anchors:
                    c = s1 - s0
                    wins.append((s0 + 0.25 * c, s0 + 0.60 * c))
                p = p + PartitionPlan(windows_s=tuple(wins),
                                      edges=tuple(partition_edges))
        cosim.schedule_faults(p, standby=standby, quorum=quorum)
    return Scenario("outage",
                    f"edge crash/recover cycles (MTTF {mttf_s:.0f}s, "
                    f"MTTR {mttr_s:.0f}s) with retry + cloud failover",
                    inject)


def domain_outage_scenario(mttf_s: float = 25.0, mttr_s: float = 6.0,
                           quorum: float = 0.5) -> Scenario:
    """Correlated failure domains (paired edges sharing an uplink) go
    dark together, composed with a request-drop burst stream — the
    regime that stresses quorum aggregation and standby promotion
    hardest."""
    def inject(cosim: CoSim) -> None:
        m = cosim.proc.topo.n_edges
        doms = tuple((j, j + 1) for j in range(0, m - 1, 2))
        if not doms:
            doms = ((0,),)
        # burst cadence scaled to the horizon so short grid cells still
        # see at least a couple of drop windows in expectation
        T = cosim.cfg.duration_s
        p = (DomainOutagePlan(domains=doms, mttf_s=mttf_s, mttr_s=mttr_s)
             + DropBurstPlan(p_drop=0.25, every_s=max(T / 5.0, 1.0),
                             burst_s=max(T / 10.0, 0.5)))
        cosim.schedule_faults(p, quorum=quorum)
    return Scenario("domain_outage",
                    "correlated LAN-domain outages + request-drop "
                    "bursts (quorum + standby stress)", inject)


SCENARIOS: Dict[str, Callable[[], Scenario]] = {
    "baseline": baseline_scenario,
    "straggler": straggler_scenario,
    "mobility": mobility_scenario,
    "multi_tenant": multi_tenant_scenario,
    "churn": churn_scenario,
    "outage": outage_scenario,
    "domain_outage": domain_outage_scenario,
}


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def default_budget_total(m: int = 4, reconfigs: int = 2,
                         cfg: Optional[CoSimConfig] = None) -> float:
    """A budget worth ``reconfigs`` full-continuum migrations — the
    knob the benchmark grid sweeps."""
    cfg = cfg if cfg is not None else CoSimConfig()
    return cfg.reconfig_s * cfg.interference.migration_share * m * reconfigs


def run_scenario(scenario: Scenario, policy: str = "reactive",
                 seed: int = 0, duration_s: float = 120.0,
                 budget_total: Optional[float] = None,
                 n: int = 20, m: int = 4, hot: float = 3.0,
                 slack: float = 1.35, training: bool = True,
                 p95_threshold_ms: float = 20.0,
                 rx_policy: Optional[ReactivePolicy] = None,
                 engine: str = "batched",
                 latency: Optional[LatencyModel] = None,
                 fuse_windows: bool = True,
                 topology: Optional[Tuple[ClusterTopology, np.ndarray,
                                          np.ndarray, np.ndarray]] = None,
                 telemetry=None,
                 ) -> ScenarioResult:
    """One (scenario, policy, seed) cell of the grid.  ``engine``
    picks the request plane ("batched", default) or the per-request
    heap path ("heap") — the two produce bit-identical results here
    (``ScenarioResult.control_fingerprint``), heap just pays two heap
    events per request.  ``fuse_windows=False`` flushes the request
    plane at every control event (the pre-fusion behavior, same
    results); ``latency`` overrides the latency model (e.g. a
    ``CalibratedLatencyModel`` for occupancy-coupled serving);
    ``topology`` substitutes a pre-built continuum — e.g.
    :func:`continuum_topology`'s solver-produced deployment — for the
    default hot-zone draw (``n``/``m``/``hot``/``slack`` are then
    ignored); ``telemetry`` attaches a ``repro_torch.telemetry.Telemetry``
    sink (metrics / control-plane spans / decision audit) — pure
    observation, the result and its fingerprints are bit-identical
    with or without it."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; pick from {POLICIES}")
    topo, loc, lam, r = (topology if topology is not None
                         else hot_zone_topology(seed=seed, n=n, m=m,
                                                hot=hot, slack=slack))
    cfg_kwargs = {} if latency is None else {"latency": latency}
    cfg = CoSimConfig(duration_s=duration_s, seed=seed, engine=engine,
                      fuse_windows=fuse_windows, telemetry=telemetry,
                      **cfg_kwargs)
    sched = continual_training(duration_s, l=topo.l) if training else None

    reactive, budget, ctl = None, None, None
    if policy != "static":
        ctl = LearningController(
            inventory=Inventory.from_arrays(lam, r, lan_edge=loc), l=topo.l)
        ctl.deployment = Deployment.from_topology(topo)
        reactive = ReactiveLoop(
            ctl, policy=rx_policy if rx_policy is not None
            else ReactivePolicy(p95_threshold_ms=p95_threshold_ms))
        if policy == "budgeted":
            budget = ReconfigBudget(
                total=budget_total if budget_total is not None
                else default_budget_total(m=m, cfg=cfg))

    cosim = CoSim(topo, cfg, schedule=sched, reactive=reactive,
                  budget=budget)
    scenario.inject(cosim)
    res = cosim.run()

    log = res.log
    return ScenarioResult(
        name=scenario.name, policy=policy, seed=seed,
        p50=log.percentile_latency(50), p95=log.percentile_latency(95),
        p99=log.percentile_latency(99), mean_ms=log.mean_latency(),
        n_requests=int(log.t.size),
        rounds_completed=res.rounds_completed,
        reclusters=ctl.recluster_count if ctl is not None else 0,
        budget_total=budget.total if budget is not None else math.inf,
        budget_spent=budget.spent if budget is not None else 0.0,
        budget_vetoes=budget.vetoes if budget is not None else 0,
        drops=len(res.drop_log), moves=len(res.move_log),
        actions=res.actions, trace=res.trace, log=log)


# ---------------------------------------------------------------------------
# parallel grid runner
# ---------------------------------------------------------------------------

def _grid_cell(item: Tuple[str, str, Dict, bool],
               ) -> Tuple[str, str, ScenarioResult, Optional[bool]]:
    """One picklable grid cell: scenarios are rebuilt by *name* inside
    the worker (their ``inject`` closures don't pickle), run, and
    optionally re-run for the determinism fingerprint check."""
    sc_name, policy, kwargs, check = item
    res = run_scenario(SCENARIOS[sc_name](), policy=policy, **kwargs)
    det: Optional[bool] = None
    if check:
        rerun = run_scenario(SCENARIOS[sc_name](), policy=policy, **kwargs)
        det = res.fingerprint() == rerun.fingerprint()
    return sc_name, policy, res, det


def run_grid(scenario_names: Sequence[str],
             policies: Sequence[str] = POLICIES, *,
             jobs: int = 1, check_determinism: bool = False,
             **kwargs) -> Dict[Tuple[str, str],
                               Tuple[ScenarioResult, Optional[bool]]]:
    """The scenario x policy grid, optionally over a process pool.

    Cells are independent by construction (every run seeds its own
    generators from the cell's seed), so ``jobs > 1`` fans them out
    with ``ProcessPoolExecutor`` — results come back in deterministic
    (scenario, policy) order either way, and ``check_determinism=True``
    re-runs each cell *inside its worker* and compares event-trace
    fingerprints.  Extra ``kwargs`` go to :func:`run_scenario`
    verbatim.  Returns ``{(scenario, policy): (result, det_ok)}`` with
    ``det_ok`` None when the check is off."""
    items = [(sc, pol, kwargs, check_determinism)
             for sc in scenario_names for pol in policies]
    if jobs <= 1 or len(items) <= 1:
        results = [_grid_cell(it) for it in items]
    else:
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(max_workers=min(jobs, len(items))) as ex:
            results = list(ex.map(_grid_cell, items))
    return {(sc, pol): (res, det) for sc, pol, res, det in results}
