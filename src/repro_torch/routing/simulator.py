"""Discrete-event simulator for inference serving during (continual) HFL
training — reproduces the paper's Fig. 7 (response times) and Fig. 8
(end-to-end latency vs compute speedup and request-rate scaling).

Each device emits a Poisson request stream at rate lambda_i (shared
generator: ``serving.workload.poisson_requests``).  Requests are routed
by rules R1-R3 (``repro.routing.rules``); edges have finite concurrent-
processing capacity derived from r_j; the cloud is infinite.

This module is a thin inference-only configuration of the shared event
engine: :class:`RequestProcessor` holds the routing + service logic
behind two interchangeable engines —

  ``batched``  (default) the vectorized macro-event request plane
               (``repro.sim.request_plane``): arrivals are pre-drawn
               columnar arrays, processed in NumPy batches over the
               windows between control-plane heap events; ~50-100x the
               simulated-requests/sec of the heap at Fig. 7 scale
               (``benchmarks/perf_event_throughput.py``);
  ``heap``     the original per-request event path (one
               ``REQUEST_ARRIVAL`` + ``REQUEST_COMPLETION`` heap event
               per request) — the *parity* reference the batched
               engine is validated against (``tests/
               test_event_engine.py``).

``repro.sim.cosim`` reuses the same processor but drives the busy flag
from an actual training round timeline and the service times through
an interference model; there the two engines are bit-identical because
routing is deterministic and the batched RTT draws consume the shared
generator stream in exactly the heap path's order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.topology import ClusterTopology
from repro_torch.routing.latency import LatencyModel
from repro_torch.routing.rules import EdgeState, RouteDecision, route_request
from repro_torch.serving.workload import poisson_request_arrays
from repro_torch.sim.events import Event, EventKind, Simulation
from repro_torch.sim.request_plane import (RULE_CODE, RULES, TIER_CLOUD,
                                     TIER_DEVICE, TIER_EDGE, ColumnarLog,
                                     RetryPolicy, backoff_delay,
                                     batched_rtt_draws, bucket_admissions,
                                     occupancy_replay)
from repro_torch.telemetry import Telemetry, maybe as _maybe_tel

ENGINES = ("batched", "heap")

_RULE_NAMES = np.array(RULES, dtype=object)   # code -> str, C-speed take
_TIER_NAMES = ("device", "edge", "cloud")     # TIER_* code -> str

#: above this many open edges the per-window edge grouping switches
#: from one boolean scan per edge to a single stable argsort — scans
#: win decisively at the paper's continuum sizes (a handful of edges),
#: the sort wins once m x n passes would dominate n log n.
_EDGE_SCAN_MAX = 16


class RequestLog:
    """Columnar view of one run's served requests.  Rule names are kept
    as int8 codes (``rule_code``) and materialized to strings lazily on
    first access of ``rule`` — at 10^7 requests the eager
    list-of-strings was the single largest cost of ``log()``."""

    def __init__(self, t: np.ndarray, device: np.ndarray,
                 tier: np.ndarray,
                 rule: Optional[Sequence[str]] = None,
                 latency_ms: Optional[np.ndarray] = None, *,
                 rule_code: Optional[np.ndarray] = None):
        self.t = t
        self.device = device
        self.tier = tier
        self.latency_ms = (latency_ms if latency_ms is not None
                           else np.zeros(0))
        if rule_code is not None:
            self._rule_code = np.asarray(rule_code, dtype=np.int8)
        else:                        # legacy constructor: string names
            self._rule_code = np.asarray(
                [RULE_CODE[r] for r in (rule if rule is not None else ())],
                dtype=np.int8)
        self._rule_names: Optional[List[str]] = None

    @property
    def rule_code(self) -> np.ndarray:
        """Per-request routing-rule codes (int8, see ``RULES``)."""
        return self._rule_code

    @property
    def rule(self) -> List[str]:
        """Per-request rule names, materialized (and cached) on demand."""
        if self._rule_names is None:
            self._rule_names = _RULE_NAMES[self._rule_code].tolist()
        return self._rule_names

    def mean_latency(self) -> float:
        """Mean end-to-end latency in ms (NaN on an empty log)."""
        if self.latency_ms.size == 0:
            return math.nan
        return float(np.mean(self.latency_ms))

    def std_latency(self) -> float:
        if self.latency_ms.size == 0:
            return math.nan
        return float(np.std(self.latency_ms))

    def percentile_latency(self, p: float) -> float:
        """p-th percentile of end-to-end latency in ms (p in [0, 100]);
        NaN on an empty log — short smoke runs can legitimately serve
        zero requests, and reporting must not crash on them."""
        if self.latency_ms.size == 0:
            return math.nan
        return float(np.percentile(self.latency_ms, p))

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p95/p99 summary (``tier_fractions``-style dict, in ms)."""
        return {f"p{p:g}": self.percentile_latency(p)
                for p in (50, 95, 99)}

    def percentile_ci(self, p: float, confidence: float = 0.95,
                      n_boot: int = 400, seed: int = 0,
                      ) -> tuple:
        """Bootstrap confidence interval of the p-th latency percentile
        — ``(lo, hi)`` in ms, NaN on an empty log.

        Per-request latencies are exact in the columnar log, so the
        bootstrap is the order-statistic shortcut: the p-th percentile
        of one resample of size n is (to interpolation) the K-th order
        statistic of the *original* sorted sample with
        ``K ~ Binomial(n, p/100)`` — B resamples cost one sort plus B
        binomial draws, never B x n copies, which is what makes CIs on
        10^7-request high-rate sweeps free."""
        n = self.latency_ms.size
        if n == 0:
            return (math.nan, math.nan)
        s = np.sort(self.latency_ms)
        rng = np.random.default_rng(seed)
        k = rng.binomial(n, p / 100.0, size=int(n_boot))
        boots = s[np.clip(k, 0, n - 1)]
        alpha = (1.0 - confidence) / 2.0
        return (float(np.percentile(boots, 100.0 * alpha)),
                float(np.percentile(boots, 100.0 * (1.0 - alpha))))

    def tier_fractions(self) -> Dict[str, float]:
        names = {0: "device", 1: "edge", 2: "cloud"}
        if self.tier.size == 0:
            return {name: math.nan for name in names.values()}
        out = {}
        for k, name in names.items():
            out[name] = float(np.mean(self.tier == k))
        return out

    def windowed_percentile(self, window_s: float, p: float = 95.0,
                            ) -> np.ndarray:
        """(n_windows, 2) array of [window start, p-th percentile latency]
        — the latency timeline the reactive monitors and examples plot.
        Windows without any arrivals are NaN rows (not silently dropped),
        so the timeline keeps a uniform grid and gaps stay visible.

        Arrival times are nondecreasing (the engines log in arrival
        order), so windows are contiguous ``searchsorted`` slices, and
        the per-window percentile is one grouped sort: ``lexsort`` on
        (window id, latency) orders every slice at once, then the
        linearly interpolated percentile is gathered per window with
        array arithmetic — no Python loop over windows."""
        if self.t.size == 0:
            return np.zeros((0, 2))
        edges = np.arange(0.0, float(self.t[-1]) + 1e-9, window_s)
        bounds = np.searchsorted(self.t, np.append(edges,
                                                   edges[-1] + window_s))
        counts = np.diff(bounds)
        nw = edges.size
        win_id = np.repeat(np.arange(nw), counts)
        lat = self.latency_ms[bounds[0]:bounds[-1]]
        s = lat[np.lexsort((lat, win_id))]   # each window's slice sorted
        out = np.full((nw, 2), math.nan)
        out[:, 0] = edges
        nz = counts > 0
        if nz.any():
            # numpy's default linear interpolation, vectorized across
            # windows: virtual index (count-1) * p/100 into the sorted
            # slice, then lerp between its two neighbours
            pos = (counts[nz] - 1) * (p / 100.0)
            lo_i = np.floor(pos).astype(np.int64)
            hi_i = np.minimum(lo_i + 1, counts[nz] - 1)
            frac = pos - lo_i
            base = (bounds[:-1] - bounds[0])[nz]
            s_lo = s[base + lo_i]
            out[nz, 1] = s_lo + frac * (s[base + hi_i] - s_lo)
        return out


@dataclass
class SimConfig:
    duration_s: float = 300.0
    seed: int = 0
    busy_fraction: float = 1.0       # fraction of time devices train (CL: 1)
    rate_scale: float = 1.0          # Fig. 8b: lambda x 10
    latency: LatencyModel = field(default_factory=LatencyModel)
    engine: str = "batched"          # "batched" | "heap" (parity)


class RequestProcessor:
    """Routing + service logic on the shared event engine — used by the
    inference-only simulator below and the training–inference
    co-simulation (``repro.sim.cosim``).

    Two engines share all admission/topology state (the ``EdgeState``
    dict control-plane handlers mutate) and the columnar log:

      ``heap``     per-request handlers on ``REQUEST_ARRIVAL`` /
                   ``REQUEST_COMPLETION`` events, driven by the scalar
                   policies ``busy_fn`` / ``service_fn`` /
                   ``extra_ms_fn``;
      ``batched``  pre-drawn arrival arrays (:meth:`add_arrivals`)
                   processed window-by-window through the simulation's
                   flush hook, driven by the vectorized policies
                   ``busy_mask_fn(devices, ts)``,
                   ``stretch_fn(tier, ids)`` and
                   ``extra_ms_vec_fn(ts, devices, tiers, edge_ids)``.

    Both log into a :class:`~repro.sim.request_plane.ColumnarLog`
    (preallocated arrays, arrival order), so telemetry percentiles are
    incremental either way."""

    def __init__(self, topo: ClusterTopology, rng: np.random.Generator,
                 latency: Optional[LatencyModel] = None,
                 busy_fn: Optional[Callable[[int, float], bool]] = None,
                 service_fn: Optional[
                     Callable[[int, RouteDecision, int], float]] = None,
                 extra_ms_fn: Optional[
                     Callable[[RouteDecision, float, int], float]] = None,
                 engine: str = "batched",
                 busy_mask_fn: Optional[Callable[
                     [np.ndarray, np.ndarray], np.ndarray]] = None,
                 stretch_fn: Optional[Callable[
                     [str, np.ndarray], np.ndarray]] = None,
                 extra_ms_vec_fn: Optional[Callable[
                     [np.ndarray, np.ndarray, np.ndarray, np.ndarray],
                     np.ndarray]] = None,
                 telemetry: Optional[Telemetry] = None):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; pick from "
                             f"{ENGINES}")
        if engine == "batched":
            # the batched engine only consults the vectorized policies:
            # a scalar-only caller would silently simulate the default
            # behavior instead — refuse loudly
            unpaired = [f"{scalar} (vectorized twin {vec} missing)"
                        for scalar, vec, s, v in (
                            ("busy_fn", "busy_mask_fn", busy_fn,
                             busy_mask_fn),
                            ("service_fn", "stretch_fn", service_fn,
                             stretch_fn),
                            ("extra_ms_fn", "extra_ms_vec_fn",
                             extra_ms_fn, extra_ms_vec_fn))
                        if s is not None and v is None]
            if unpaired:
                raise ValueError(
                    "engine='batched' ignores scalar policies: "
                    + "; ".join(unpaired)
                    + ". Pass the vectorized policy or engine='heap'.")
        self.engine = engine
        self.rng = rng
        self.lat = latency if latency is not None else LatencyModel()
        self.busy_fn = busy_fn or (lambda i, t: False)
        self.service_fn = service_fn
        self.extra_ms_fn = extra_ms_fn
        self.busy_mask_fn = busy_mask_fn
        self.stretch_fn = stretch_fn
        self.extra_ms_vec_fn = extra_ms_vec_fn
        # resolved once: None unless telemetry is present AND enabled,
        # so disabled runs pay exactly one is-None branch per window;
        # instrument handles are bound here too — the window path does
        # no registry lookups or name formatting
        self._tel = _maybe_tel(telemetry)
        if self._tel is not None:
            m = self._tel.metrics
            self._m_windows = m.counter("request_plane.windows")
            self._m_total = m.counter("requests.total")
            self._m_tier = [m.counter(f"requests.tier.{t}")
                            for t in _TIER_NAMES]
            self._m_rule = [m.counter(f"requests.rule.{r}")
                            for r in RULES]
            self._m_hist = m.histogram("request.latency_ms")
            self._m_fault_attempts = m.counter("requests.fault_attempts")
            self._m_fault_dropped = m.counter("requests.fault_dropped")
            self._m_retries = m.counter("requests.retries")
            self._m_failovers = m.counter("requests.failovers")
        self._cols = ColumnarLog()
        self._tier_code = {"device": TIER_DEVICE, "edge": TIER_EDGE,
                           "cloud": TIER_CLOUD}
        # batched-engine state: the pre-drawn arrival stream + cursor,
        # and per-edge in-flight completion times (only materialized
        # when the latency model's edge service is occupancy-dependent)
        self._arr_t = np.zeros(0, dtype=np.float64)
        self._arr_dev = np.zeros(0, dtype=np.int64)
        self._arr_pos = 0
        self._flush_started = False
        self._occ_edge = self.lat.occupancy_dependent("edge")
        self._pending: Dict[int, np.ndarray] = {}
        # fault-plane state (repro.sim.faults): all empty / None unless
        # a chaos plan is installed, so fault-free runs never branch
        # into the scalar core — the non-perturbation contract
        self.retry_policy: Optional[RetryPolicy] = None
        self._down: set = set()          # edges currently crashed/partitioned
        self._drop_p: Dict[int, float] = {}    # edge -> drop probability
        self._spike_ms: Dict[int, float] = {}  # edge -> added latency (ms)
        self._fault_active = False
        self._tick_armed = False         # one ARRIVAL_TICK outstanding, max
        self._sim: Optional[Simulation] = None
        # availability accounting (see benchmarks/perf_faults.py): every
        # failed attempt either schedules a retry or fails over, and
        # every arrival is logged exactly once unless its retry is still
        # pending at the horizon — log rows + (scheduled - dispatched)
        # retries == total arrivals, the CI hard gate
        self.fault_attempts = 0
        self.fault_drops = 0
        self.retries_scheduled = 0
        self.retries_dispatched = 0
        self.failovers = 0
        self.edges: Dict[int, EdgeState] = {}
        self.set_topology(topo)

    def set_topology(self, topo: ClusterTopology) -> None:
        """(Re)build admission state — used at start and when the
        reactive loop swaps in a re-clustered deployment.  In-flight
        completions keep a reference to their old ``EdgeState`` (the
        event payload), so they drain harmlessly after a swap; the
        batched engine equivalently drops its per-edge in-flight
        arrays."""
        self.topo = topo
        self.edges = {}
        for j in topo.open_edges:
            # capacity is a property of the edge host — it does NOT scale
            # with the request-rate multiplier (the point of Fig. 8b)
            self.edges[int(j)] = EdgeState(
                capacity_rps=float(topo.r[j]) if topo.r.size else np.inf)
        self._pending = {}

    def bind(self, sim: Simulation) -> None:
        self._sim = sim
        if self.engine == "heap":
            sim.on(EventKind.REQUEST_ARRIVAL, self.on_arrival)
            sim.on(EventKind.REQUEST_COMPLETION, self.on_completion)
        else:
            sim.set_flush(self.flush_window)
        # retry/tick events exist only in fault-mode runs; registering
        # the handlers is free otherwise
        sim.on(EventKind.REQUEST_RETRY, self.on_retry)
        sim.on(EventKind.ARRIVAL_TICK, self.on_tick)

    def fail_edge(self, edge_id: int) -> None:
        """Edge host died: zero capacity so R3 overflows to the cloud."""
        st = self.edges.get(int(edge_id))
        if st is not None:
            st.capacity_rps = 0.0
            st.tokens = 0.0

    # -- fault plane (repro.sim.faults) -------------------------------------

    def enable_faults(self, policy: RetryPolicy) -> None:
        """Arm the retry/failover core.  In fault mode *every* request
        of the heap engine — and every batched window with a fault
        active — goes through :meth:`_serve_attempt`, the shared scalar
        core, so the two engines are bit-identical by construction;
        batched windows with no fault active keep the vectorized path
        (which the scalar core reproduces exactly when nothing is
        down)."""
        self.retry_policy = policy

    def fault_down(self, edge_id: int) -> None:
        """Edge crashed / partitioned away: attempts targeting it fail
        into retry/failover until :meth:`fault_up`.  Bucket and
        in-flight state survive (transient outage, not `fail_edge`)."""
        self._down.add(int(edge_id))
        self._recompute_fault_active()

    def fault_up(self, edge_id: int) -> None:
        self._down.discard(int(edge_id))
        self._recompute_fault_active()

    def set_drop(self, edge_id: int, p: float) -> None:
        """Drop-burst window: edge-served requests dropped w.p. ``p``
        (one uniform draw per attempt); ``p <= 0`` clears."""
        if p > 0.0:
            self._drop_p[int(edge_id)] = float(p)
        else:
            self._drop_p.pop(int(edge_id), None)
        self._recompute_fault_active()

    def set_spike(self, edge_id: int, ms: float) -> None:
        """Latency-spike window: +``ms`` on every request touching the
        edge (served there or transiting it); ``ms <= 0`` clears."""
        if ms > 0.0:
            self._spike_ms[int(edge_id)] = float(ms)
        else:
            self._spike_ms.pop(int(edge_id), None)
        self._recompute_fault_active()

    def _recompute_fault_active(self) -> None:
        self._fault_active = bool(self._down or self._drop_p
                                  or self._spike_ms)
        # crash/partition/drop faults can FAIL attempts, whose backoff
        # retries must land in the future — the batched plane paces
        # arrivals one-per-tick while such a fault is live (spike-only
        # windows never fail anything, so they keep whole-window
        # scalar replay)
        if self._down or self._drop_p:
            self._arm_tick()

    def _arm_tick(self) -> None:
        """Schedule the batched plane's next fault-window pacing beat
        at the next pending arrival's exact timestamp (see
        ``EventKind.ARRIVAL_TICK``).  At most one tick is outstanding;
        a stale one (fault cleared before it fires) degenerates to a
        window split, which the vectorized path is invariant to."""
        if (self.engine == "heap" or self._tick_armed
                or self.retry_policy is None or self._sim is None):
            return
        if self._arr_pos < self._arr_t.size:
            self._sim.schedule(float(self._arr_t[self._arr_pos]),
                               EventKind.ARRIVAL_TICK)
            self._tick_armed = True

    def on_tick(self, sim: Simulation, ev: Event) -> None:
        """The pre-dispatch inclusive flush already served the arrival
        this tick paced; all that is left is to keep the beat going
        while a fail-capable fault remains live."""
        self._tick_armed = False
        if self._down or self._drop_p:
            self._arm_tick()

    # -- heap ("parity") engine ---------------------------------------------

    def on_completion(self, sim: Simulation, ev: Event) -> None:
        ev.payload.in_service -= 1

    def on_arrival(self, sim: Simulation, ev: Event) -> None:
        if self.retry_policy is not None:
            # fault mode: every request goes through the shared scalar
            # core (bit-identical to the fault-free path below when no
            # fault touches its route)
            self._serve_attempt(sim, ev.t, int(ev.node), 0, ev.t)
            return
        t, i = ev.t, ev.node
        busy = self.busy_fn(i, t)
        dec = route_request(i, busy, self.topo.assign, self.edges, now=t)
        # calibrated mode: service time reflects how many requests the
        # chosen replica already has in flight (constant model ignores it)
        occ = self.edges[dec.edge].in_service if dec.tier == "edge" else 0
        service = (self.service_fn(i, dec, occ) if self.service_fn
                   else self.lat.infer_ms(dec.tier, occupancy=occ))
        if dec.tier == "edge":
            st = self.edges[dec.edge]
            st.admit(t)
            sim.schedule(t + service / 1000.0, EventKind.REQUEST_COMPLETION,
                         node=dec.edge, payload=st)
            net = float(self.lat.rtt("edge", self.rng))
        elif dec.tier == "cloud":
            net = float(self.lat.rtt("cloud", self.rng))
            if dec.hops == 2:        # forwarded via the edge (R3 overflow)
                net += float(self.lat.rtt("edge", self.rng))
        else:
            net = float(self.lat.rtt("device", self.rng))
        if self.extra_ms_fn is not None:
            net += float(self.extra_ms_fn(dec, t, i))
        tier_code = self._tier_code[dec.tier]
        rule_code = RULE_CODE[dec.rule]
        self._cols.append(t, i, tier_code, rule_code, net + service)
        if self._tel is not None:
            self._record_scalar(tier_code, rule_code, net + service)

    # -- fault-mode scalar core (shared by both engines) ---------------------
    #
    # Parity by construction: the heap engine's every request, the
    # batched engine's fault-active windows, and both engines' retry
    # dispatches all run _serve_attempt — the same float arithmetic and
    # the same generator-draw order.  Batched windows with no fault
    # active keep the vectorized path, which _serve_attempt reproduces
    # exactly in the fault-free case (it is the on_arrival body plus
    # fault branches that never trigger).

    def on_retry(self, sim: Simulation, ev: Event) -> None:
        """A timed-out/dropped request re-attempts after backoff.
        Control-plane event in *both* engines, so retries split batched
        windows and interleave with arrivals in global time order."""
        attempt, t0 = ev.payload
        self.retries_dispatched += 1
        self._serve_attempt(sim, ev.t, int(ev.node), int(attempt),
                            float(t0))

    def _serve_attempt(self, sim: Simulation, t: float, i: int,
                       attempt: int, t0: float) -> None:
        """One routing/serve attempt of request ``(t0, i)`` at time
        ``t`` (``attempt`` is 0 for the arrival itself).  Re-admission
        goes through the same leaky bucket as a fresh arrival; a failed
        attempt (crashed/partitioned edge, drop burst) schedules a
        backoff retry or — attempts/timeout exhausted — fails over
        straight to the cloud replica (rule R4-failover)."""
        busy = self.busy_fn(i, t)
        dec = route_request(i, busy, self.topo.assign, self.edges, now=t)
        je = dec.edge
        if je is not None and self._fault_active:
            if je in self._down:
                # crashed or partitioned away: the attempt fails whether
                # the edge was serving (R1) or transiting (R3 overflow)
                self._fail_attempt(sim, t, i, attempt, t0)
                return
            if dec.tier == "edge" and je in self._drop_p:
                if self.rng.random() < self._drop_p[je]:
                    self.fault_drops += 1
                    if self._tel is not None:
                        self._bump(self._m_fault_dropped)
                    self._fail_attempt(sim, t, i, attempt, t0)
                    return
        occ = self._edge_occupancy(dec, t)
        service = (self.service_fn(i, dec, occ) if self.service_fn
                   else self.lat.infer_ms(dec.tier, occupancy=occ))
        if dec.tier == "edge":
            st = self.edges[je]
            st.admit(t)
            self._push_completion(sim, st, je, t, service)
            net = float(self.lat.rtt("edge", self.rng))
        elif dec.tier == "cloud":
            net = float(self.lat.rtt("cloud", self.rng))
            if dec.hops == 2:        # forwarded via the edge (R3 overflow)
                net += float(self.lat.rtt("edge", self.rng))
        else:
            net = float(self.lat.rtt("device", self.rng))
        if self.extra_ms_fn is not None:
            net += float(self.extra_ms_fn(dec, t, i))
        if self._spike_ms and je is not None:
            net += self._spike_ms.get(je, 0.0)
        tier_code = self._tier_code[dec.tier]
        rule_code = RULE_CODE[dec.rule]
        # retried requests log at final service time with the backoff
        # wait folded in — the columnar log stays time-sorted
        lat_ms = (t - t0) * 1000.0 + (net + service)
        self._cols.append(t, i, tier_code, rule_code, lat_ms)
        if self._tel is not None:
            self._record_scalar(tier_code, rule_code, lat_ms)

    @staticmethod
    def _bump(counter) -> None:
        """Increment a telemetry counter.  Callers guard on ``_tel`` —
        keeping the mutation here (like ``_record_scalar``) pins the
        guarded blocks to pure-telemetry effects (contract TEL001)."""
        counter.value += 1.0

    def _fail_attempt(self, sim: Simulation, t: float, i: int,
                      attempt: int, t0: float) -> None:
        pol = self.retry_policy
        self.fault_attempts += 1
        if self._tel is not None:
            self._bump(self._m_fault_attempts)
        if attempt + 1 < pol.max_attempts:
            # one uniform draw per scheduled retry — the only randomness
            # the retry path consumes (contract DET003)
            u = self.rng.random()
            t_r = t + backoff_delay(pol, attempt, u)
            if t_r - t0 <= pol.timeout_s:
                self.retries_scheduled += 1
                if self._tel is not None:
                    self._bump(self._m_retries)
                sim.schedule(t_r, EventKind.REQUEST_RETRY, node=i,
                             payload=(attempt + 1, t0))
                return
        # tier failover: the cloud replica is always reachable, so no
        # request is ever lost — it just pays the failover hop
        self.failovers += 1
        if self._tel is not None:
            self._bump(self._m_failovers)
        dec = RouteDecision("cloud", None, hops=1, rule="R4-failover")
        service = (self.service_fn(i, dec, 0) if self.service_fn
                   else self.lat.infer_ms("cloud", occupancy=0))
        net = float(self.lat.rtt("cloud", self.rng))
        if self.extra_ms_fn is not None:
            net += float(self.extra_ms_fn(dec, t, i))
        lat_ms = (t - t0) * 1000.0 + (net + service)
        self._cols.append(t, i, TIER_CLOUD, RULE_CODE["R4-failover"],
                          lat_ms)
        if self._tel is not None:
            self._record_scalar(TIER_CLOUD, RULE_CODE["R4-failover"],
                                lat_ms)

    def _edge_occupancy(self, dec: RouteDecision, t: float) -> int:
        """Occupancy the chosen edge replica has in flight at ``t`` —
        the heap engine reads its event-maintained ``in_service``, the
        batched fallback drains the same per-edge completion array the
        vectorized ``occupancy_replay`` carries (identical counts: both
        exclude completions at exactly ``t``, which a heap run would
        have processed before the same-instant arrival)."""
        if dec.tier != "edge":
            return 0
        if self.engine == "heap":
            return self.edges[dec.edge].in_service
        if not self._occ_edge:
            return 0                 # constant model ignores occupancy
        pend = self._pending.get(dec.edge)
        if pend is None or not pend.size:
            return 0
        cut = int(np.searchsorted(pend, t, side="right"))
        if cut:
            pend = pend[cut:]
            self._pending[dec.edge] = pend
            self.edges[dec.edge].in_service = int(pend.size)
        return int(pend.size)

    def _push_completion(self, sim: Simulation, st: EdgeState, je: int,
                         t: float, service: float) -> None:
        """Record the served request's completion: a heap event (the
        fault-free heap path's exact schedule) or a sorted insert into
        the batched engine's carried pending array."""
        if self.engine == "heap":
            sim.schedule(t + service / 1000.0,
                         EventKind.REQUEST_COMPLETION, node=je,
                         payload=st)
            return
        if not self._occ_edge:
            return
        c = t + service / 1000.0
        pend = self._pending.get(je)
        if pend is None or not pend.size:
            pend = np.array([c], dtype=np.float64)
        else:
            pend = np.insert(pend, int(np.searchsorted(pend, c)), c)
        self._pending[je] = pend
        st.in_service = int(pend.size)

    # -- batched engine ------------------------------------------------------

    def add_arrivals(self, t: np.ndarray, device: np.ndarray) -> None:
        """Hand the batched engine its (time-sorted) arrival stream.
        May be called several times before the run starts; streams are
        merged stably."""
        if self._flush_started:
            raise RuntimeError("cannot add arrivals after window "
                               "processing started (the columnar log "
                               "must stay time-sorted)")
        if self._arr_t.size:
            t = np.concatenate([self._arr_t, np.asarray(t, np.float64)])
            device = np.concatenate([self._arr_dev,
                                     np.asarray(device, np.int64)])
            order = np.argsort(t, kind="stable")
            t, device = t[order], device[order]
        self._arr_t = np.ascontiguousarray(t, dtype=np.float64)
        self._arr_dev = np.ascontiguousarray(device, dtype=np.int64)

    def flush_window(self, lo: float, hi: float, inclusive: bool) -> None:
        """Advance the request plane through one control window: route,
        admit and serve every pending arrival with ``t < hi``
        (``t <= hi`` for the inclusive tail window) in one vectorized
        batch.  Every routing input is constant over the window by
        construction — its endpoints *are* the control events."""
        self._flush_started = True
        hi_idx = int(np.searchsorted(self._arr_t, hi,
                                     side="right" if inclusive else "left"))
        if hi_idx <= self._arr_pos:
            return
        sl = slice(self._arr_pos, hi_idx)
        self._arr_pos = hi_idx
        self._process_window(self._arr_t[sl], self._arr_dev[sl])

    def _stretch_scalar(self, tier: str, node: int) -> float:
        if self.stretch_fn is None:
            return 1.0
        return float(self.stretch_fn(tier, np.asarray([node]))[0])

    def _process_window(self, t: np.ndarray, dev: np.ndarray) -> None:
        if self._fault_active and self.retry_policy is not None:
            # a fault is live somewhere on the continuum: replay the
            # window through the shared scalar core so drops, retries
            # and failovers land bit-identically to the heap engine.
            # Fault-free windows (the common case) stay vectorized.
            if self._tel is not None:
                self._bump(self._m_windows)
            sim = self._sim
            for k in range(t.size):
                tk = float(t[k])
                self._serve_attempt(sim, tk, int(dev[k]), 0, tk)
            return
        n = t.size
        assign = self.topo.assign
        busy = (np.asarray(self.busy_mask_fn(dev, t), dtype=bool)
                if self.busy_mask_fn is not None
                else np.zeros(n, dtype=bool))
        j = np.full(n, -1, dtype=np.int64)
        valid = (dev >= 0) & (dev < assign.size)
        j[valid] = assign[dev[valid]]

        tier = np.empty(n, dtype=np.int8)
        rule = np.empty(n, dtype=np.int8)
        edge_id = np.full(n, -1, dtype=np.int64)
        service = np.empty(n, dtype=np.float64)
        two_hop = np.zeros(n, dtype=bool)

        idle = ~busy                                    # R2: serve locally
        if idle.any():
            tier[idle] = TIER_DEVICE
            rule[idle] = RULE_CODE["R2-local"]
            s_dev = self.lat.infer_ms("device")
            if self.stretch_fn is not None:
                service[idle] = s_dev * self.stretch_fn("device", dev[idle])
            else:
                service[idle] = s_dev

        flat = busy & (j < 0)                           # R1 without an edge
        if flat.any():
            tier[flat] = TIER_CLOUD
            rule[flat] = RULE_CODE["R1-flat"]

        eb = busy & (j >= 0)                            # R1 via aggregator
        if eb.any():
            base_edge = self.lat.infer_ms("edge")
            for je, m in self._edge_groups(eb, j):
                st = self.edges[je]
                adm = bucket_admissions(t[m], st)
                a_idx, o_idx = m[adm], m[~adm]
                tier[a_idx] = TIER_EDGE
                rule[a_idx] = RULE_CODE["R1"]
                edge_id[a_idx] = je
                tier[o_idx] = TIER_CLOUD                # R3 overflow
                rule[o_idx] = RULE_CODE["R3-overflow"]
                edge_id[o_idx] = je
                two_hop[o_idx] = True
                stretch_e = self._stretch_scalar("edge", je)
                if self._occ_edge and a_idx.size:
                    self._serve_occupancy(je, t, a_idx, service, stretch_e)
                else:
                    service[a_idx] = base_edge * stretch_e

        cloud = tier == TIER_CLOUD
        if cloud.any():
            service[cloud] = (self.lat.infer_ms("cloud")
                              * self._stretch_scalar("cloud", 0))

        net = batched_rtt_draws(self.rng, self.lat, tier, two_hop)
        if self.extra_ms_vec_fn is not None:
            net = net + self.extra_ms_vec_fn(t, dev, tier, edge_id)
        lat_ms = net + service
        self._cols.extend(t, dev, tier, rule, lat_ms)
        if self._tel is not None:
            self._record_window(tier, rule, lat_ms)

    def _edge_groups(self, eb: np.ndarray, j: np.ndarray):
        """Window positions grouped by edge (arrival order within each
        group), ascending edge id.  A handful of open edges — the
        continuum sizes the paper sweeps — is grouped with one boolean
        scan per edge; larger edge counts fall back to a single stable
        argsort + split so cost stays O(n log n), not O(m n)."""
        if len(self.edges) <= _EDGE_SCAN_MAX:
            covered = 0
            for je in sorted(self.edges):
                m = np.flatnonzero(eb & (j == je))
                covered += m.size
                if m.size:
                    yield je, m
            if covered != int(np.count_nonzero(eb)):
                # an assigned edge with no admission state would slip
                # through the scans silently (the argsort path below
                # raises KeyError at self.edges[je]) — fail as loudly
                missing = np.setdiff1d(j[eb], list(self.edges))
                raise KeyError(f"requests routed to edges {missing} "
                               f"with no admission state (open edges: "
                               f"{sorted(self.edges)})")
            return
        eb_idx = np.nonzero(eb)[0]
        order = np.argsort(j[eb_idx], kind="stable")
        eb_sorted = eb_idx[order]
        je_sorted = j[eb_sorted]
        cuts = np.nonzero(np.diff(je_sorted))[0] + 1
        for m in np.split(eb_sorted, cuts):
            yield int(j[m[0]]), m

    def _serve_occupancy(self, je: int, t: np.ndarray, a_idx: np.ndarray,
                         service: np.ndarray, stretch_e: float) -> None:
        """Occupancy-dependent (calibrated) edge service: replay the
        per-edge occupancy process exactly through
        :func:`~repro.sim.request_plane.occupancy_replay` — stretches
        below the replica's slot count collapse to a closed-form bulk
        run, only genuinely oversubscribed stretches (where service and
        occupancy couple) replay with the scalar arithmetic.  Cost
        scales with time-at-oversubscription, not admitted load, and
        results are bit-identical to the per-request heap engine."""
        st = self.edges[je]
        pend = self._pending.get(je)
        if pend is None:
            pend = np.zeros(0, dtype=np.float64)
        svc, pend = occupancy_replay(
            t[a_idx], pend,
            base_ms=self.lat.base_service_ms("edge") * stretch_e,
            slots=self.lat.flat_service_slots("edge"),
            service_ms_fn=lambda occ: (
                self.lat.infer_ms("edge", occupancy=occ) * stretch_e))
        service[a_idx] = svc
        self._pending[je] = pend
        st.in_service = int(pend.size)

    # -- shared telemetry / log ---------------------------------------------

    def _record_window(self, tier: np.ndarray, rule: np.ndarray,
                       lat_ms: np.ndarray) -> None:
        """Bulk columnar recording: per-code ``count_nonzero`` passes
        (int8 compares — cheaper than bincount at these cardinalities)
        and one histogram merge per window, never a per-request Python
        call — what keeps enabled-mode overhead on the batched plane
        inside the CI gate.  Metric names match :meth:`_record_scalar`
        so both engines produce identical counter values for identical
        runs."""
        self._m_windows.value += 1.0
        n = tier.size
        if n == 0:
            return
        self._m_total.value += n
        left = n
        for k, c in enumerate(self._m_tier):
            if left == 0:
                break
            tc = int(np.count_nonzero(tier == k)) if k < 2 else left
            c.value += tc
            left -= tc
        left = n
        for k, c in enumerate(self._m_rule):
            if left == 0:
                break
            rc = (int(np.count_nonzero(rule == k))
                  if k < len(self._m_rule) - 1 else left)
            c.value += rc
            left -= rc
        self._m_hist.observe_array(lat_ms)

    def _record_scalar(self, tier_code: int, rule_code: int,
                       latency_ms: float) -> None:
        self._m_total.value += 1.0
        self._m_tier[tier_code].value += 1.0
        self._m_rule[rule_code].value += 1.0
        self._m_hist.observe(latency_ms)

    def recent_percentile(self, now: float, window_s: float, p: float,
                          min_requests: int = 1,
                          max_lookback: Optional[int] = None,
                          ) -> Optional[float]:
        """p-th latency percentile over requests arriving in
        ``[now - window_s, now]`` — the latency monitors' telemetry.
        None when the window holds fewer than ``min_requests``.

        Incremental over the columnar log (binary-searched window
        start from a monotone cursor): a telemetry tick costs
        O(log n + window), independent of total history.
        ``max_lookback`` is accepted for backward compatibility and
        ignored — the scan was capped when it rescanned Python lists;
        the columnar log makes the exact window affordable."""
        return self._cols.recent_percentile(now, window_s, p,
                                            min_requests=min_requests)

    def log(self) -> RequestLog:
        """Snapshot of the columnar log — O(n) array copies only; rule
        strings stay int8 codes until someone reads ``.rule``."""
        c = self._cols
        n = c.n
        return RequestLog(
            t=c.t[:n].copy(), device=c.device[:n].copy(),
            tier=c.tier[:n].astype(np.int64),
            latency_ms=c.latency_ms[:n].copy(),
            rule_code=c.rule[:n].copy())


def simulate(topo: ClusterTopology, cfg: SimConfig) -> RequestLog:
    """Inference-only run: Poisson arrivals, coin-flip training signal.
    ``cfg.engine`` picks the vectorized batched plane (default) or the
    per-request heap path (parity reference)."""
    rng = np.random.default_rng(cfg.seed)
    t_arr, dev_arr = poisson_request_arrays(topo.lam * cfg.rate_scale,
                                            cfg.duration_s, rng)
    sim = Simulation()
    if cfg.engine == "heap":
        proc = RequestProcessor(
            topo, rng, latency=cfg.latency, engine="heap",
            busy_fn=lambda i, t: rng.uniform() < cfg.busy_fraction)
        proc.bind(sim)
        for tt, dd in zip(t_arr, dev_arr):
            sim.schedule(tt, EventKind.REQUEST_ARRIVAL, node=int(dd))
    else:
        proc = RequestProcessor(
            topo, rng, latency=cfg.latency, engine=cfg.engine,
            busy_mask_fn=lambda d, t: rng.random(d.size)
            < cfg.busy_fraction)
        proc.bind(sim)
        proc.add_arrivals(t_arr, dev_arr)
    sim.run()
    return proc.log()


def compare_methods(inst, assigns: Dict[str, np.ndarray], cfg: SimConfig,
                    ) -> Dict[str, RequestLog]:
    """Run the same workload through several topologies (Fig. 7 setup:
    flat vs location-hierarchical vs HFLOP)."""
    out = {}
    for name, assign in assigns.items():
        if assign is None:           # flat FL
            topo = ClusterTopology.flat(inst.n, lam=inst.lam)
        else:
            topo = ClusterTopology(assign=np.asarray(assign),
                                   n_devices=inst.n, n_edges=inst.m,
                                   lam=inst.lam, r=inst.r, l=inst.l)
        out[name] = simulate(topo, cfg)
    return out
