"""Seeded, deterministic chaos plans for the co-simulation.

A :class:`FaultPlan` describes *where and when* things break on the
continuum: edge/aggregator crash-and-recover cycles (MTTF/MTTR draws),
transient network partitions, request-drop and latency-spike bursts,
and correlated failure domains spanning whole LAN groups.  Plans are
pure descriptions — :func:`compile_plan` materializes them into sorted
:class:`FaultWindow` intervals using **only** the generator passed in,
which the co-sim wires to the shared per-run stream (contract DET003:
no fresh ``default_rng`` in fault or retry code).  The co-sim turns
each window into a ``FAULT_START``/``FAULT_END`` control-event pair,
so the same compiled plan drives the heap and the batched engines to
bit-identical fault timelines.

Non-perturbation contract: a run that never calls
``CoSim.schedule_faults`` draws nothing from this module and schedules
no fault events — its fingerprints are bit-identical to a build
without the chaos subsystem (pinned in ``tests/test_faults.py``
against ``tests/data/golden_fingerprints.json``).

Recipes::

    # one edge crashing and recovering (exponential MTTF/MTTR)
    EdgeOutagePlan(mttf_s=60.0, mttr_s=8.0, edges=(1,))

    # a whole LAN failure domain going dark together
    DomainOutagePlan(domains=((0, 1), (2, 3)), mttf_s=120.0, mttr_s=10.0)

    # transient partition: edge 2 unreachable for 15 s starting at t=30
    PartitionPlan(windows=((30.0, 45.0),), edges=(2,))

    # 20% request drops on edge 0 in recurring bursts
    DropBurstPlan(p_drop=0.2, every_s=40.0, burst_s=6.0, edges=(0,))

    # +12 ms network spike on every edge between t=50 and t=70
    LatencySpikePlan(windows=((50.0, 70.0),), spike_ms=12.0)

    # compose freely
    plan = EdgeOutagePlan(...) + DropBurstPlan(...)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

#: fault window kinds (``FaultWindow.kind``)
FAULT_CRASH = "crash"          # edge host down: attempts fail, retry/failover
FAULT_PARTITION = "partition"  # transiently unreachable: same request-plane
#                                effect as a crash, but no standby promotion
FAULT_DROP = "drop"            # edge serves, but drops requests w.p. param
FAULT_SPIKE = "spike"          # edge serves, +param ms network latency

#: kinds that make an edge unreachable to the request plane
DOWN_KINDS = frozenset({FAULT_CRASH, FAULT_PARTITION})


@dataclass(frozen=True)
class FaultWindow:
    """One materialized fault interval ``[t0, t1)`` on a set of edges.
    ``param`` is the drop probability (``drop``) or the added latency
    in ms (``spike``); unused for crash/partition."""
    t0: float
    t1: float
    kind: str
    edges: Tuple[int, ...]
    param: float = 0.0


class FaultPlan:
    """Base class: a composable, declarative chaos description.
    Subclasses implement :meth:`windows`; ``plan_a + plan_b`` composes.
    """

    def windows(self, rng: np.random.Generator, n_edges: int,
                duration_s: float) -> List[FaultWindow]:
        raise NotImplementedError

    def __add__(self, other: "FaultPlan") -> "ComposedPlan":
        mine = self.plans if isinstance(self, ComposedPlan) else (self,)
        theirs = (other.plans if isinstance(other, ComposedPlan)
                  else (other,))
        return ComposedPlan(plans=tuple(mine) + tuple(theirs))


@dataclass(frozen=True)
class ComposedPlan(FaultPlan):
    plans: Tuple[FaultPlan, ...] = ()

    def windows(self, rng, n_edges, duration_s):
        out: List[FaultWindow] = []
        for p in self.plans:          # fixed order: one shared draw stream
            out.extend(p.windows(rng, n_edges, duration_s))
        return out


def _resolve_edges(edges: Optional[Sequence[int]],
                   n_edges: int) -> Tuple[int, ...]:
    if edges is None:
        return tuple(range(n_edges))
    return tuple(int(e) for e in edges)


def _alternating_windows(rng: np.random.Generator, mttf_s: float,
                         mttr_s: float, start_s: float,
                         duration_s: float) -> List[Tuple[float, float]]:
    """Up/down renewal process: exponential time-to-failure, then
    exponential time-to-repair, repeated until the horizon.  One
    ``rng.exponential`` draw per phase, in timeline order — the draw
    sequence is the plan's identity."""
    out: List[Tuple[float, float]] = []
    t = start_s
    while t < duration_s:
        t += float(rng.exponential(mttf_s))
        if t >= duration_s:
            break
        dt = float(rng.exponential(mttr_s))
        out.append((t, min(t + dt, duration_s)))
        t += dt
    return out


@dataclass(frozen=True)
class EdgeOutagePlan(FaultPlan):
    """Independent crash-and-recover cycles per edge (aggregator
    hosts *are* edges in this stack, so this is also the aggregator
    crash plan).  Draws per edge in ascending edge order."""
    mttf_s: float
    mttr_s: float
    edges: Optional[Tuple[int, ...]] = None   # None = all edges
    start_s: float = 0.0
    kind: str = FAULT_CRASH

    def windows(self, rng, n_edges, duration_s):
        out: List[FaultWindow] = []
        for e in sorted(_resolve_edges(self.edges, n_edges)):
            for t0, t1 in _alternating_windows(
                    rng, self.mttf_s, self.mttr_s, self.start_s,
                    duration_s):
                out.append(FaultWindow(t0, t1, self.kind, (e,)))
        return out


@dataclass(frozen=True)
class DomainOutagePlan(FaultPlan):
    """Correlated failure domains: every edge of a domain (a LAN
    group, a rack, a shared uplink) goes down and recovers *together*
    — one MTTF/MTTR draw stream per domain, not per edge."""
    domains: Tuple[Tuple[int, ...], ...]
    mttf_s: float
    mttr_s: float
    start_s: float = 0.0
    kind: str = FAULT_CRASH

    def windows(self, rng, n_edges, duration_s):
        out: List[FaultWindow] = []
        for dom in self.domains:
            edges = tuple(sorted(int(e) for e in dom))
            for t0, t1 in _alternating_windows(
                    rng, self.mttf_s, self.mttr_s, self.start_s,
                    duration_s):
                out.append(FaultWindow(t0, t1, self.kind, edges))
        return out


@dataclass(frozen=True)
class PartitionPlan(FaultPlan):
    """Transient network partitions at fixed times (no draws): the
    edges are unreachable during each window but their state (bucket,
    in-flight training) survives — the request plane treats this
    exactly like a crash, but the co-sim skips standby promotion."""
    windows_s: Tuple[Tuple[float, float], ...]
    edges: Optional[Tuple[int, ...]] = None

    def windows(self, rng, n_edges, duration_s):
        edges = _resolve_edges(self.edges, n_edges)
        return [FaultWindow(float(t0), min(float(t1), duration_s),
                            FAULT_PARTITION, edges)
                for t0, t1 in self.windows_s if t0 < duration_s]


@dataclass(frozen=True)
class DropBurstPlan(FaultPlan):
    """Recurring request-drop bursts: every ``every_s`` (exponential
    gaps), the affected edges drop each served request with
    probability ``p_drop`` for ``burst_s`` seconds."""
    p_drop: float
    every_s: float
    burst_s: float
    edges: Optional[Tuple[int, ...]] = None
    start_s: float = 0.0

    def windows(self, rng, n_edges, duration_s):
        edges = _resolve_edges(self.edges, n_edges)
        out: List[FaultWindow] = []
        t = self.start_s
        while True:
            t += float(rng.exponential(self.every_s))
            if t >= duration_s:
                break
            out.append(FaultWindow(t, min(t + self.burst_s, duration_s),
                                   FAULT_DROP, edges, self.p_drop))
            t += self.burst_s
        return out


@dataclass(frozen=True)
class LatencySpikePlan(FaultPlan):
    """Fixed latency-spike windows: +``spike_ms`` on every request
    that touches an affected edge (served there or transiting it).
    Purely deterministic — no draws, no drops, no retries."""
    windows_s: Tuple[Tuple[float, float], ...]
    spike_ms: float
    edges: Optional[Tuple[int, ...]] = None

    def windows(self, rng, n_edges, duration_s):
        edges = _resolve_edges(self.edges, n_edges)
        return [FaultWindow(float(t0), min(float(t1), duration_s),
                            FAULT_SPIKE, edges, self.spike_ms)
                for t0, t1 in self.windows_s if t0 < duration_s]


def compile_plan(plan: FaultPlan, rng: np.random.Generator,
                 n_edges: int, duration_s: float) -> List[FaultWindow]:
    """Materialize ``plan`` into a sorted list of non-empty fault
    windows clipped to ``[0, duration_s)``.  All randomness comes from
    ``rng`` — the co-sim passes its shared per-run generator, so the
    compiled timeline is identical across engines and runs."""
    wins = [w for w in plan.windows(rng, n_edges, duration_s)
            if w.t1 > w.t0 and w.t0 < duration_s]
    wins.sort(key=lambda w: (w.t0, w.t1, w.kind, w.edges))
    return wins
