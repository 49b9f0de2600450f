"""Discrete-event core of the training–inference co-simulation.

One heap-based clock, typed events, and handler dispatch.  Everything
that "happens" on the continuum — a request arriving, a local epoch
starting on a device, an aggregation upload occupying an edge, a node
dying, concept drift setting in — is an :class:`Event` on the same
timeline, so training and inference contend for the same per-node
compute instead of being simulated in isolation.

Determinism contract: events at equal timestamps are ordered by
``EventKind`` value (completions and state changes apply before the
requests that must observe them), then by insertion order.  Handlers
run in registration order.  Given the same seed and schedule, two runs
produce identical event traces — asserted in ``tests/test_cosim.py``.

Window iteration: the heap is the sparse *control plane*.  A dense
*request plane* (``repro.sim.request_plane``) can register a flush
hook via :meth:`Simulation.set_flush`; :meth:`Simulation.run` then
calls it for every half-open window ``[lo, hi)`` between consecutive
control-event timestamps *before* dispatching the event at ``hi`` —
so batched request processing observes exactly the state a per-request
heap run would have seen (same-instant control events still apply
before same-instant arrivals, which belong to the *next* window), and
monitors reading the request log at a control event see every earlier
arrival.  The final window up to ``until`` is flushed inclusively
after the loop drains.

Window fusion: not every control event warrants cutting a window.
Each :class:`EventKind` is classified by its effect on the request
plane (:data:`EVENT_EFFECTS`): *mutates-routing-inputs* (busy flags,
capacities, assignment, interference stretch, penalty windows, the
shared generator stream), *reads-request-log* (telemetry monitors), or
*neither*.  A window ending in an effect-free event is **fused** with
the next one — the flush is skipped and the pending arrivals ride
along until a flushing event (or the run tail) cuts them, which is
trace-equivalent by construction: the skipped event's handlers neither
change what routing would observe nor observe what routing produced.
A host (the co-sim) can refine the static table per event through
:attr:`Simulation.flush_gate` — e.g. an ``EPOCH_START`` on a device
that is *already* busy changes nothing the router can see — and
``fuse_windows=False`` restores a flush at every control event.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Callable, Dict, List, Optional, Tuple


class EventKind(IntEnum):
    """Typed simulation events.  The numeric value is the tie-break
    priority at equal timestamps: lower values are processed first, so
    a completion frees its slot, environment and training state changes
    apply, and only then do same-instant arrivals observe the world."""
    REQUEST_COMPLETION = 0   # a served request leaves its replica
    NODE_FAILURE = 1         # an edge host dies
    CAPACITY_CHANGE = 2      # an edge host's serving capacity shifts
    DEVICE_MOVE = 3          # a device hands over to another LAN edge
    STRAGGLER = 4            # a device's remaining epochs slow mid-round
    TENANT_LOAD = 5          # third-party edge demand changes (multi-tenant)
    DRIFT_ONSET = 6          # concept drift begins in the data stream
    RECONFIG_END = 7         # replica migration / re-deploy finishes
    ROUND_START = 8          # an HFL training round begins
    EPOCH_END = 9            # a device finishes one local epoch
    EPOCH_START = 10         # a device starts one local epoch
    AGG_START = 11           # aggregation upload window opens (edges busy)
    AGG_END = 12             # aggregation upload window closes
    ROUND_END = 13           # the training round is over
    TELEMETRY = 14           # periodic monitor tick (reactive loop)
    REQUEST_ARRIVAL = 15     # an inference request arrives
    # Fault-plane kinds sort AFTER same-instant arrivals (values above
    # REQUEST_ARRIVAL): a fault window opening at t applies to arrivals
    # strictly after t, and a retry landing exactly on an arrival's
    # timestamp re-attempts after that arrival was served.  ``run``
    # flushes the request plane *inclusively* before dispatching these,
    # so the batched engine observes the identical ordering.
    FAULT_START = 16         # a chaos-plan fault window opens
    FAULT_END = 17           # the fault clears (crash recovers, etc.)
    REQUEST_RETRY = 18       # a failed request re-attempts (backoff)
    # The batched engine's fault-window pacing beat (request-plane
    # internal, never appears in a heap run): while a crash/partition/
    # drop fault is live, each pending arrival gets a tick at its exact
    # timestamp so the pre-dispatch inclusive flush serves it *at that
    # instant* — a failed attempt then schedules its backoff retry in
    # the future, exactly where the heap engine would, instead of the
    # whole window's failures being discovered (and their retries
    # scheduled into the past) at the next control event.
    ARRIVAL_TICK = 19        # batched-plane pacing beat during faults


@dataclass(frozen=True)
class Event:
    t: float
    kind: EventKind
    node: int = -1           # device/edge id, -1 when not node-scoped
    payload: Any = None
    seq: int = 0             # insertion order (unique, the final tie-break)


class EventQueue:
    """Min-heap of events keyed by ``(t, kind, seq)``.  ``seq`` is unique,
    so heap entries never compare payloads."""

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, int, Event]] = []
        self._seq = 0

    def push(self, t: float, kind: EventKind, node: int = -1,
             payload: Any = None) -> Event:
        ev = Event(t=float(t), kind=kind, node=int(node), payload=payload,
                   seq=self._seq)
        heapq.heappush(self._heap, (ev.t, int(kind), ev.seq, ev))
        self._seq += 1
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[3]

    def peek_t(self) -> float:
        return self._heap[0][0] if self._heap else math.inf

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class EventEffect(IntEnum):
    """What dispatching one control event can do to the request plane —
    the window-fusion classification (see module docstring)."""
    NONE = 0                 # neither mutates routing inputs nor reads log
    MUTATES_ROUTING = 1      # busy flags / capacity / assign / stretch / rng
    READS_LOG = 2            # handler observes the request log (telemetry)


#: Static per-kind classification of the *co-sim's* handler contract.
#: ``STRAGGLER`` re-times future epochs (and the reactive drop policy
#: cancels future ones), ``DRIFT_ONSET`` only moves the accuracy model,
#: ``ROUND_START`` only schedules epoch/aggregation events — none of
#: them changes anything an in-flight request window can observe.
#: Everything else defaults to mutating; a custom handler that mutates
#: routing inputs on a ``NONE`` kind must set ``fuse_windows=False`` or
#: install a stricter ``flush_gate``.
EVENT_EFFECTS: Dict[EventKind, EventEffect] = {
    EventKind.REQUEST_COMPLETION: EventEffect.MUTATES_ROUTING,
    EventKind.NODE_FAILURE: EventEffect.MUTATES_ROUTING,
    EventKind.CAPACITY_CHANGE: EventEffect.MUTATES_ROUTING,
    EventKind.DEVICE_MOVE: EventEffect.MUTATES_ROUTING,
    EventKind.STRAGGLER: EventEffect.NONE,
    EventKind.TENANT_LOAD: EventEffect.MUTATES_ROUTING,
    EventKind.DRIFT_ONSET: EventEffect.NONE,
    EventKind.RECONFIG_END: EventEffect.MUTATES_ROUTING,
    EventKind.ROUND_START: EventEffect.NONE,
    EventKind.EPOCH_END: EventEffect.MUTATES_ROUTING,
    EventKind.EPOCH_START: EventEffect.MUTATES_ROUTING,
    EventKind.AGG_START: EventEffect.MUTATES_ROUTING,
    EventKind.AGG_END: EventEffect.MUTATES_ROUTING,
    EventKind.ROUND_END: EventEffect.MUTATES_ROUTING,
    EventKind.TELEMETRY: EventEffect.READS_LOG,
    EventKind.REQUEST_ARRIVAL: EventEffect.MUTATES_ROUTING,
    EventKind.FAULT_START: EventEffect.MUTATES_ROUTING,
    EventKind.FAULT_END: EventEffect.MUTATES_ROUTING,
    EventKind.REQUEST_RETRY: EventEffect.MUTATES_ROUTING,
    EventKind.ARRIVAL_TICK: EventEffect.MUTATES_ROUTING,
}


Handler = Callable[["Simulation", Event], None]

#: optional per-event refinement of :data:`EVENT_EFFECTS` — returns
#: True (flush), False (fuse), or None (use the static table).  Must
#: be decided *before* the event's handlers run, from state they have
#: not yet touched.
FlushGate = Callable[[Event], Optional[bool]]

#: flush hook signature: ``flush(lo, hi, inclusive)`` processes every
#: pending dense-plane arrival with ``lo <= t < hi`` (``t <= hi`` when
#: ``inclusive`` — the tail window of a bounded run).
FlushFn = Callable[[float, float, bool], None]

#: event kinds belonging to the dense request plane — excluded from
#: control-plane trace fingerprints when comparing the heap ("parity")
#: engine against the batched engine, which never materializes them.
REQUEST_PLANE_KINDS = frozenset({EventKind.REQUEST_ARRIVAL.name,
                                 EventKind.REQUEST_COMPLETION.name,
                                 EventKind.ARRIVAL_TICK.name})


def control_trace(trace: List[Tuple[float, str, int]],
                  ) -> List[Tuple[float, str, int]]:
    """The control-plane view of a trace: request arrivals/completions
    stripped, everything else untouched.  A heap run and a batched run
    of the same seeded scenario must agree on this view bit-for-bit."""
    return [row for row in trace if row[1] not in REQUEST_PLANE_KINDS]


@dataclass
class Simulation:
    """The clock + dispatcher.  Modules (request processor, training
    timeline, interference model, reactive loop) register handlers with
    :meth:`on` and schedule follow-up events from inside handlers."""
    record_trace: bool = False
    queue: EventQueue = field(default_factory=EventQueue)
    now: float = 0.0
    handlers: Dict[EventKind, List[Handler]] = field(default_factory=dict)
    trace: List[Tuple[float, str, int]] = field(default_factory=list)
    flush_fn: Optional[FlushFn] = None
    flushed_to: float = 0.0
    fuse_windows: bool = True        # skip flushes at effect-free events
    flush_gate: Optional[FlushGate] = None
    fused_windows: int = 0           # observability: flushes skipped
    flushed_closed: bool = False     # arrivals at exactly ``flushed_to``
    #                                  already consumed (inclusive flush)

    def on(self, kind: EventKind, handler: Handler) -> None:
        self.handlers.setdefault(kind, []).append(handler)

    def set_flush(self, fn: Optional[FlushFn]) -> None:
        """Register the dense request plane's window flush (see module
        docstring); ``run`` becomes window iteration over the control
        events."""
        self.flush_fn = fn

    def schedule(self, t: float, kind: EventKind, node: int = -1,
                 payload: Any = None) -> Event:
        return self.queue.push(t, kind, node=node, payload=payload)

    def _needs_flush(self, ev: Event) -> bool:
        """Whether the window ending at ``ev`` must flush before the
        event's handlers run — the fusion decision (module docstring)."""
        if not self.fuse_windows:
            return True
        if self.flush_gate is not None:
            verdict = self.flush_gate(ev)
            if verdict is not None:
                return verdict
        return EVENT_EFFECTS.get(
            ev.kind, EventEffect.MUTATES_ROUTING) is not EventEffect.NONE

    def run(self, until: float = math.inf) -> int:
        """Process events in order until the queue drains or the next
        event lies beyond ``until`` (which stays queued).  With a flush
        hook registered, the dense plane is advanced through every
        inter-event window first — except windows ending in an
        effect-free event, which fuse into the next one — and through
        the tail window up to ``until`` (inclusive) once the control
        events drain."""
        processed = 0
        while self.queue and self.queue.peek_t() <= until:
            ev = self.queue.pop()
            # kinds above REQUEST_ARRIVAL dispatch after same-instant
            # arrivals in the heap ordering, so their pre-dispatch flush
            # must consume arrivals at exactly ev.t too
            late = int(ev.kind) > int(EventKind.REQUEST_ARRIVAL)
            if self.flush_fn is not None and (
                    ev.t > self.flushed_to
                    or (late and ev.t == self.flushed_to
                        and not self.flushed_closed)):
                if self._needs_flush(ev):
                    self.flush_fn(self.flushed_to, ev.t, late)
                    self.flushed_to = ev.t
                    self.flushed_closed = late
                else:
                    self.fused_windows += 1
            self.now = ev.t
            if self.record_trace:
                self.trace.append((round(ev.t, 9), ev.kind.name, ev.node))
            for h in self.handlers.get(ev.kind, ()):
                h(self, ev)
            processed += 1
        if self.flush_fn is not None and until >= self.flushed_to:
            self.flush_fn(self.flushed_to, until, True)
            self.flushed_to = until
            self.flushed_closed = True
        return processed
