"""Span tracer over the control plane, exporting Chrome/Perfetto JSON.

Spans live in one of two clock domains:

- ``sim`` — simulated seconds (co-sim event times): rounds, epochs,
  aggregation windows, deployment-swap migration windows.  Opened and
  closed with explicit event times via :meth:`SpanTracer.open` /
  :meth:`SpanTracer.close` (keyed, so interleaved rounds across
  subtrees nest correctly), or recorded whole via
  :meth:`SpanTracer.complete` when the duration is known up front.
- ``wall`` — real ``time.perf_counter`` seconds: solver phases,
  serving-engine admit/measure.  Recorded with the
  :meth:`SpanTracer.wall` context manager.

Exports: :meth:`to_chrome` emits the Chrome trace-event format that
Perfetto / ``chrome://tracing`` load directly (complete events
``ph:"X"``, instants ``ph:"i"``, microsecond timestamps; the two clock
domains map to two pids with ``process_name`` metadata so they get
separate tracks).  :meth:`write_jsonl` dumps one span per line for
ad-hoc grepping.

Like the rest of `repro.telemetry`, the tracer never draws randomness
or schedules events — instrumented code calls it from inside existing
handlers only, so event ordering and control fingerprints are
bit-identical with tracing on or off.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Hashable, Iterator, List, Optional

_PID = {"sim": 1, "wall": 2}


def wall_clock() -> float:
    """The repo's one audited wall-clock read (``time.perf_counter``).

    Solver/control-path code that legitimately measures real elapsed
    time (``HFLOPSolution.wall_time_s``, the MILP time limit,
    ``Deployment.created_at``) calls this seam instead of the ``time``
    module directly: the determinism contract (DET002, see
    CONTRACTS.md) forbids raw wall-clock reads in sim/control/solver
    paths, so every remaining read is greppable here and never leaks
    into event ordering, routing decisions, or RNG streams."""
    return time.perf_counter()


@dataclass
class Span:
    """One closed interval.  ``t0``/``dur`` are seconds in the span's
    clock domain (sim time or wall time relative to tracer creation)."""

    name: str
    t0: float
    dur: float
    cat: str = ""
    tid: int = 0
    domain: str = "sim"
    args: Dict[str, object] = field(default_factory=dict)


@dataclass
class Instant:
    name: str
    t: float
    cat: str = ""
    tid: int = 0
    domain: str = "sim"
    args: Dict[str, object] = field(default_factory=dict)


class SpanTracer:
    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.instants: List[Instant] = []
        self._open: Dict[Hashable, Span] = {}
        self._wall0 = time.perf_counter()

    # -- sim-time spans (explicit event times) -------------------------
    def open(self, key: Hashable, name: str, t: float, cat: str = "",
             tid: int = 0, **args) -> None:
        """Start a keyed sim-time span at event time ``t``.  Re-opening
        a live key abandons the previous (never-closed) span."""
        self._open[key] = Span(name=name, t0=float(t), dur=-1.0, cat=cat,
                               tid=tid, domain="sim", args=dict(args))

    def close(self, key: Hashable, t: float, **args) -> Optional[Span]:
        """Close a keyed span at event time ``t``; unknown keys are
        ignored (e.g. the epoch was cancelled before it started)."""
        sp = self._open.pop(key, None)
        if sp is None:
            return None
        sp.dur = float(t) - sp.t0
        if args:
            sp.args.update(args)
        self.spans.append(sp)
        return sp

    def complete(self, name: str, t: float, dur: float, cat: str = "",
                 tid: int = 0, domain: str = "sim", **args) -> Span:
        """Record a span whose duration is already known (e.g. a
        deployment-swap migration window of length ``reconfig_s``)."""
        sp = Span(name=name, t0=float(t), dur=float(dur), cat=cat,
                  tid=tid, domain=domain, args=dict(args))
        self.spans.append(sp)
        return sp

    def instant(self, name: str, t: float, cat: str = "", tid: int = 0,
                domain: str = "sim", **args) -> None:
        self.instants.append(Instant(name=name, t=float(t), cat=cat,
                                     tid=tid, domain=domain,
                                     args=dict(args)))

    # -- wall-time spans ------------------------------------------------
    @contextmanager
    def wall(self, name: str, cat: str = "", tid: int = 0,
             **args) -> Iterator[Span]:
        """Time a code block on the wall clock; yields the Span so the
        caller can read ``.dur`` afterwards (solver phase view)."""
        sp = Span(name=name, t0=time.perf_counter() - self._wall0,
                  dur=-1.0, cat=cat, tid=tid, domain="wall",
                  args=dict(args))
        try:
            yield sp
        finally:
            sp.dur = (time.perf_counter() - self._wall0) - sp.t0
            self.spans.append(sp)

    # -- queries ---------------------------------------------------------
    def durations(self, prefix: str = "") -> Dict[str, float]:
        """Total duration per span name, filtered by (and stripped of)
        ``prefix`` — e.g. ``durations("solve_decomposed.")`` returns
        ``{"partition": 0.12, ...}``."""
        out: Dict[str, float] = {}
        for sp in self.spans:
            if sp.name.startswith(prefix):
                k = sp.name[len(prefix):]
                out[k] = out.get(k, 0.0) + sp.dur
        return out

    def by_cat(self, cat: str) -> List[Span]:
        return [sp for sp in self.spans if sp.cat == cat]

    # -- exports ---------------------------------------------------------
    def to_chrome(self) -> List[Dict[str, object]]:
        """Chrome trace-event list (load the written file directly in
        Perfetto or chrome://tracing).  Sim time and wall time become
        separate processes; still-open spans are omitted."""
        events: List[Dict[str, object]] = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"{dom}-time"}}
            for dom, pid in _PID.items()]
        for sp in self.spans:
            events.append({
                "name": sp.name, "cat": sp.cat or "span", "ph": "X",
                "ts": sp.t0 * 1e6, "dur": max(sp.dur, 0.0) * 1e6,
                "pid": _PID[sp.domain], "tid": sp.tid,
                "args": dict(sp.args)})
        for ins in self.instants:
            events.append({
                "name": ins.name, "cat": ins.cat or "event", "ph": "i",
                "ts": ins.t * 1e6, "pid": _PID[ins.domain],
                "tid": ins.tid, "s": "t", "args": dict(ins.args)})
        events.sort(key=lambda e: (e["ph"] == "M" and -1.0 or e["ts"],
                                   e["pid"], e["tid"]))
        return events

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.to_chrome(),
                       "displayTimeUnit": "ms"}, f)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for sp in self.spans:
                f.write(json.dumps({
                    "kind": "span", "name": sp.name, "cat": sp.cat,
                    "t0": sp.t0, "dur": sp.dur, "tid": sp.tid,
                    "domain": sp.domain, "args": sp.args}) + "\n")
            for ins in self.instants:
                f.write(json.dumps({
                    "kind": "instant", "name": ins.name, "cat": ins.cat,
                    "t": ins.t, "tid": ins.tid, "domain": ins.domain,
                    "args": ins.args}) + "\n")
