"""Continuum telemetry: metrics, span tracing, and decision audit.

One `Telemetry` object carries the three instruments the orchestration
stack shares:

- ``metrics`` — :class:`~repro.telemetry.registry.MetricsRegistry`
  (counters / gauges / histograms with bulk columnar recording for the
  vectorized request plane).
- ``tracer`` — :class:`~repro.telemetry.tracer.SpanTracer` (rounds,
  epochs, aggregation windows, deployment swaps, solver phases,
  serving admit/measure → Chrome/Perfetto trace JSON + JSONL).
- ``audit`` — :class:`~repro.telemetry.audit.DecisionAudit` (every
  orchestration action with trigger, evidence, budget charge, and
  applied/deferred/forced outcome).

Usage::

    from repro_torch.telemetry import Telemetry
    tel = Telemetry()
    res = run_scenario(SCENARIOS["churn"](), "budgeted", telemetry=tel)
    tel.write_trace("trace.json")          # load in ui.perfetto.dev
    tel.audit.write_jsonl("audit.jsonl")
    print(tel.to_prometheus())

Zero-overhead contract: instrumented classes resolve
``self._tel = maybe(telemetry)`` once at construction — `maybe` returns
``None`` unless telemetry is present *and* enabled, so disabled-mode
hot paths pay exactly one ``is None`` branch and never build a single
telemetry object.  Enabled or not, telemetry never draws from any RNG
stream, never schedules events, and never mutates simulation state:
control fingerprints are bit-identical with telemetry on or off
(asserted across the scenario suite in ``tests/test_telemetry.py``).

This package is numpy-only (no jax imports) so the routing/sim
importers stay jax-free.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from repro_torch.telemetry.audit import AuditRecord, DecisionAudit, OUTCOMES
from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, Text,
                                      DEFAULT_LATENCY_EDGES_MS)
from repro_torch.telemetry.tracer import Instant, Span, SpanTracer

__all__ = [
    "Telemetry", "maybe", "MetricsRegistry", "Counter", "Gauge",
    "Histogram", "Text", "SpanTracer", "Span", "Instant",
    "DecisionAudit", "AuditRecord", "OUTCOMES",
    "DEFAULT_LATENCY_EDGES_MS",
]


class Telemetry:
    """Facade bundling a metrics registry, span tracer, and audit log."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = bool(enabled)
        self.metrics = MetricsRegistry()
        self.tracer = SpanTracer()
        self.audit = DecisionAudit()

    # -- export surface --------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """JSON-able snapshot of everything recorded so far."""
        return {
            "enabled": self.enabled,
            "metrics": self.metrics.snapshot(),
            "spans": len(self.tracer.spans),
            "instants": len(self.tracer.instants),
            "audit": self.audit.counts(),
        }

    def to_prometheus(self) -> str:
        return self.metrics.to_prometheus()

    def write_snapshot(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)

    def write_trace(self, path: str) -> None:
        """Chrome/Perfetto trace-event JSON (open in ui.perfetto.dev)."""
        self.tracer.write_chrome(path)

    def write_trace_jsonl(self, path: str) -> None:
        self.tracer.write_jsonl(path)


def maybe(telemetry: Optional[Telemetry]) -> Optional[Telemetry]:
    """Resolve a telemetry argument to the hot-path handle: the object
    itself when present and enabled, else ``None`` — so instrumented
    code guards with a single ``if self._tel is not None``."""
    if telemetry is not None and telemetry.enabled:
        return telemetry
    return None
