"""Metrics registry: counters, gauges, histograms, text annotations.

The registry is the quantitative half of the continuum telemetry layer
(`repro.telemetry`): control-plane handlers count events, the reactive
loop gauges budget state, and the vectorized request plane records
whole windows at a time through the **bulk** histogram/counter APIs —
a handful of vectorized passes per window (an integer-grid bucket LUT
replaces the per-element binary search on the default latency edges)
instead of per-request Python calls, so enabled-mode overhead on the
batched engine stays in the single-digit percent range (gated in
``scripts/ci.sh``).

Instruments are created lazily on first use and identified by dotted
names (``requests.rule.R3-overflow``, ``reconfig.budget_spent``); the
same name always returns the same instrument.  Exports:
:meth:`MetricsRegistry.snapshot` (plain JSON-able dict) and
:meth:`MetricsRegistry.to_prometheus` (text exposition format, dots
sanitized to underscores).

Determinism contract (shared with the whole telemetry layer): nothing
here draws randomness, schedules events, or mutates anything outside
its own arrays — recording is observation only.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import numpy as np

#: default latency-histogram bucket upper bounds (ms) — geometric, so
#: one array covers on-device fast paths and cloud round trips alike.
DEFAULT_LATENCY_EDGES_MS = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0)


class Counter:
    """Monotonically increasing scalar (float amounts allowed — budget
    spend is metered in edge-compute-seconds)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = math.nan

    def set(self, value: float) -> None:
        self.value = float(value)


class Text:
    """String annotation (non-numeric benchmark fields, build info)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = ""

    def set(self, value: str) -> None:
        self.value = str(value)


class Histogram:
    """Fixed-bucket histogram with bulk columnar recording.

    ``edges`` are ascending bucket *upper* bounds; values above the
    last edge land in the overflow (+Inf) bucket.  ``observe_array``
    merges a whole column in one ``searchsorted`` + ``bincount`` pass
    and is exactly equivalent to scalar ``observe`` per element
    (bucket counts are integer arithmetic; only the float ``sum`` can
    differ in the last bits from the different add order — asserted as
    a hypothesis property in ``tests/test_properties.py``)."""

    __slots__ = ("name", "edges", "counts", "count", "sum", "min", "max",
                 "_lut", "_lut_top", "_lut_max", "_lut_starts")

    #: LUT fast-path cap: integer edge grids up to this top edge
    #: precompute a value->bucket table (8 bytes/entry).
    _LUT_MAX_EDGE = 1_000_000

    def __init__(self, name: str, edges=DEFAULT_LATENCY_EDGES_MS):
        self.name = name
        self.edges = np.asarray(edges, dtype=np.float64)
        if self.edges.ndim != 1 or self.edges.size == 0 or np.any(
                np.diff(self.edges) <= 0):
            raise ValueError(f"histogram {name!r}: edges must be a "
                             f"non-empty ascending 1-D sequence")
        self.counts = np.zeros(self.edges.size + 1, dtype=np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # bulk fast path: for non-negative *integer* edges (the default
        # latency grid), searchsorted(edges, v, "left") equals
        # lut[ceil(v)] — an integer edge e satisfies e >= v exactly when
        # e >= ceil(v).  Rather than gathering through the LUT we
        # bincount the integerized values directly (ceil + an int32
        # cast, both SIMD) and fold the fine-grained counts into the
        # buckets with one reduceat over the LUT's step starts — ~6x
        # cheaper than the per-element binary search on request-plane
        # windows.
        e0 = float(self.edges[0])
        top = float(self.edges[-1])
        if (e0 >= 0.0 and top <= self._LUT_MAX_EDGE
                and np.all(self.edges == np.floor(self.edges))):
            grid = np.arange(int(top) + 2, dtype=np.float64)
            self._lut = np.searchsorted(self.edges, grid,
                                        side="left").astype(np.int64)
            self._lut_top = top
            self._lut_max = float(int(top) + 1)   # maps to overflow
            # first ceil-value belonging to each bucket; integer edges
            # ascend by >= 1, so every bucket 0..edges.size appears
            # exactly once and len == counts.size.
            self._lut_starts = np.searchsorted(
                self._lut, np.arange(self.counts.size), side="left")
        else:
            self._lut = None
            self._lut_top = 0.0
            self._lut_max = 0.0
            self._lut_starts = None

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[int(np.searchsorted(self.edges, v, side="left"))] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def observe_array(self, values: np.ndarray) -> None:
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        mn = float(np.min(v))
        mx = float(np.max(v))
        if self._lut is not None:
            if mn >= 0.0 and mx <= self._lut_top:
                k = np.ceil(v).astype(np.int32)
            else:
                k = np.ceil(np.minimum(np.maximum(v, 0.0),
                                       self._lut_max)).astype(np.int32)
            ck = np.bincount(k, minlength=self._lut.size)
            self.counts += np.add.reduceat(ck, self._lut_starts)
        else:
            idx = np.searchsorted(self.edges, v, side="left")
            self.counts += np.bincount(idx, minlength=self.counts.size)
        self.count += int(v.size)
        self.sum += float(np.sum(v))
        self.min = min(self.min, mn)
        self.max = max(self.max, mx)

    def quantile(self, p: float) -> float:
        """Approximate p-th percentile (p in [0, 100]) by linear
        interpolation inside the containing bucket; NaN when empty."""
        if self.count == 0:
            return math.nan
        target = self.count * p / 100.0
        cum = np.cumsum(self.counts)
        k = int(np.searchsorted(cum, target, side="left"))
        lo = 0.0 if k == 0 else float(self.edges[k - 1])
        hi = (float(self.edges[k]) if k < self.edges.size
              else max(self.max, lo))
        within = self.counts[k]
        frac = ((target - (cum[k - 1] if k > 0 else 0)) / within
                if within > 0 else 0.0)
        return lo + min(max(frac, 0.0), 1.0) * (hi - lo)

    def snapshot(self) -> Dict[str, object]:
        buckets = {f"le_{e:g}": int(c)
                   for e, c in zip(self.edges, self.counts[:-1])}
        buckets["le_inf"] = int(self.counts[-1])
        return {"count": int(self.count), "sum": float(self.sum),
                "min": (float(self.min) if self.count else math.nan),
                "max": (float(self.max) if self.count else math.nan),
                "buckets": buckets}


Instrument = Union[Counter, Gauge, Histogram, Text]


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return ("_" + s) if s and s[0].isdigit() else s


def _prom_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return f"{v:g}"


class MetricsRegistry:
    """Lazily created, name-keyed instruments.  Asking for an existing
    name with a different type is a bug and raises."""

    def __init__(self) -> None:
        self._instruments: Dict[str, Instrument] = {}

    def _get(self, name: str, cls, *args) -> Instrument:
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, *args)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def text(self, name: str) -> Text:
        return self._get(name, Text)

    def histogram(self, name: str,
                  edges=DEFAULT_LATENCY_EDGES_MS) -> Histogram:
        return self._get(name, Histogram, edges)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def get(self, name: str) -> Optional[Instrument]:
        return self._instruments.get(name)

    def value(self, name: str, default: float = 0.0) -> float:
        """Scalar value of a counter/gauge, ``default`` when absent —
        the convenience read for tests and benchmark reporters."""
        inst = self._instruments.get(name)
        if inst is None or isinstance(inst, Histogram):
            return default
        return inst.value

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "texts": {}, "histograms": {}}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if isinstance(inst, Counter):
                out["counters"][name] = float(inst.value)
            elif isinstance(inst, Gauge):
                out["gauges"][name] = float(inst.value)
            elif isinstance(inst, Text):
                out["texts"][name] = inst.value
            else:
                out["histograms"][name] = inst.snapshot()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (``repro_`` prefix, dots
        sanitized to underscores, cumulative histogram buckets)."""
        lines: List[str] = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            pname = "repro_" + _prom_name(name)
            if isinstance(inst, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {_prom_value(inst.value)}")
            elif isinstance(inst, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_prom_value(inst.value)}")
            elif isinstance(inst, Text):
                lines.append(f"# TYPE {pname}_info gauge")
                lines.append(f'{pname}_info{{value="{inst.value}"}} 1')
            else:
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for e, c in zip(inst.edges, inst.counts[:-1]):
                    cum += int(c)
                    lines.append(f'{pname}_bucket{{le="{e:g}"}} {cum}')
                cum += int(inst.counts[-1])
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{pname}_sum {_prom_value(inst.sum)}")
                lines.append(f"{pname}_count {inst.count}")
        return "\n".join(lines) + ("\n" if lines else "")
