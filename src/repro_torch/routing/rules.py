"""Inference request routing rules (paper §III):

  R1  device busy training          -> offload to its aggregator
  R2  device idle / not in round    -> serve locally (or closest aggregator)
  R3  aggregator serves its busy devices with priority; load beyond its
      capacity is forwarded to the cloud (aggregator acts as device proxy)

The router is deliberately separated from the event simulator so the same
logic drives (a) the paper-faithful discrete-event evaluation and (b) the
TPU serving driver, where "edge" = pod and "cloud" = cross-pod overflow.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class EdgeState:
    """Leaky-bucket admission state of one aggregator: r_j is a *rate*
    (requests/s, the paper's capacity semantics); the bucket smooths
    bursts over ~1 s.  Requests beyond the sustainable rate overflow to
    the cloud (rule R3)."""
    capacity_rps: float              # r_j
    tokens: float = 0.0
    last_t: float = 0.0
    burst_s: float = 1.0             # bucket depth in seconds of capacity
    in_service: int = 0              # retained for observability

    def __post_init__(self):
        if np.isfinite(self.capacity_rps):
            self.tokens = self.capacity_rps * self.burst_s

    def _refill(self, now: float) -> None:
        cap = self.capacity_rps * self.burst_s
        self.tokens = min(cap, self.tokens
                          + self.capacity_rps * max(now - self.last_t, 0.0))
        self.last_t = now

    def has_room(self, priority: bool, now: float = None) -> bool:
        if not np.isfinite(self.capacity_rps):
            return True
        if now is not None:
            self._refill(now)
        # R3: non-priority (external/idle-device) requests are admitted
        # only if load is sufficiently below capacity
        reserve = 0.0 if priority else 0.2 * self.capacity_rps * self.burst_s
        return self.tokens - 1.0 >= reserve

    def admit(self, now: float) -> None:
        self._refill(now)
        self.tokens -= 1.0
        self.in_service += 1


@dataclass
class RouteDecision:
    tier: str                        # device | edge | cloud
    edge: Optional[int] = None
    hops: int = 1                    # network legs paid
    rule: str = ""


def route_request(device: int, busy_training: bool, assign: np.ndarray,
                  edges: dict, external: bool = False,
                  now: float = None) -> RouteDecision:
    """Apply R1-R3 for one request.  ``edges`` maps edge id -> EdgeState."""
    j = int(assign[device]) if 0 <= device < len(assign) else -1
    if busy_training:                                   # R1
        if j < 0:                                       # flat FL: no edge
            return RouteDecision("cloud", None, hops=1, rule="R1-flat")
        st = edges[j]
        if st.has_room(priority=True, now=now):         # R3 priority
            return RouteDecision("edge", j, hops=1, rule="R1")
        return RouteDecision("cloud", j, hops=2, rule="R3-overflow")
    # R2: idle device serves locally; external requests go to the closest
    # aggregator (non-priority admission per R3)
    if not external:
        return RouteDecision("device", None, hops=0, rule="R2-local")
    if j >= 0 and edges[j].has_room(priority=False, now=now):
        return RouteDecision("edge", j, hops=1, rule="R2-edge")
    return RouteDecision("cloud", j if j >= 0 else None,
                         hops=2 if j >= 0 else 1, rule="R2-cloud")
