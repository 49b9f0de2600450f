"""Latency model for inference serving (paper §V-C1): a copy of
``repro/routing/latency.py``, so that the port's measured per-tier times
calibrate the routing simulator without importing the JAX package.

The paper measured HTTP round-trip times: cloud 50-100 ms, edge 8-10 ms.
Processing time is the model's inference time, scaled per serving tier:
Fig. 8 sweeps a "theoretical speedup of up to 95%" of cloud vs edge
compute, i.e. cloud_infer = edge_infer * (1 - speedup).

Two service-time models share this interface:

  - :class:`LatencyModel` — the paper's constant closed-form per-tier
    inference time (the fast default; reproduces Fig. 7/8 exactly);
  - :class:`CalibratedLatencyModel` — per-tier service times *measured*
    from the real serving replicas (``ReplicaPool.measure()``), with
    occupancy-dependent slowdown once a replica's continuous-batching
    slots are oversubscribed.  Built via
    ``LatencyModel.from_measurements(...)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping

import numpy as np


@dataclass(frozen=True)
class LatencyModel:
    edge_rtt_ms: tuple = (8.0, 10.0)       # uniform, paper §V-C1
    cloud_rtt_ms: tuple = (50.0, 100.0)    # uniform, paper §V-C1
    device_rtt_ms: tuple = (0.0, 0.0)      # on-device serving: no network
    base_infer_ms: float = 2.0             # GRU forward on an edge host
    cloud_speedup: float = 0.0             # Fig. 8: 0..0.95
    device_slowdown: float = 2.0           # devices slower than edge hosts

    def rtt(self, tier: str, rng: np.random.Generator,
            size=None) -> np.ndarray:
        lo, hi = {"device": self.device_rtt_ms,
                  "edge": self.edge_rtt_ms,
                  "cloud": self.cloud_rtt_ms}[tier]
        return rng.uniform(lo, hi, size)

    def infer_ms(self, tier: str, occupancy: float = 0.0) -> float:
        """Service time of one request on ``tier``.  ``occupancy`` is the
        number of requests already in service on the chosen replica; the
        constant model ignores it (closed-form paper behaviour)."""
        if tier == "cloud":
            return self.base_infer_ms * (1.0 - self.cloud_speedup)
        if tier == "device":
            return self.base_infer_ms * self.device_slowdown
        return self.base_infer_ms

    def occupancy_dependent(self, tier: str) -> bool:
        """Whether ``infer_ms`` on ``tier`` varies with occupancy — the
        batched request engine takes its fully vectorized path only
        when it does not."""
        return False

    def flat_service_slots(self, tier: str) -> float:
        """The step boundary of the occupancy-service coupling: while a
        replica on ``tier`` has strictly fewer than this many requests
        in service, ``infer_ms`` returns the flat base — the regime the
        batched engine's closed-form bulk replay
        (``repro.sim.request_plane.occupancy_replay``) exploits.
        The constant model is flat everywhere: ``math.inf``."""
        return math.inf

    def base_service_ms(self, tier: str) -> float:
        """Service time in the flat (occupancy below
        :meth:`flat_service_slots`) regime — bit-identical to
        ``infer_ms(tier, occupancy=o)`` for every such ``o``, which is
        what lets the bulk replay broadcast one scalar."""
        return self.infer_ms(tier)

    def infer_ms_array(self, tier: str, occupancy: np.ndarray,
                       ) -> np.ndarray:
        """Vectorized :meth:`infer_ms` over an occupancy array (the
        constant model broadcasts one scalar)."""
        occupancy = np.asarray(occupancy, dtype=np.float64)
        return np.full(occupancy.shape, self.infer_ms(tier))

    def forward_hop_ms(self, rng: np.random.Generator) -> float:
        """Edge->cloud forwarding hop (R3 overflow): the request pays the
        edge leg plus the cloud leg."""
        return float(self.rtt("cloud", rng))

    @classmethod
    def from_measurements(cls, measurements: Mapping[str, object],
                          decode_tokens: int = 0,
                          **kwargs) -> "CalibratedLatencyModel":
        """Build a calibrated model from per-tier engine measurements
        (``ReplicaPool.measure()`` output, or anything exposing
        ``prefill_ms`` / ``decode_ms_per_token`` / ``batch_size``).

        ``decode_tokens`` is the per-request generation length the
        simulator should assume; 0 means prefill-only service (the
        paper's GRU: one forward per request).  Extra ``kwargs`` override
        the network RTT fields.

        Measurements carrying an ``occupancy_ms`` sweep (``measure(...,
        occupancy_levels=...)``) additionally yield a *measured* service
        curve: per-request service interpolated between the swept
        concurrency levels instead of the closed-form ``(occ+1)/slots``
        stretch — real high-occupancy points from the paged engines
        rather than extrapolation past the dense slot boundary."""
        service, slots, sweep = {}, {}, {}
        for tier, m in measurements.items():
            service[tier] = float(m.prefill_ms
                                  + decode_tokens * m.decode_ms_per_token)
            slots[tier] = int(m.batch_size)
            occ = tuple(getattr(m, "occupancy_ms", ()) or ())
            if occ and decode_tokens > 0:
                pts = sorted(
                    (int(lvl), float(m.prefill_ms + decode_tokens * ms))
                    for lvl, ms in occ)
                sweep[tier] = tuple(pts)
        return CalibratedLatencyModel(tier_service_ms=service,
                                      tier_slots=slots, tier_sweep=sweep,
                                      **kwargs)


@dataclass(frozen=True)
class CalibratedLatencyModel(LatencyModel):
    """Per-tier service times measured from the serving engines.

    ``infer_ms`` becomes occupancy-dependent: a replica's continuous-
    batching slots serve concurrently at the measured rate; once
    ``occupancy`` exceeds the slot count, requests time-share the decode
    program and per-request service stretches proportionally.  Tiers
    without a measurement fall back to the constant closed-form model, so
    a partially calibrated pool still simulates."""
    tier_service_ms: Dict[str, float] = field(default_factory=dict)
    tier_slots: Dict[str, int] = field(default_factory=dict)
    # measured occupancy sweep per tier: ((concurrency, service_ms), ...)
    # ascending in concurrency; empty -> closed-form stretch
    tier_sweep: Dict[str, tuple] = field(default_factory=dict)

    def infer_ms(self, tier: str, occupancy: float = 0.0) -> float:
        if self.tier_sweep.get(tier):
            # route through the array path so scalar and vectorized
            # lookups are bit-identical (occupancy_replay contract)
            return float(self.infer_ms_array(
                tier, np.asarray(occupancy, dtype=np.float64)))
        base = self.tier_service_ms.get(tier)
        if base is None:
            return super().infer_ms(tier, occupancy)
        slots = max(self.tier_slots.get(tier, 1), 1)
        oversubscription = max((occupancy + 1.0) / slots, 1.0)
        return base * oversubscription

    def occupancy_dependent(self, tier: str) -> bool:
        return tier in self.tier_service_ms or tier in self.tier_sweep

    def flat_service_slots(self, tier: str) -> float:
        """Occupancy boundary of the flat service regime.  With a
        measured sweep: the lowest swept concurrency level (occupancies
        below it interpolate to the level's own flat value, so the
        closed-form bulk replay stays exact).  Without: the
        continuous-batching slot count where the ``(occupancy + 1) /
        slots`` stretch kicks in.  Unmeasured tiers inherit the constant
        model's ``inf``."""
        sweep = self.tier_sweep.get(tier)
        if sweep:
            return float(sweep[0][0])
        if tier not in self.tier_service_ms:
            return super().flat_service_slots(tier)
        return float(max(self.tier_slots.get(tier, 1), 1))

    def infer_ms_array(self, tier: str, occupancy: np.ndarray,
                       ) -> np.ndarray:
        occupancy = np.asarray(occupancy, dtype=np.float64)
        sweep = self.tier_sweep.get(tier)
        if sweep:
            levels = np.asarray([s[0] for s in sweep], np.float64)
            svc = np.asarray([s[1] for s in sweep], np.float64)
            c = occupancy + 1.0
            out = np.interp(c, levels, svc)   # clamps flat below levels[0]
            # beyond the highest measured level: time-share the last
            # measured rate (same shape as the closed-form stretch)
            return np.where(c > levels[-1], svc[-1] * c / levels[-1], out)
        base = self.tier_service_ms.get(tier)
        if base is None:
            return super().infer_ms_array(tier, occupancy)
        slots = max(self.tier_slots.get(tier, 1), 1)
        return base * np.maximum((occupancy + 1.0) / slots, 1.0)
