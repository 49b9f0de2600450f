"""Training–inference interference: per-node compute shared between
training FLOPs and in-flight requests.

Every continuum node (device i, edge j, the cloud) has one normalized
unit of compute.  Training phases claim a share of it — a device
mid-epoch spends ``device_train_share`` on gradient steps, an edge
mid-aggregation spends ``edge_agg_share`` averaging models, the cloud
spends ``cloud_agg_share`` during global rounds — and whatever serving
the node still does time-shares the remainder, so service times stretch
by ``1 / (1 - demand)``.

The base per-tier service time comes from any ``LatencyModel``,
including a :class:`~repro_torch.routing.latency.CalibratedLatencyModel`
built from real engine timings (``ReplicaPool.measure()``), whose
occupancy-dependent slowdown composes multiplicatively with the
training stretch: an edge that is both oversubscribed *and* aggregating
is slow for both reasons.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.routing.latency import LatencyModel
from repro_torch.routing.rules import RouteDecision

NodeKey = Tuple[str, int]            # ("device", i) | ("edge", j) | ("cloud", 0)


@dataclass(frozen=True)
class InterferenceConfig:
    device_train_share: float = 0.85   # compute share of a local epoch
    device_residual_share: float = 0.35  # post-epoch round work (ckpt/prep)
    edge_agg_share: float = 0.6        # share while aggregating uploads
    cloud_agg_share: float = 0.3       # share during a global aggregation
    migration_share: float = 0.5       # share while replicas migrate
    handover_share: float = 0.25       # share on the receiving edge while a
    #                                    moving device hands over
    floor: float = 0.05                # serving never starves below this


class InterferenceModel:
    """Tracks per-node training demand as named components (so an edge
    can simultaneously aggregate *and* host a replica migration) and
    stretches the latency model's service times accordingly."""

    def __init__(self, latency: Optional[LatencyModel] = None,
                 cfg: InterferenceConfig = InterferenceConfig()):
        self.lat = latency if latency is not None else LatencyModel()
        self.cfg = cfg
        self._demand: Dict[NodeKey, Dict[str, float]] = {}

    # -- demand bookkeeping -------------------------------------------------

    def set_demand(self, node: NodeKey, source: str, share: float) -> None:
        comp = self._demand.setdefault(node, {})
        if share <= 0.0:
            comp.pop(source, None)
        else:
            comp[source] = float(share)

    def clear_tier(self, tier: str, source: Optional[str] = None,
                   keep_prefixes: Tuple[str, ...] = ()) -> None:
        """Drop a tier's demand: one named ``source`` everywhere, or all
        sources — except those whose name starts with a ``keep_prefixes``
        entry (external demand like tenant jobs survives a re-deploy
        that rebuilds the training-side components)."""
        for node, comp in self._demand.items():
            if node[0] != tier:
                continue
            if source is not None:
                comp.pop(source, None)
            elif keep_prefixes:
                for k in [k for k in comp if not k.startswith(keep_prefixes)]:
                    comp.pop(k)
            else:
                comp.clear()

    def remap_tier(self, tier: str,
                   remap: Callable[[int], Optional[int]]) -> None:
        """Re-key one tier's demand through ``remap`` (old node id ->
        new id; None drops the node) — used when a re-clustered
        deployment renumbers edges, so demand keeps following its
        physical host."""
        moved: Dict[NodeKey, Dict[str, float]] = {}
        for node in [n for n in self._demand if n[0] == tier]:
            comp = self._demand.pop(node)
            new = remap(node[1])
            if new is None or not comp:
                continue
            moved.setdefault((tier, int(new)), {}).update(comp)
        for node, comp in moved.items():
            self._demand.setdefault(node, {}).update(comp)

    def demand(self, node: NodeKey) -> float:
        total = sum(self._demand.get(node, {}).values())
        return min(total, 1.0 - self.cfg.floor)

    # -- service times ------------------------------------------------------

    def stretch(self, node: NodeKey) -> float:
        """Service-time multiplier from compute time-sharing."""
        return 1.0 / max(1.0 - self.demand(node), self.cfg.floor)

    def stretch_array(self, tier: str, ids: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`stretch` over node ids of one tier — the
        batched request plane's per-window lookup.  Demand components
        live in per-node dicts, so the per-*unique*-node stretch is
        gathered once and broadcast over the (typically much larger)
        request batch."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0:
            return np.ones(0)
        u, inv = np.unique(ids, return_inverse=True)
        vals = np.array([self.stretch((tier, int(k))) for k in u])
        return vals[inv]

    def service_ms_array(self, tier: str, ids: np.ndarray,
                         occupancy=0.0) -> np.ndarray:
        """Vectorized :meth:`service_ms` for one tier: the latency
        model's (possibly occupancy-dependent) base service stretched
        by each serving node's current training demand."""
        ids = np.asarray(ids, dtype=np.int64)
        occupancy = np.broadcast_to(
            np.asarray(occupancy, dtype=np.float64), ids.shape)
        base = self.lat.infer_ms_array(tier, occupancy)
        return base * self.stretch_array(tier, ids)

    def service_ms(self, device: int, dec: RouteDecision,
                   occupancy: int = 0) -> float:
        """Drop-in ``service_fn`` for the request processor: base
        per-tier service (occupancy-aware when calibrated) stretched by
        the serving node's current training demand."""
        base = self.lat.infer_ms(dec.tier, occupancy=occupancy)
        if dec.tier == "edge":
            node: NodeKey = ("edge", int(dec.edge))
        elif dec.tier == "cloud":
            node = ("cloud", 0)
        else:
            node = ("device", int(device))
        return base * self.stretch(node)

    # -- construction from real engine timings ------------------------------

    @classmethod
    def from_measurements(cls, measurements: Mapping[str, object],
                          cfg: InterferenceConfig = InterferenceConfig(),
                          decode_tokens: int = 0,
                          **kwargs) -> "InterferenceModel":
        """Calibrate from ``ReplicaPool.measure()`` output via the
        existing ``LatencyModel.from_measurements`` bridge."""
        lat = LatencyModel.from_measurements(
            measurements, decode_tokens=decode_tokens, **kwargs)
        return cls(latency=lat, cfg=cfg)
