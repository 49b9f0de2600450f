"""Synthetic METR-LA-like traffic dataset (offline container: the real
loop-detector data cannot be downloaded, so we generate a statistically
faithful stand-in and note the substitution in DESIGN.md/EXPERIMENTS.md).

Mimics the paper's §V-A setup: 207 sensors on LA highways, 5-minute
readings, 4 months (34,272 timestamps), strong daily periodicity with
rush-hour congestion, weekend effects, sensor-specific base speeds,
4 geographic clusters with correlated congestion, and occasional
incident-like drops.  Values are speeds in mph, normalized per sensor
for training exactly like standard METR-LA pipelines."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

STEPS_PER_DAY = 288                  # 5-minute readings
N_SENSORS = 207
N_CLUSTERS = 4


@dataclass
class TrafficDataset:
    speeds: np.ndarray               # (T, n_sensors) mph
    cluster_of: np.ndarray           # (n_sensors,) geographic cluster id
    positions: np.ndarray            # (n_sensors, 2) synthetic coordinates
    mean: np.ndarray                 # per-sensor normalization
    std: np.ndarray

    @property
    def num_steps(self) -> int:
        return self.speeds.shape[0]

    def normalized(self) -> np.ndarray:
        return (self.speeds - self.mean) / self.std


def generate(num_days: int = 119, n_sensors: int = N_SENSORS,
             seed: int = 0) -> TrafficDataset:
    """~4 months of 5-min data (119 days ~= 34,272 stamps for 288/day)."""
    rng = np.random.default_rng(seed)
    T = num_days * STEPS_PER_DAY
    t = np.arange(T)
    tod = (t % STEPS_PER_DAY) / STEPS_PER_DAY          # time of day [0,1)
    dow = (t // STEPS_PER_DAY) % 7
    weekend = (dow >= 5).astype(float)

    # geographic clusters on a synthetic map
    centers = rng.uniform(0, 10, (N_CLUSTERS, 2))
    cluster_of = rng.integers(0, N_CLUSTERS, n_sensors)
    positions = centers[cluster_of] + rng.normal(0, 0.8, (n_sensors, 2))

    # base free-flow speed per sensor
    base = rng.uniform(55, 68, n_sensors)

    # rush-hour congestion: morning (7:30~=0.3) and evening (17:30~=0.73)
    def bump(center, width, depth):
        return depth * np.exp(-0.5 * ((tod - center) / width) ** 2)

    am = bump(0.31, 0.045, 1.0)
    pm = bump(0.73, 0.055, 1.0)
    # per-cluster congestion severity + per-sensor jitter
    sev_am = rng.uniform(8, 22, N_CLUSTERS)[cluster_of] \
        * rng.uniform(0.8, 1.2, n_sensors)
    sev_pm = rng.uniform(10, 26, N_CLUSTERS)[cluster_of] \
        * rng.uniform(0.8, 1.2, n_sensors)
    cong = (am[:, None] * sev_am[None, :] + pm[:, None] * sev_pm[None, :])
    cong *= (1.0 - 0.65 * weekend)[:, None]           # light weekends

    # slow seasonal drift + cluster-correlated daily noise (AR(1))
    drift = 2.0 * np.sin(2 * np.pi * t / (STEPS_PER_DAY * 30))[:, None]
    ar = np.zeros((T, N_CLUSTERS))
    eps = rng.normal(0, 1.0, (T, N_CLUSTERS))
    for k in range(1, T):
        ar[k] = 0.97 * ar[k - 1] + eps[k]
    ar = ar / ar.std(axis=0, keepdims=True) * 2.2

    speeds = (base[None, :] - cong + drift + ar[:, cluster_of]
              + rng.normal(0, 1.6, (T, n_sensors)))

    # incident-like drops: random sensor, 30-120 min, 40-70% speed loss
    n_incidents = num_days * 3
    for _ in range(n_incidents):
        s = rng.integers(0, n_sensors)
        start = rng.integers(0, T - 24)
        dur = rng.integers(6, 24)
        speeds[start:start + dur, s] *= rng.uniform(0.3, 0.6)

    speeds = np.clip(speeds, 3.0, 75.0).astype(np.float32)
    mean = speeds.mean(axis=0)
    std = speeds.std(axis=0) + 1e-6
    return TrafficDataset(speeds=speeds, cluster_of=cluster_of,
                          positions=positions, mean=mean, std=std)


def inject_drift(ds: TrafficDataset, start_step: int,
                 severity: float = 0.35, ramp_steps: int = STEPS_PER_DAY,
                 sensors: Optional[np.ndarray] = None) -> TrafficDataset:
    """Concept drift for the reactive-orchestration loop: from
    ``start_step`` on, a regime change (lane closures / rerouted demand)
    depresses speeds by up to ``severity`` with a linear onset ramp.

    The returned dataset keeps the ORIGINAL per-sensor normalization —
    a model trained pre-drift sees genuinely shifted inputs, so its
    validation MSE rises (the accuracy-alarm trigger), instead of the
    drift being silently absorbed into re-standardization."""
    speeds = ds.speeds.copy()
    T = speeds.shape[0]
    if not 0 <= start_step < T:
        raise ValueError(f"start_step {start_step} outside [0, {T})")
    idx = (np.asarray(sensors, int) if sensors is not None
           else np.arange(speeds.shape[1]))
    ramp = np.clip((np.arange(T - start_step) + 1) / max(ramp_steps, 1),
                   0.0, 1.0)
    factor = 1.0 - severity * ramp
    speeds[start_step:, idx] = np.clip(
        speeds[start_step:, idx] * factor[:, None], 3.0, 75.0)
    return TrafficDataset(speeds=speeds, cluster_of=ds.cluster_of,
                          positions=ds.positions, mean=ds.mean, std=ds.std)


# ---------------------------------------------------------------------------
# windowing (per-sensor supervised samples)
# ---------------------------------------------------------------------------

def windows_for_sensor(ds: TrafficDataset, sensor: int, start: int,
                       end: int, history: int = 12
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding windows over normalized speeds in [start, end):
    X (N, history, 1), y (N, 1) — predict the next 5-min value."""
    z = ds.normalized()[start:end, sensor]
    N = len(z) - history
    if N <= 0:
        raise ValueError("window range too short")
    idx = np.arange(N)[:, None] + np.arange(history)[None, :]
    X = z[idx][..., None].astype(np.float32)
    y = z[idx[:, -1] + 1][:, None].astype(np.float32)
    return X, y


def continual_split(ds: TrafficDataset, round_idx: int,
                    train_days: int = 21, val_days: int = 7,
                    shift_steps: int = 36) -> Tuple[slice, slice]:
    """Paper §V-B2: 3 weeks train + 1 week validation; after each
    aggregation round the window shifts by ``shift_steps`` timestamps to
    simulate time passing."""
    start = round_idx * shift_steps
    train_end = start + train_days * STEPS_PER_DAY
    val_end = train_end + val_days * STEPS_PER_DAY
    if val_end > ds.num_steps:
        raise ValueError(f"round {round_idx} exceeds dataset length")
    return slice(start, train_end), slice(train_end, val_end)


def select_fl_sensors(ds: TrafficDataset, per_cluster: int = 5,
                      seed: int = 0) -> np.ndarray:
    """Paper §V-B2: 5 random sensors from each of the 4 clusters -> 20 FL
    clients."""
    rng = np.random.default_rng(seed)
    chosen: List[int] = []
    for k in range(N_CLUSTERS):
        members = np.nonzero(ds.cluster_of == k)[0]
        take = min(per_cluster, len(members))
        chosen.extend(rng.choice(members, take, replace=False))
    return np.asarray(chosen)
