"""Inference workload generation: per-device Poisson streams (rate
lambda_i) aggregated into serving batches — the bridge between the
paper's request model and the TPU decode step."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Tuple, Union

import numpy as np


@dataclass
class RequestEvent:
    t: float
    device: int


def poisson_request_arrays(lam: np.ndarray, duration_s: float,
                           seed: Union[int, np.random.Generator] = 0,
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-device Poisson arrival streams as columnar ``(t, device)``
    arrays sorted by arrival time (ties keep device order, matching the
    historical event-list sort).  This is the request plane's native
    format: exponential gaps are drawn in chunks per device, so 10^7
    arrivals cost milliseconds instead of 10^7 scalar generator calls.

    ``seed`` may be an existing ``np.random.Generator`` so callers that
    draw more randomness after the arrivals (e.g. the event engine's
    RTT draws) share one deterministic stream."""
    rng = (seed if isinstance(seed, np.random.Generator)
           else np.random.default_rng(seed))
    ts: List[np.ndarray] = []
    ds: List[np.ndarray] = []
    for i, rate in enumerate(np.asarray(lam, dtype=np.float64)):
        if rate <= 0:
            continue
        expected = rate * duration_s
        chunk = int(expected + 4.0 * math.sqrt(expected) + 16.0)
        t_end, parts = 0.0, []
        while True:
            gaps = rng.exponential(1.0 / rate, size=chunk)
            cum = t_end + np.cumsum(gaps)
            parts.append(cum)
            t_end = float(cum[-1])
            if t_end > duration_s:
                break
            chunk = max(chunk // 4, 16)
        t_i = np.concatenate(parts) if len(parts) > 1 else parts[0]
        t_i = t_i[t_i <= duration_s]
        ts.append(t_i)
        ds.append(np.full(t_i.size, i, dtype=np.int64))
    if not ts:
        return np.zeros(0, dtype=np.float64), np.zeros(0, dtype=np.int64)
    t = np.concatenate(ts)
    d = np.concatenate(ds)
    order = np.argsort(t, kind="stable")
    return t[order], d[order]


def poisson_requests(lam: np.ndarray, duration_s: float,
                     seed: Union[int, np.random.Generator] = 0,
                     ) -> List[RequestEvent]:
    """Per-device Poisson arrival streams as a time-sorted event list —
    the object view of :func:`poisson_request_arrays` (same draws, same
    order for the same seed)."""
    t, d = poisson_request_arrays(lam, duration_s, seed)
    return [RequestEvent(t=float(tt), device=int(dd))
            for tt, dd in zip(t, d)]


def batched_arrivals(events: List[RequestEvent], batch_size: int,
                     max_wait_s: float = 0.05
                     ) -> Iterator[Tuple[float, np.ndarray]]:
    """Continuous batching: emit a batch when it is full or the oldest
    request has waited ``max_wait_s``.

    A batch whose deadline (oldest arrival + ``max_wait_s``) passes is
    flushed *at that deadline*, before the next event joins — a late
    arrival must open a fresh batch, not ride along with (and further
    delay) one that should already have left."""
    cur: List[RequestEvent] = []
    for ev in events:
        if cur and ev.t - cur[0].t >= max_wait_s:
            yield cur[0].t + max_wait_s, np.asarray([e.device for e in cur])
            cur = []
        cur.append(ev)
        if len(cur) >= batch_size:
            yield ev.t, np.asarray([e.device for e in cur])
            cur = []
    if cur:
        yield cur[0].t + max_wait_s, np.asarray([e.device for e in cur])
