"""Continuous-batching scheduler: admission queue, slot allocation and
per-request TTFT/TPOT accounting on top of :class:`ServeEngine`.  A copy
of ``repro/serving/scheduler.py`` (numpy/stdlib only), kept in step with
it by ``tests/test_torch_copies.py``.  On the port's engines the clock
reads the card's time: ``admit`` returns a host ``int`` and ``decode`` a
numpy array, so each call has waited for its kernels before the clock
stops.

The scheduler drives real engine compute under a hybrid clock: request
*arrivals* follow the workload's virtual timeline (Poisson offsets in
seconds), while *service* advances the clock by the measured wall time of
each prefill / decode step.  That keeps runs deterministic in structure
(admission order, slot reuse) while reporting honest latencies for the
calibration bridge.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class Request:
    id: int
    arrival_s: float
    prompt: np.ndarray               # (S,) token ids
    max_new_tokens: int = 16
    # filled by the scheduler
    tokens: List[int] = field(default_factory=list)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    slot: Optional[int] = None

    @property
    def ttft_ms(self) -> float:
        """Arrival -> first generated token (queueing + prefill)."""
        return (self.t_first_token - self.arrival_s) * 1e3

    @property
    def tpot_ms(self) -> float:
        """Mean time per output token after the first."""
        extra = len(self.tokens) - 1
        if extra <= 0:
            return 0.0
        return (self.t_done - self.t_first_token) * 1e3 / extra


@dataclass
class ScheduleStats:
    ttft_ms: np.ndarray
    tpot_ms: np.ndarray
    latency_ms: np.ndarray           # arrival -> completion
    tokens_generated: int
    duration_s: float
    slot_reuses: int                 # admissions into a previously used slot
    peak_occupancy: int

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / max(self.duration_s, 1e-9)

    def summary(self) -> str:
        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else float("nan")
        return (f"ttft p50={pct(self.ttft_ms, 50):.1f}ms "
                f"p95={pct(self.ttft_ms, 95):.1f}ms | "
                f"tpot mean={float(self.tpot_ms.mean()) if self.tpot_ms.size else float('nan'):.2f}ms | "
                f"throughput={self.tokens_per_s:.1f} tok/s | "
                f"slot reuses={self.slot_reuses} "
                f"peak occupancy={self.peak_occupancy}")


class ContinuousBatchingScheduler:
    """FIFO admission onto engine slots; decode advances all active slots
    together (the engine's single shared decode program)."""

    def __init__(self, engine):
        # engine: ServeEngine or PagedServeEngine (duck-typed: acquire_slot
        # / can_admit / admit / decode / evict)
        self.engine = engine
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}      # slot -> request
        self.completed: List[Request] = []
        self._slots_ever_used: set = set()
        self.slot_reuses = 0
        self.peak_occupancy = 0
        self.requeues = 0                # requests re-admitted after a crash

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def requeue_active(self, now: float) -> int:
        """Crash recovery: the engine's cache is gone, so every in-flight
        request restarts from its prompt.  Drains the engine (releasing
        slots and, for the paged engine, verifying the page pool comes
        back whole), resets per-request progress and puts the requests
        back on the queue in arrival order.  Returns how many were
        requeued."""
        drained = self.engine.drain()
        n = 0
        for slot in drained:
            req = self.active.pop(slot, None)
            if req is None:
                continue
            req.tokens.clear()
            req.slot = None
            req.t_admitted = None
            req.t_first_token = None
            self.queue.append(req)
            n += 1
        self.queue.sort(key=lambda r: r.arrival_s)    # stable: FIFO again
        self.requeues += n
        return n

    # -- one scheduling iteration ------------------------------------------

    def _admit_ready(self, now: float) -> float:
        """Admit queued requests that have arrived, while capacity lasts
        (free slots for the dense engine; free slots AND pages for the
        paged engine — ``can_admit`` reserves the request's full
        ``max_new_tokens`` so an admitted sequence always completes).
        Returns the clock after the prefill wall time of each admission."""
        while self.queue and self.queue[0].arrival_s <= now:
            head = self.queue[0]
            if not self.engine.can_admit(len(head.prompt),
                                         head.max_new_tokens):
                break
            slot = self.engine.acquire_slot()
            if slot is None:
                break
            req = self.queue.pop(0)
            t0 = time.perf_counter()
            first = self.engine.admit(req.prompt, slot=slot,
                                      reserve_tokens=req.max_new_tokens)
            now += time.perf_counter() - t0
            req.slot = slot
            req.t_admitted = now
            req.t_first_token = now
            req.tokens.append(first)
            self.active[slot] = req
            if slot in self._slots_ever_used:
                self.slot_reuses += 1
            self._slots_ever_used.add(slot)
            self.peak_occupancy = max(self.peak_occupancy, len(self.active))
            if len(req.tokens) >= req.max_new_tokens:    # prompt-only ask
                self._complete(slot, now)
        return now

    def _complete(self, slot: int, now: float) -> None:
        req = self.active.pop(slot)
        req.t_done = now
        self.engine.evict(slot)
        self.completed.append(req)

    def _decode_once(self, now: float) -> float:
        t0 = time.perf_counter()
        toks = self.engine.decode()
        now += time.perf_counter() - t0
        for slot in list(self.active):
            req = self.active[slot]
            req.tokens.append(int(toks[slot]))
            if len(req.tokens) >= req.max_new_tokens:
                self._complete(slot, now)
        return now

    # -- batch run over a workload -----------------------------------------

    def run(self, requests: Sequence[Request]) -> ScheduleStats:
        for r in sorted(requests, key=lambda r: r.arrival_s):
            self.submit(r)
        now = 0.0
        while self.queue or self.active:
            if not self.active and self.queue \
                    and self.queue[0].arrival_s > now:
                now = self.queue[0].arrival_s        # idle: jump to arrival
            now = self._admit_ready(now)
            if not self.active and self.queue \
                    and self.queue[0].arrival_s <= now:
                head = self.queue[0]
                raise ValueError(
                    f"request {head.id} (prompt {len(head.prompt)} + "
                    f"{head.max_new_tokens} new) can never be admitted on "
                    "an idle engine — it exceeds the engine's capacity")
            if self.active:
                now = self._decode_once(now)
        return self.stats(duration_s=now)

    def stats(self, duration_s: float) -> ScheduleStats:
        done = self.completed
        return ScheduleStats(
            ttft_ms=np.asarray([r.ttft_ms for r in done]),
            tpot_ms=np.asarray([r.tpot_ms for r in done
                                if len(r.tokens) > 1]),
            latency_ms=np.asarray([(r.t_done - r.arrival_s) * 1e3
                                   for r in done]),
            tokens_generated=sum(len(r.tokens) for r in done),
            duration_s=duration_s,
            slot_reuses=self.slot_reuses,
            peak_occupancy=self.peak_occupancy,
        )


def requests_from_events(events, prompts: np.ndarray,
                         max_new_tokens: int = 16) -> List[Request]:
    """Adapt ``serving.workload.poisson_requests`` events into scheduler
    requests; ``prompts`` (N, S) are cycled over events."""
    out = []
    for k, ev in enumerate(events):
        out.append(Request(id=k, arrival_s=ev.t,
                           prompt=np.asarray(prompts[k % len(prompts)]),
                           max_new_tokens=max_new_tokens))
    return out
