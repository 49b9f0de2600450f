"""Drives the port's ``ContinuousBatchingScheduler`` over a paged engine
on the wall clock.

The scheduler gets a thin proxy of the engine's public methods.  The
proxy stamps every call on the host clock, ends the window by raising
:class:`WindowClosed` at the first call after the deadline, and keeps
each row's length, so the harness knows every kernel call's shapes
without reading the program's state.  The scheduler's own clock (a
virtual one that skips idle time) is not used.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from benchkit import program
from benchkit.traffic import Ask, closed_loop


class WindowClosed(Exception):
    """The measured window is over."""


class Primed(Exception):
    """Every client's first request is admitted (set-up is over)."""


@dataclass
class Call:
    kind: str                     # "admit" or "decode"
    t0: float
    t1: float
    rows: int                     # live rows after the call (decode: that
    #                               stepped); admit: 1
    tokens: int                   # tokens the call returned to clients
    lengths: Optional[np.ndarray] = None   # decode: every row's keys
    live: Optional[np.ndarray] = None      # decode: the rows that stepped
    prompt_len: int = 0           # admit: the prompt's tokens


@dataclass
class ServeLog:
    t_start: float
    deadline: float
    calls: List[Call] = field(default_factory=list)
    traced: Optional[Tuple[float, float]] = None   # host interval profiled

    def in_window(self, c: Call) -> bool:
        return self.t_start <= c.t0 and c.t1 <= self.deadline

    def untraced(self, c: Call) -> bool:
        if self.traced is None:
            return True
        a, b = self.traced
        return c.t1 <= a or c.t0 >= b

    def traced_call(self, c: Call) -> bool:
        return self.traced is not None and \
            self.traced[0] <= c.t0 and c.t1 <= self.traced[1]

    def untraced_seconds(self) -> float:
        """The window's length less the profiled stretch."""
        total = self.deadline - self.t_start
        if self.traced is None:
            return total
        return total - (min(self.traced[1], self.deadline) - self.traced[0])


class EngineProxy:
    """The engine as the scheduler sees it, stamped and bounded."""

    def __init__(self, engine, log: ServeLog,
                 on_evict: Callable[[int], None],
                 on_decode: Callable[[int], None] = lambda n: None):
        self.engine = engine
        self.log = log
        self.batch_size = engine.batch_size
        self._on_evict = on_evict
        self._on_decode = on_decode
        self.pos = np.zeros(engine.batch_size, np.int64)
        self.live = np.zeros(engine.batch_size, bool)
        self.decodes = 0
        self.priming = False

    def _open(self) -> None:
        if time.perf_counter() >= self.log.deadline:
            raise WindowClosed()

    def can_admit(self, prompt_len: int, max_new_tokens: int = 0) -> bool:
        return self.engine.can_admit(prompt_len, max_new_tokens)

    def acquire_slot(self):
        # the window closes here and not in admit: a slot acquired is
        # out of the engine's free list until its admission completes
        self._open()
        return self.engine.acquire_slot()

    def admit(self, prompt, slot: int, reserve_tokens=None) -> int:
        t0 = time.perf_counter()
        first = self.engine.admit(prompt, slot=slot,
                                  reserve_tokens=reserve_tokens)
        t1 = time.perf_counter()
        self.pos[slot], self.live[slot] = len(prompt), True
        self.log.calls.append(Call("admit", t0, t1, 1, 1,
                                   prompt_len=len(prompt)))
        return first

    def decode(self) -> np.ndarray:
        if self.priming:
            raise Primed()
        self._open()
        self._on_decode(self.decodes)
        lengths = np.where(self.live, self.pos + 1, 1)
        live = self.live.copy()
        n = int(live.sum())
        t0 = time.perf_counter()
        toks = self.engine.decode()
        t1 = time.perf_counter()
        self.pos[self.live] += 1
        self.decodes += 1
        self.log.calls.append(Call("decode", t0, t1, n, n, lengths=lengths,
                                   live=live))
        return toks

    def evict(self, slot: int) -> None:
        self.engine.evict(slot)
        self.live[slot], self.pos[slot] = False, 0
        self._on_evict(slot)

    def drain(self):
        return self.engine.drain()


def warm_up(engine, lo: int, hi: int, vocab: int) -> None:
    """One admission at each prefill bucket that prompts of lo..hi tokens
    reach (a prompt of the bucket's size, or of ``hi`` in the last), one
    decode step over every row, then every row evicted."""
    rng = np.random.default_rng(0)
    slots = []
    for b in reachable_buckets(lo, hi):
        slot = engine.acquire_slot()
        engine.admit(rng.integers(1, vocab, min(b, hi)), slot=slot,
                     reserve_tokens=1)
        slots.append(slot)
    engine.decode()
    for s in slots:
        engine.evict(s)


def reachable_buckets(lo: int, hi: int) -> List[int]:
    """The engine's prefill buckets (powers of two, at least 8) that
    prompts of lo..hi tokens land in."""
    out, b = [], 8
    while b < lo:
        b *= 2
    out.append(b)
    while b < hi:
        b *= 2
        out.append(b)
    return out


def run_closed(engine, traffic: Dict, vocab: int, seed: int,
               seconds: float, trace_hook=None,
               on_primed: Callable[[], None] = lambda: None
               ) -> Tuple[ServeLog, list]:
    """A closed loop: every row is a client whose next request goes in
    as its last completes.  Set-up admits every client's first request
    (the scheduler runs until its first decode step) and calls
    ``on_primed``; then the window runs.  Returns the log and the
    requests completed (the scheduler's ``Request`` objects, tokens
    filled)."""
    asks = closed_loop(traffic, engine.batch_size, vocab, seed)
    log = ServeLog(t_start=0.0, deadline=float("inf"))
    sched = None
    by_prompt: Dict[int, Ask] = {}
    in_slot: Dict[int, Ask] = {}
    next_id = [0]

    def submit(ask: Ask):
        req = program.request(next_id[0], ask.prompt, ask.max_new_tokens)
        next_id[0] += 1
        by_prompt[id(req.prompt)] = ask
        return req

    class Proxy(EngineProxy):
        def admit(self, prompt, slot, reserve_tokens=None):
            first = super().admit(prompt, slot, reserve_tokens)
            in_slot[slot] = by_prompt[id(prompt)]
            return first

    def on_evict(slot: int) -> None:
        ask = in_slot.pop(slot)
        nxt = ask.index + 1
        if nxt < len(asks[ask.client]):
            sched.submit(submit(asks[ask.client][nxt]))

    proxy = Proxy(engine, log, on_evict,
                  (lambda k: trace_hook(log, k)) if trace_hook else
                  (lambda k: None))
    sched = program.scheduler(proxy)
    first = [submit(a[0]) for a in asks]
    proxy.priming = True
    try:
        sched.run(first)
    except Primed:
        proxy.priming = False
    else:
        raise RuntimeError("set-up ended without a decode step")
    on_primed()
    log.t_start = time.perf_counter()
    log.deadline = log.t_start + seconds
    try:
        sched.run([])
    except WindowClosed:
        pass
    else:
        raise RuntimeError("the clients ran out of requests before the "
                           "window closed: raise requests_per_client")
    return log, list(sched.completed)
