"""The profiler's view of a stretch of the window: which device
operations ran, for how long, and what the host did while the device
sat idle.

A stretch is traced by ``torch.profiler`` (CPU and CUDA activities), its
Chrome trace written to ``TMPDIR``, read back and deleted.  The busy
time is the union of the device operations' intervals (kernels, copies,
sets), never their sum, so overlapping work is counted once.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 160
TOP = 10


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class TraceSummary:
    window_s: float                       # the stretch, host clock
    busy_s: float                         # union of device operations
    kernels: List[Tuple[str, float, float]]   # (name, start us, dur us)
    idle_by_host_op: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose names hold
        any of ``patterns``."""
        hits = [d for n, _, d in self.kernels
                if any(p in n for p in patterns)]
        return sum(hits) * 1e-6, len(hits)

    def idle_percent(self):
        """The share of the stretch in which no device operation ran: 1 -
        (union of kernel, copy and set intervals) / (the stretch's wall
        time), in percent; None where nothing ran on the device."""
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> Dict[str, List[List]]:
        by_name: Dict[str, float] = defaultdict(float)
        for n, _, d in self.kernels:
            by_name[n[:NAME_CHARS]] += d * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host_op.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:TOP]]}


def summarize(events: List[dict], window_s: float) -> TraceSummary:
    """A Chrome trace's events -> :class:`TraceSummary`."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    busy = union((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in dev)
    kernels = [(e.get("name", "?"), float(e["ts"]), float(e.get("dur", 0)))
               for e in dev if e.get("cat") == "kernel"]
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e.get("name", "?")) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS))
    starts = [h[0] for h in host]
    idle: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        idle[_host_op_at(host, starts, (a + b) / 2)] += (b - a) * 1e-6
    return TraceSummary(window_s=window_s,
                        busy_s=sum(b - a for a, b in busy) * 1e-6,
                        kernels=kernels, idle_by_host_op=dict(idle))


def _host_op_at(host, starts, t: float, scan: int = 5000) -> str:
    """The innermost host operation running at ``t`` (the latest-started
    one that contains it), or ``python`` where none does."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - scan), -1):
        a, b, name = host[j]
        if a <= t <= b:
            return name
    return "python"


class DeviceTrace:
    """Profiles from :meth:`start` to :meth:`stop`."""

    def __init__(self):
        self._prof = None
        self._t0 = 0.0
        self._window_s = None

    def start(self) -> None:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self._prof is not None and self._window_s is None

    def stop(self) -> None:
        """Ends the collection (the trace is read by :meth:`summary`,
        after the window)."""
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window_s = time.perf_counter() - self._t0
        self._prof.stop()

    def summary(self) -> TraceSummary:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self._prof = None
        return summarize(events, self._window_s)
