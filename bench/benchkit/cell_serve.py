"""A serving cell's run: set-up, the window, the check.

Set-up loads the kernel library, draws the weights, builds the engine
(its page pool allocated), warms the prefill buckets the traffic can
reach and one decode step, and admits every client's first request of
the closed loop (``serve-closed``), so the window opens on full rows.
The window drives the scheduler in that loop.  A traced run
profiles at least ``TRACE_STEPS`` decode steps and ``TRACE_SECONDS``
from ``TRACE_AT`` of the window on.  The check runs once the
window has closed, the memory peak has been read and the engine's cache
is freed.
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from benchkit import check, program, serve, weights
from benchkit.devtrace import DeviceTrace, TraceSummary
from benchkit.spec import Cell

TRACE_AT = 0.4          # share of the window before the profiled stretch
TRACE_STEPS = 12        # decode steps profiled, at the least
TRACE_SECONDS = 2.0     # seconds profiled, at the least


@dataclass
class ServeRun:
    """What the metric readers read."""
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    seconds: float
    setup_s: float
    page_size: int
    max_len: int
    log: serve.ServeLog
    summary: Optional[TraceSummary]


def _trace_hook(tracer: DeviceTrace, seconds: float):
    state = {"from": None}

    def hook(log: serve.ServeLog, k: int) -> None:
        now = time.perf_counter()
        if state["from"] is None and now - log.t_start >= TRACE_AT * seconds:
            state["from"] = k
            tracer.start()
            log.traced = (now, float("inf"))
        elif state["from"] is not None and tracer.running \
                and k - state["from"] >= TRACE_STEPS \
                and now - log.traced[0] >= TRACE_SECONDS:
            tracer.stop()
            log.traced = (log.traced[0], time.perf_counter())
    return hook


def _diagnose(log: serve.ServeLog) -> None:
    """The window's calls, on standard error: how many, and their walls."""
    import numpy as np
    for kind in ("decode", "admit"):
        w = np.array([c.t1 - c.t0 for c in log.calls
                      if c.kind == kind and log.in_window(c)]) * 1e3
        if w.size:
            print(f"window {kind}: {w.size} calls, ms mean {w.mean():.2f} "
                  f"p50 {np.median(w):.2f} p90 {np.percentile(w, 90):.2f} "
                  f"sum {w.sum():.0f}", file=sys.stderr)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_process: float, control: str = "") -> Dict[str, Any]:
    """One run of a serving cell.  With ``control`` a precision of the
    reference (``fp8``), the check also reads the control's widest gap
    on the same requests (``control_widest_gap``): ``bench/control.py``
    does, the benchmark's own runs do not."""
    cfg, traffic = cell.config, cell.traffic
    on_card = torch.device(device).type == "cuda"
    rows = int(cfg["serve"]["rows"])
    vocab = int(cfg["vocab_size"])
    stamps = [("process", t_process), ("imports", time.perf_counter())]
    if on_card:
        program.load_kernels()
    stamps.append(("kernels", time.perf_counter()))
    params = weights.make_params(cfg, seed, device)
    stamps.append(("weights", time.perf_counter()))
    engine = program.serve_engine(cfg, params, rows, device)
    stamps.append(("engine", time.perf_counter()))
    serve.warm_up(engine, int(traffic["prompt_len"]["lo"]),
                  int(traffic["prompt_len"]["hi"]), vocab)
    stamps.append(("warm-up", time.perf_counter()))
    setup = {}

    def primed():
        if on_card:
            torch.cuda.synchronize()
        stamps.append(("window ready", time.perf_counter()))
        setup["s"] = stamps[-1][1] - t_process
        print("set-up s: " + ", ".join(
            f"{name} {b - a:.3f}" for (_, a), (name, b)
            in zip(stamps, stamps[1:])), file=sys.stderr)

    tracer = DeviceTrace() if trace else None
    hook = _trace_hook(tracer, seconds) if trace else None
    log, completed = serve.run_closed(engine, traffic, vocab, seed, seconds,
                                      hook, primed)
    setup_s = setup["s"]
    if tracer is not None and tracer.running:
        tracer.stop()
        log.traced = (log.traced[0], time.perf_counter())
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        print(f"memory bytes: peak {peak}, in use at the close "
              f"{torch.cuda.memory_allocated()}", file=sys.stderr)
    _diagnose(log)
    page_size, max_len = engine.page_size, engine.max_len
    del engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    summary = tracer.summary() if tracer is not None and log.traced else None

    t_check = time.perf_counter()
    picked = check.sample(completed, int(traffic["check_requests"]), seed)
    numbers = check.gaps(params, cfg, picked, device, control=control)
    print(f"check s: {time.perf_counter() - t_check:.1f}", file=sys.stderr)
    limit = float(cell.limits["mean_gap"])
    enough = len(picked) == int(traffic["check_requests"])
    whole = check.complete(picked)
    correct = bool(enough and whole and numbers["mean_gap"] <= limit)
    attempted = sum(1 for c in log.calls if c.kind == "admit"
                    and log.in_window(c))
    return {
        "run": ServeRun(cfg=cfg, traffic=traffic, seconds=seconds,
                        setup_s=setup_s, page_size=page_size,
                        max_len=max_len, log=log, summary=summary),
        "correct": correct, "attempted": attempted, "failed": 0,
        "memory_peak_bytes": int(peak),
        "checks": {
            "mean_gap": {"value": numbers["mean_gap"], "limit": limit},
            "requests_checked": {"value": len(picked),
                                 "limit": int(traffic["check_requests"])},
            "requests_complete": {"value": int(whole), "limit": 1},
        },
        "tokens_checked": numbers["tokens_checked"],
        "widest_gap": numbers["widest_gap"],
        "control": {k: v for k, v in numbers.items()
                    if k.startswith("control_")},
    }
