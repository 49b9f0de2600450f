"""A training cell's run (``hfl-train``): the port's hierarchical-FL
rounds on the wall clock, and their check against the reference.

Set-up builds one trainer (the port's stacked replicas, AdamW state and
step) and drives it from the seed through its first ``check_rounds``
rounds, with the global sync after every ``global_every``-th: those
rounds warm every shape the window uses and are the ones the check
compares.  The same trainer then runs the window.  A traced run
profiles ``global_every`` rounds and the sync after them, from
``TRACE_AT`` of the window on.  Once the window has closed and the
trainer is freed, the reference runs the same check rounds from the same
weights and batches, and three numbers are compared, each the worst
over the clusters:

- ``loss_gap``: the largest relative gap of a round's loss;
- ``grad_norm_gap``: the first gradient as AdamW got it (its first
  moment after one step over 1 - b1), by the worst leaf: the gap of the
  two norms over the larger of the reference's norm of that leaf and of
  the median leaf;
- ``change_gap``: the parameters' change over the check rounds, by the
  worst leaf, the same way.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both leaf numbers (a rule on the reference, by
value, never by name).
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchkit import program, weights
from benchkit.devtrace import DeviceTrace, TraceSummary
from benchkit.spec import Cell
from reference import train as ref_train

TRACE_AT = 0.4


@dataclass
class Step:
    kind: str                     # "round" or "sync"
    t0: float
    t1: float
    tokens: int = 0


@dataclass
class TrainLog:
    t_start: float = 0.0
    deadline: float = 0.0
    steps: List[Step] = field(default_factory=list)
    traced: Optional[Tuple[float, float]] = None

    def in_window(self, s: Step) -> bool:
        return self.t_start <= s.t0 and s.t1 <= self.deadline

    def untraced(self, s: Step) -> bool:
        return self.traced is None or s.t1 <= self.traced[0] \
            or s.t0 >= self.traced[1]

    def untraced_seconds(self) -> float:
        total = self.deadline - self.t_start
        if self.traced is None:
            return total
        return total - (min(self.traced[1], self.deadline) - self.traced[0])


@dataclass
class TrainRun:
    """What the metric readers read."""
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    seconds: float
    setup_s: float
    log: TrainLog
    summary: Optional[TraceSummary]


def _sync(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()


def _norms(flat: Dict[str, torch.Tensor], c: int, scale: float = 1.0
           ) -> Dict[str, float]:
    return {k: float(v[c].float().norm()) * scale for k, v in flat.items()}


def program_readings(trainer, batches, every: int, hyper, init_flat,
                     on_card: bool) -> Dict[str, Any]:
    """The check rounds through the trainer: every cluster's losses a
    round, first-gradient norms (from AdamW's first moment) and change
    norms by leaf."""
    losses, grads = [], None
    for r, batch in enumerate(batches, start=1):
        losses.append(trainer.round(batch).tolist())
        if r == 1:
            m = trainer.first_moments()
            C = batch.shape[0]
            grads = [_norms(m, c, 1.0 / (1.0 - hyper["b1"])) for c in range(C)]
        if r % every == 0:
            trainer.sync()
        _sync(on_card)
    after = trainer.params()
    change = [{k: float((after[k][c].float() - init_flat[k].float()).norm())
               for k in init_flat} for c in range(len(grads))]
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def reference_readings(params, cfg, batches, hyper, every: int,
                       precision: str) -> Dict[str, Any]:
    init = ref_train._flat(params)
    out = ref_train.run(params, cfg, batches, hyper, every, precision)
    change = [{k: float((s[k].float() - init[k].float()).norm())
               for k in init} for s in out["params"]]
    del out["params"]
    return {"losses": out["losses"], "grad_norms": out["grad_norms"],
            "change_norms": change}


def _leaf_gap(got: Dict[str, float], want: Dict[str, float],
              keep: List[str]) -> Tuple[float, str]:
    med = float(np.median([want[k] for k in keep]))
    return max((abs(got[k] - want[k]) / max(want[k], med), k) for k in keep)


def _gaps(got: Dict[str, Any], want: Dict[str, Any]
          ) -> Dict[str, Tuple[float, str]]:
    """The three numbers, each with where it was read."""
    lg, r, c = max((abs(a - b) / abs(b), r, c)
                   for r, (ra, rb) in enumerate(zip(got["losses"],
                                                    want["losses"]), start=1)
                   for c, (a, b) in enumerate(zip(ra, rb)))
    out = {"loss_gap": (lg, f"round {r} cluster {c}")}
    for name, key in (("grad_norm_gap", "grad_norms"),
                      ("change_gap", "change_norms")):
        worst = (0.0, "")
        for c, wg in enumerate(want["grad_norms"]):
            med = float(np.median(list(wg.values())))
            keep = [k for k, v in wg.items() if v >= 1e-3 * med]
            g, leaf = _leaf_gap(got[key][c], want[key][c], keep)
            worst = max(worst, (g, f"leaf {leaf} cluster {c}"))
        out[name] = worst
    return out


def compare(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    """The three numbers of :mod:`benchkit.cell_train`, worst over the
    clusters, against the reference's readings ``want``."""
    return {k: v for k, (v, _) in _gaps(got, want).items()}


def make_batches(traffic: Dict, vocab: int, seed: int, device):
    """Every round's tokens (C, B, S + 1), uniform over the vocabulary,
    drawn on the device from ``seed``: a generator of rounds."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    shape = (int(traffic["clusters"]), int(traffic["batch"]),
             int(traffic["seq_len"]) + 1)
    while True:
        yield torch.randint(0, vocab, shape, generator=gen, device=device)


def setup(cell: Cell, seed: int, device):
    """Kernels, weights, the trainer and the batch stream."""
    cfg, traffic = cell.config, cell.traffic
    if torch.device(device).type == "cuda":
        program.load_kernels()
    params = weights.make_params(cfg, seed, device)
    trainer = program.HflTrainer(cfg, params, int(traffic["clusters"]),
                                 traffic["optimizer"])
    return params, trainer, make_batches(traffic, int(cfg["vocab_size"]),
                                         seed, device)


def _trace_hook(tracer: DeviceTrace, seconds: float, every: int):
    """Starts the profiler before a round that follows a sync, once
    ``TRACE_AT`` of the window has passed; stops after the next sync."""
    state = {"armed": True}

    def before_round(log: TrainLog, r: int) -> None:
        if state["armed"] and (r - 1) % every == 0 and \
                time.perf_counter() - log.t_start >= TRACE_AT * seconds:
            state["armed"] = False
            tracer.start()
            log.traced = (time.perf_counter(), float("inf"))

    def after_sync(log: TrainLog) -> None:
        if tracer.running:
            tracer.stop()
            log.traced = (log.traced[0], time.perf_counter())
    return before_round, after_sync


def window(trainer, batches, traffic, seconds: float, first_round: int,
           on_card: bool, hooks=None) -> TrainLog:
    every = int(traffic["global_every"])
    tokens = int(traffic["clusters"]) * int(traffic["batch"]) \
        * int(traffic["seq_len"])
    log = TrainLog()
    log.t_start = time.perf_counter()
    log.deadline = log.t_start + seconds
    r = first_round
    while time.perf_counter() < log.deadline:
        if hooks:
            hooks[0](log, r)
        batch = next(batches)
        t0 = time.perf_counter()
        trainer.round(batch)
        log.steps.append(Step("round", t0, time.perf_counter(), tokens))
        if r % every == 0:
            t0 = time.perf_counter()
            trainer.sync()
            _sync(on_card)
            log.steps.append(Step("sync", t0, time.perf_counter()))
            if hooks:
                hooks[1](log)
        r += 1
    return log


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_process: float, control: str = "") -> Dict[str, Any]:
    """One run of a training cell.  With ``control`` a precision of the
    reference (``fp8``), the check also reads the control's three numbers
    (``control``): ``bench/control.py`` does, the benchmark's own runs
    do not."""
    cfg, traffic = cell.config, cell.traffic
    on_card = torch.device(device).type == "cuda"
    every, hyper = int(traffic["global_every"]), traffic["optimizer"]
    params, trainer, batches = setup(cell, seed, device)
    init_flat = ref_train._flat(params)
    checked = [next(batches) for _ in range(int(traffic["check_rounds"]))]
    prog = program_readings(trainer, checked, every, hyper, init_flat,
                            on_card)
    setup_s = time.perf_counter() - t_process
    print(f"set-up s: {setup_s:.3f} (with {len(checked)} check rounds)",
          file=sys.stderr)

    tracer = DeviceTrace() if trace else None
    hooks = _trace_hook(tracer, seconds, every) if trace else None
    log = window(trainer, batches, traffic, seconds, len(checked) + 1,
                 on_card, hooks)
    if tracer is not None and tracer.running:
        tracer.stop()
        log.traced = (log.traced[0], time.perf_counter())
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        print(f"memory bytes: peak {peak}, in use at the close "
              f"{torch.cuda.memory_allocated()}", file=sys.stderr)
    for kind in ("round", "sync"):
        w = [1e3 * (st.t1 - st.t0) for st in log.steps
             if st.kind == kind and log.in_window(st)]
        if w:
            print(f"window {kind}: {len(w)}, ms mean {np.mean(w):.1f} "
                  f"min {min(w):.1f} max {max(w):.1f}", file=sys.stderr)
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    summary = tracer.summary() if tracer is not None and log.traced else None

    t_check = time.perf_counter()
    want = reference_readings(params, cfg, checked, hyper, every, "fp32")
    found = _gaps(prog, want)
    numbers = {k: v for k, (v, _) in found.items()}
    print(f"check s: {time.perf_counter() - t_check:.1f}; read at: "
          + "; ".join(f"{k} {w}" for k, (_, w) in found.items()),
          file=sys.stderr)
    extra = {}
    if control:
        low = reference_readings(params, cfg, checked, hyper, every, control)
        extra = {f"control_{k}": v for k, v in compare(low, want).items()}
    checks = {k: {"value": v, "limit": float(cell.limits[k])}
              for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    rounds = sum(1 for s in log.steps if s.kind == "round"
                 and log.in_window(s))
    return {
        "run": TrainRun(cfg=cfg, traffic=traffic, seconds=seconds,
                        setup_s=setup_s, log=log, summary=summary),
        "correct": bool(correct), "attempted": rounds, "failed": 0,
        "memory_peak_bytes": int(peak), "checks": checks,
        "control": extra, "readings": {"program": prog, "reference": want},
    }


def fault_readings(cell: Cell, seed: int, device) -> Dict[str, Any]:
    """The check rounds alone, through a fresh trainer on the same
    weights and batches (a planted fault's readings)."""
    traffic = cell.traffic
    params, trainer, batches = setup(cell, seed, device)
    checked = [next(batches) for _ in range(int(traffic["check_rounds"]))]
    out = program_readings(trainer, checked, int(traffic["global_every"]),
                           traffic["optimizer"], ref_train._flat(params),
                           torch.device(device).type == "cuda")
    del trainer, params
    gc.collect()
    return out
