"""Serving measurements.  Counterpart of ``repro/serving/engine.py``;
the slot engines (``ServeEngine``, ``PagedServeEngine``) come with the
LM slice (ROADMAP.md)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class EngineMeasurement:
    """Timings of one serving replica — the raw material for
    ``LatencyModel.from_measurements`` (routing/latency.py)."""
    prefill_ms: float              # one admission of a prompt_len prompt
    decode_ms_per_token: float     # one continuous-batching step
    batch_size: int                # max concurrent sequences
    prompt_len: int
    decode_steps: int
    # occupancy sweep: ((concurrency, decode_ms_per_step), ...) measured
    # at increasing admitted-sequence counts
    occupancy_ms: Tuple[Tuple[int, float], ...] = ()
