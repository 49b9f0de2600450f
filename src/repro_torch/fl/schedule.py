"""Round timeline of hierarchical FL — numpy/stdlib-only.

The wall-clock shape of a training schedule (``RoundWindow`` /
``round_schedule``) is consumed by the training–inference co-simulation
(`repro.sim`), which must import without jax (contract LAYER001 —
see CONTRACTS.md).  The jax-backed training runner in
``repro.fl.hierarchy`` builds on the same types; it re-exports them so
existing imports keep working.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class RoundWindow:
    """Wall-clock footprint of one HFL round on the continuum:
    participating devices compute local epochs in [start, compute_end)
    (the slowest device defines compute_end), then edges aggregate the
    uploads in [compute_end, upload_end) — with the cloud joining every
    l-th round for the global aggregation."""
    index: int
    start: float
    compute_end: float
    upload_end: float
    is_global: bool
    local_epochs: int = 1

    @property
    def end(self) -> float:
        return self.upload_end


def round_schedule(rounds: int, l: int = 2, local_epochs: int = 5,
                   epoch_s: float = 6.0, upload_s: float = 2.0,
                   global_extra_s: float = 2.0, gap_s: float = 0.0,
                   start_s: float = 0.0) -> List[RoundWindow]:
    """Wall-clock timeline of ``rounds`` HFL rounds (paper §V-B2 shape:
    ``local_epochs`` per round, a cluster aggregation each round, a
    global aggregation every ``l``-th).  ``gap_s`` is idle time between
    rounds — 0 models a back-to-back retraining burst."""
    out: List[RoundWindow] = []
    t = float(start_s)
    for k in range(rounds):
        is_global = ((k + 1) % max(l, 1) == 0)
        compute_end = t + local_epochs * epoch_s
        upload_end = compute_end + upload_s \
            + (global_extra_s if is_global else 0.0)
        out.append(RoundWindow(index=k, start=t, compute_end=compute_end,
                               upload_end=upload_end, is_global=is_global,
                               local_epochs=local_epochs))
        t = upload_end + gap_s
    return out
