"""Communication-cost accounting (paper §V-D).

The paper counts traffic *over metered links only* (zero-cost links are
free), with each model exchange = upload + download of the serialized
model (594 KB for the use-case GRU), l local aggregation rounds per
global round, and convergence after ``total_rounds`` aggregation rounds.

Reference numbers reproduced by the tests / Fig. 9 benchmark
(4 edges, 20 devices, 100 rounds):  flat FL 2.37 GB, HFLOP 0.53 GB,
uncapacitated 0.24 GB.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.hflop import HFLOPInstance

# paper: "594 KB in serialized format".  594e3 (not 594*1024) reproduces
# the paper's absolute volumes exactly: 100 rounds x 20 devices x 2 dirs
# x 594 KB = 2.376 GB ("approximately 2.37 GB" for flat FL in §V-D) and
# 50 global rounds x 4 edges x 2 x 594 KB = 0.2376 GB (uncapacitated).
GRU_MODEL_BYTES = 594_000


@dataclass(frozen=True)
class CostReport:
    metered_bytes: float              # traffic over metered links
    local_bytes: float                # device<->aggregator share
    global_bytes: float               # aggregator<->cloud share
    n_global_rounds: int
    n_local_rounds: int

    @property
    def gigabytes(self) -> float:
        return self.metered_bytes / 1e9


def flat_fl_cost(n_devices: int, total_rounds: int,
                 model_bytes: int = GRU_MODEL_BYTES,
                 device_cloud_cost: np.ndarray | float = 1.0) -> CostReport:
    """Centralized FL: every aggregation round, every device exchanges the
    model with the cloud (metered unless its cost is 0)."""
    costs = np.broadcast_to(np.asarray(device_cloud_cost, float),
                            (n_devices,))
    metered = int(np.sum(costs > 0))
    total = total_rounds * metered * 2 * model_bytes
    return CostReport(metered_bytes=total, local_bytes=0.0,
                      global_bytes=total, n_global_rounds=total_rounds,
                      n_local_rounds=0)


def hfl_cost(inst: HFLOPInstance, assign: np.ndarray, total_rounds: int,
             model_bytes: int = GRU_MODEL_BYTES) -> CostReport:
    """Hierarchical FL under an HFLOP assignment.

    ``total_rounds`` counts *local* aggregation rounds (as in Fig. 6);
    a global round happens every ``inst.l`` local rounds.  Traffic over
    zero-cost device-edge links is free; edge-cloud links are metered
    when c_e > 0."""
    assign = np.asarray(assign)
    ok = assign >= 0
    n_global = total_rounds // inst.l
    metered_dev = int(np.sum(inst.c_d[np.arange(inst.n)[ok], assign[ok]] > 0))
    local = total_rounds * metered_dev * 2 * model_bytes
    open_edges = np.unique(assign[ok])
    metered_edges = int(np.sum(inst.c_e[open_edges] > 0))
    glob = n_global * metered_edges * 2 * model_bytes
    return CostReport(metered_bytes=local + glob, local_bytes=local,
                      global_bytes=glob, n_global_rounds=n_global,
                      n_local_rounds=total_rounds)


def savings_vs_flat(inst: HFLOPInstance, assign: np.ndarray,
                    total_rounds: int,
                    model_bytes: int = GRU_MODEL_BYTES) -> float:
    """Fig. 9 metric: % communication-cost reduction vs standard FL."""
    flat = flat_fl_cost(inst.n, total_rounds, model_bytes)
    hier = hfl_cost(inst, assign, total_rounds, model_bytes)
    return 100.0 * (1.0 - hier.metered_bytes / flat.metered_bytes)
