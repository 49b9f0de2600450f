"""HFLOP — the inference-aware Hierarchical FL Orchestration Problem
(paper §IV).

    minimize   sum_ij x_ij c^d_ij l  +  sum_j y_j c^e_j            (1)
    subject to x_ij <= y_j                                          (2)
               y_j <= sum_i x_ij                                    (3)
               sum_i x_ij * lambda_i <= r_j                         (4)
               sum_j x_ij <= 1                                      (5)
               sum_ij x_ij >= T                                     (6)
               x, y binary                                          (7)

A solution assigns device i to edge aggregator j (``assign[i] = j``) or
leaves it unassigned (``assign[i] = -1``; only allowed when T < n).
HFLOP generalizes capacitated facility location with unsplittable flows
(NP-hard), so the package ships an exact branch-and-bound solver for
small/medium instances plus greedy + local-search heuristics for scale.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass(frozen=True)
class HFLOPInstance:
    """Problem data.  Shapes: c_d (n,m), c_e (m,), lam (n,), r (m,)."""
    c_d: np.ndarray
    c_e: np.ndarray
    lam: np.ndarray
    r: np.ndarray
    l: int = 2                      # local aggregation rounds per global
    T: Optional[int] = None         # min participating devices (None -> n)

    def __post_init__(self):
        object.__setattr__(self, "c_d", np.asarray(self.c_d, np.float64))
        object.__setattr__(self, "c_e", np.asarray(self.c_e, np.float64))
        object.__setattr__(self, "lam", np.asarray(self.lam, np.float64))
        object.__setattr__(self, "r", np.asarray(self.r, np.float64))
        if self.T is None:
            object.__setattr__(self, "T", self.n)
        if self.c_d.shape != (self.n, self.m):
            raise ValueError("c_d must be (n, m)")

    @property
    def n(self) -> int:
        return self.c_d.shape[0]

    @property
    def m(self) -> int:
        return self.c_d.shape[1]

    def uncapacitated(self) -> "HFLOPInstance":
        """The paper's Fig. 9 lower-bound variant: infinite r_j."""
        return HFLOPInstance(self.c_d, self.c_e, self.lam,
                             np.full(self.m, np.inf), self.l, self.T)


@dataclass
class HFLOPSolution:
    assign: np.ndarray              # (n,) int, -1 = not participating
    cost: float
    optimal: bool = False
    solver: str = ""
    nodes_explored: int = 0
    wall_time_s: float = 0.0
    #: solver-specific diagnostics — the decomposed solver records
    #: per-phase wall times, region counts, repair statistics and a
    #: cheap lower bound here (``meta["phase_s"]``, ``meta["gap_vs_lb"]``)
    meta: Dict[str, object] = field(default_factory=dict)

    @property
    def y(self) -> np.ndarray:
        """Open-edge indicator, vectorized — this runs inside every
        reactive recluster, so no per-edge Python loop."""
        m = 1 + (int(self.assign.max()) if self.assign.size else -1)
        if m <= 0:
            return np.zeros(0, dtype=bool)
        ok = self.assign >= 0
        return np.bincount(self.assign[ok], minlength=m).astype(bool)

    def x_matrix(self, m: int) -> np.ndarray:
        n = self.assign.shape[0]
        x = np.zeros((n, m), bool)
        ok = self.assign >= 0
        x[np.arange(n)[ok], self.assign[ok]] = True
        return x


def objective(inst: HFLOPInstance, assign: np.ndarray) -> float:
    """Objective (1) for an assignment vector."""
    assign = np.asarray(assign)
    ok = assign >= 0
    local = float(np.sum(inst.c_d[np.arange(inst.n)[ok], assign[ok]])) * inst.l
    open_edges = np.unique(assign[ok])
    return local + float(np.sum(inst.c_e[open_edges]))


def violations(inst: HFLOPInstance, assign: np.ndarray) -> List[str]:
    """Empty list iff ``assign`` is feasible.  Per-edge loads come from
    one ``np.bincount`` instead of an m-pass scan — this is on the
    reactive-recluster hot path."""
    out = []
    assign = np.asarray(assign)
    if assign.shape != (inst.n,):
        return [f"assign shape {assign.shape} != ({inst.n},)"]
    if np.any(assign >= inst.m):
        out.append("assignment to nonexistent edge")
    participating = int(np.sum(assign >= 0))
    if participating < inst.T:
        out.append(f"participation {participating} < T={inst.T}")
    valid = (assign >= 0) & (assign < inst.m)
    loads = np.bincount(assign[valid], weights=inst.lam[valid],
                        minlength=inst.m)
    for j in np.nonzero(loads > inst.r + 1e-9)[0]:
        out.append(f"edge {j}: load {loads[j]:.3f} > r={inst.r[j]:.3f}")
    return out


def is_feasible(inst: HFLOPInstance, assign: np.ndarray) -> bool:
    return not violations(inst, assign)


# ---------------------------------------------------------------------------
# ILP matrix construction (used by the LP-relaxation branch & bound)
# ---------------------------------------------------------------------------

@dataclass
class ILP:
    """min c.v  s.t.  A v <= b,  0 <= v <= 1,  v binary.
    Variable layout: v = [x_00..x_0m-1, x_10.., ..., y_0..y_m-1]."""
    c: np.ndarray
    A: np.ndarray
    b: np.ndarray
    n: int
    m: int

    def x_index(self, i: int, j: int) -> int:
        return i * self.m + j

    def y_index(self, j: int) -> int:
        return self.n * self.m + j


def build_ilp(inst: HFLOPInstance) -> ILP:
    """Constraint-matrix assembly with index arithmetic: every block is
    written into one preallocated ``(n_rows, nv)`` array through fancy
    indexing (no per-row Python loops, no list of dense rows), so the
    MILP baseline survives the larger subsample sizes the decomposed
    solver is benchmarked against.  Row order matches the original
    loop construction exactly: (2) i-major, (3), (4) finite-capacity
    edges in index order, (5), (6)."""
    n, m = inst.n, inst.m
    nv = n * m + m
    c = np.concatenate([(inst.c_d * inst.l).reshape(-1), inst.c_e])
    fin = np.nonzero(np.isfinite(inst.r))[0]       # edges with a cap row
    n_rows = n * m + m + fin.size + n + 1
    A = np.zeros((n_rows, nv))
    b = np.zeros(n_rows)
    xi = np.arange(n * m)                           # x_ij column ids
    # (2) x_ij - y_j <= 0 — row i*m+j touches columns (i*m+j, n*m+j)
    A[xi, xi] = 1.0
    A[xi, n * m + xi % m] = -1.0
    # (3) y_j - sum_i x_ij <= 0
    r3 = n * m + np.arange(m)
    A[r3, n * m + np.arange(m)] = 1.0
    A[r3[:, None], np.arange(m)[:, None] + m * np.arange(n)[None, :]] = -1.0
    # (4) sum_i lam_i x_ij <= r_j   (skip infinite capacities)
    r4 = n * m + m + np.arange(fin.size)
    A[r4[:, None], fin[:, None] + m * np.arange(n)[None, :]] = inst.lam
    b[r4] = inst.r[fin]
    # (5) sum_j x_ij <= 1
    r5 = n * m + m + fin.size + np.arange(n)
    A[r5[:, None], m * np.arange(n)[:, None] + np.arange(m)[None, :]] = 1.0
    b[r5] = 1.0
    # (6) -sum x_ij <= -T
    A[-1, :n * m] = -1.0
    b[-1] = -float(inst.T)
    return ILP(c=c, A=A, b=b, n=n, m=m)


# ---------------------------------------------------------------------------
# Random instance generators (Fig. 2 / Fig. 9 setups)
# ---------------------------------------------------------------------------

def random_instance(n: int, m: int, seed: int = 0, l: int = 2,
                    T: Optional[int] = None,
                    capacity_slack: float = 1.5) -> HFLOPInstance:
    """Generic random instance: uniform costs, uniform rates, capacities
    scaled so total capacity = slack * total load (paper §V-D draws
    workloads and capacities uniformly at random)."""
    rng = np.random.default_rng(seed)
    c_d = rng.uniform(0.0, 1.0, (n, m))
    c_e = rng.uniform(0.5, 1.5, m)
    lam = rng.uniform(0.1, 1.0, n)
    raw = rng.uniform(0.5, 1.5, m)
    r = raw / raw.sum() * lam.sum() * capacity_slack
    return HFLOPInstance(c_d, c_e, lam, r, l=l, T=T)


def paper_cost_instance(n: int, m: int, seed: int = 0, l: int = 2,
                        capacity_slack: float = 1.5) -> HFLOPInstance:
    """The Fig. 9 setup: each device has exactly one zero-cost edge (its
    LAN host), every other edge costs 1; edge-cloud cost 1; all devices
    must participate; workloads/capacities uniform at random."""
    rng = np.random.default_rng(seed)
    c_d = np.ones((n, m))
    free = rng.integers(0, m, n)
    c_d[np.arange(n), free] = 0.0
    c_e = np.ones(m)
    lam = rng.uniform(0.1, 1.0, n)
    raw = rng.uniform(0.5, 1.5, m)
    r = raw / raw.sum() * lam.sum() * capacity_slack
    return HFLOPInstance(c_d, c_e, lam, r, l=l, T=n)
