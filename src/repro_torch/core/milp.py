"""A small dense MILP solver: two-phase primal simplex + best-first
branch & bound over binary variables.

Built because the container is offline (the paper uses CPLEX; we need an
exact reference solver for HFLOP).  Designed for correctness on the
instance sizes the tests and Fig.-2-style scaling sweeps use, not for
industrial scale — large instances are handled by the heuristics in
``repro.core.solvers``.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.telemetry.tracer import wall_clock

_EPS = 1e-9


class LPResult:
    __slots__ = ("status", "x", "obj")

    def __init__(self, status: str, x: Optional[np.ndarray], obj: float):
        self.status = status  # optimal | infeasible | unbounded
        self.x = x
        self.obj = obj


def _simplex(T: np.ndarray, basis: np.ndarray, n_total: int,
             max_iter: int = 20000) -> str:
    """In-place tableau simplex.  T is (m+1, n_total+1) with objective row
    last; basis (m,) column indices.  Returns status."""
    m = T.shape[0] - 1
    for it in range(max_iter):
        # entering: Dantzig, Bland fallback near stall
        red = T[-1, :n_total]
        if it < max_iter // 2:
            e = int(np.argmin(red))
            if red[e] >= -_EPS:
                return "optimal"
        else:  # Bland
            neg = np.nonzero(red < -_EPS)[0]
            if neg.size == 0:
                return "optimal"
            e = int(neg[0])
        col = T[:m, e]
        pos = col > _EPS
        if not np.any(pos):
            return "unbounded"
        ratios = np.full(m, np.inf)
        ratios[pos] = T[:m, -1][pos] / col[pos]
        r = int(np.argmin(ratios))
        # ties: Bland on basis index to avoid cycling
        tie = np.nonzero(np.abs(ratios - ratios[r]) < _EPS)[0]
        if tie.size > 1:
            r = int(tie[np.argmin(basis[tie])])
        piv = T[r, e]
        T[r] /= piv
        for k in range(m + 1):
            if k != r and abs(T[k, e]) > _EPS:
                T[k] -= T[k, e] * T[r]
        basis[r] = e
    return "iteration_limit"


def solve_lp(c: np.ndarray, A: np.ndarray, b: np.ndarray,
             ub: Optional[np.ndarray] = None) -> LPResult:
    """min c.x  s.t.  A x <= b,  0 <= x (<= ub per-var if given)."""
    c = np.asarray(c, float)
    A = np.asarray(A, float)
    b = np.asarray(b, float).copy()
    nv = c.shape[0]
    if ub is not None:
        fin = np.isfinite(ub)
        if np.any(fin):
            rows = np.zeros((int(fin.sum()), nv))
            rows[np.arange(int(fin.sum())), np.nonzero(fin)[0]] = 1.0
            A = np.vstack([A, rows])
            b = np.concatenate([b, ub[fin]])
    mrows = A.shape[0]
    # rows with negative rhs: flip sign so b >= 0, slack coeff -1, add artificial
    flip = b < 0
    A = A.copy()
    A[flip] *= -1.0
    b[flip] *= -1.0
    slack_sign = np.where(flip, -1.0, 1.0)
    n_art = int(flip.sum())
    n_total = nv + mrows + n_art
    T = np.zeros((mrows + 1, n_total + 1))
    T[:mrows, :nv] = A
    T[:mrows, nv:nv + mrows] = np.diag(slack_sign)
    art_cols = []
    k = 0
    basis = np.zeros(mrows, dtype=int)
    for i in range(mrows):
        if flip[i]:
            col = nv + mrows + k
            T[i, col] = 1.0
            basis[i] = col
            art_cols.append(col)
            k += 1
        else:
            basis[i] = nv + i
    T[:mrows, -1] = b
    if n_art:
        # phase 1: min sum of artificials
        T[-1, art_cols] = 1.0
        for i in range(mrows):
            if flip[i]:
                T[-1] -= T[i]
        st = _simplex(T, basis, n_total)
        if st != "optimal" or T[-1, -1] < -1e-7:
            return LPResult("infeasible", None, np.inf)
        art_set = set(art_cols)
        # drive remaining (degenerate, zero-level) artificials out of the
        # basis; rows where no real column is available are redundant.
        for i in range(mrows):
            if basis[i] in art_set:
                if T[i, -1] > 1e-7:
                    return LPResult("infeasible", None, np.inf)
                row = T[i, :nv + mrows]
                cand = np.nonzero(np.abs(row) > 1e-7)[0]
                if cand.size:
                    e = int(cand[0])
                    T[i] /= T[i, e]
                    for k2 in range(mrows + 1):
                        if k2 != i and abs(T[k2, e]) > _EPS:
                            T[k2] -= T[k2, e] * T[i]
                    basis[i] = e
                else:
                    T[i, :] = 0.0          # redundant row
        # phase 2 objective
        T[-1, :] = 0.0
        T[-1, :nv] = c
        for i in range(mrows):
            if basis[i] < nv:
                T[-1] -= c[basis[i]] * T[i]
        # forbid artificial columns (all non-basic now)
        for col in art_cols:
            T[:mrows, col] = 0.0
            T[-1, col] = 1e30
    else:
        T[-1, :nv] = c
    st = _simplex(T, basis, n_total)
    if st == "unbounded":
        return LPResult("unbounded", None, -np.inf)
    if st != "optimal":
        return LPResult("infeasible", None, np.inf)
    x = np.zeros(n_total)
    x[basis] = T[:len(basis), -1]
    xv = x[:nv]
    return LPResult("optimal", xv, float(c @ xv))


@dataclass(order=True)
class _Node:
    bound: float
    seq: int
    fixed: Dict[int, float] = field(compare=False)


@dataclass
class MILPResult:
    status: str
    x: Optional[np.ndarray]
    obj: float
    nodes: int
    wall_time_s: float


def solve_milp(c: np.ndarray, A: np.ndarray, b: np.ndarray,
               incumbent_x: Optional[np.ndarray] = None,
               branch_priority: Optional[np.ndarray] = None,
               rounding: Optional[Callable[[np.ndarray],
                                           Optional[np.ndarray]]] = None,
               max_nodes: int = 200_000,
               time_limit_s: float = 600.0) -> MILPResult:
    """Best-first B&B for min c.x, A x <= b, x in {0,1}^n.

    ``rounding(x_frac)`` may return a feasible integer vector used to
    tighten the incumbent.  ``branch_priority`` raises branching priority
    for the flagged variables (HFLOP: branch y_j before x_ij)."""
    t0 = wall_clock()
    nv = c.shape[0]
    ub = np.ones(nv)
    best_x, best_obj = None, np.inf
    if incumbent_x is not None:
        v = np.asarray(incumbent_x, float)
        if np.all(A @ v <= b + 1e-7):
            best_x, best_obj = v, float(c @ v)

    def lp_with_fixed(fixed: Dict[int, float]) -> LPResult:
        if not fixed:
            return solve_lp(c, A, b, ub)
        idx = np.asarray(sorted(fixed), int)
        vals = np.asarray([fixed[i] for i in sorted(fixed)])
        free = np.setdiff1d(np.arange(nv), idx)
        res = solve_lp(c[free], A[:, free], b - A[:, idx] @ vals,
                       ub[free])
        if res.x is None:
            return res
        full = np.zeros(nv)
        full[free] = res.x
        full[idx] = vals
        return LPResult(res.status, full, float(c @ full))

    seq = 0
    root = lp_with_fixed({})
    if root.status != "optimal":
        return MILPResult(root.status, best_x, best_obj, 1,
                          wall_clock() - t0)
    heap: List[_Node] = [_Node(root.obj, seq, {})]
    nodes = 0
    while heap:
        node = heapq.heappop(heap)
        if node.bound >= best_obj - 1e-9:
            continue
        nodes += 1
        if nodes > max_nodes or wall_clock() - t0 > time_limit_s:
            return MILPResult("limit", best_x, best_obj, nodes,
                              wall_clock() - t0)
        res = lp_with_fixed(node.fixed)
        if res.status != "optimal" or res.obj >= best_obj - 1e-9:
            continue
        x = res.x
        frac = np.abs(x - np.round(x))
        frac[list(node.fixed)] = 0.0
        if np.all(frac < 1e-6):
            xi = np.round(x)
            obj = float(c @ xi)
            if np.all(A @ xi <= b + 1e-7) and obj < best_obj:
                best_x, best_obj = xi, obj
            continue
        if rounding is not None:
            cand = rounding(x)
            if cand is not None:
                cobj = float(c @ cand)
                if cobj < best_obj and np.all(A @ cand <= b + 1e-7):
                    best_x, best_obj = cand, cobj
        score = frac.copy()
        if branch_priority is not None:
            score = score * (1.0 + 10.0 * branch_priority)
        k = int(np.argmax(score))
        for val in (1.0, 0.0):
            child = dict(node.fixed)
            child[k] = val
            r = lp_with_fixed(child)
            if r.status == "optimal" and r.obj < best_obj - 1e-9:
                seq += 1
                heapq.heappush(heap, _Node(r.obj, seq, child))
    status = "optimal" if best_x is not None else "infeasible"
    return MILPResult(status, best_x, best_obj, nodes,
                      wall_clock() - t0)
