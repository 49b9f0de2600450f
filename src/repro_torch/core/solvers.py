"""HFLOP solvers.

  - ``solve_bruteforce``   exact enumeration (tiny instances; test oracle)
  - ``solve_bnb``          exact LP-relaxation branch & bound (own simplex)
  - ``solve_greedy``       capacity-aware greedy + edge-closing pass
  - ``local_search``       vectorized move/close/open improvement loop
  - ``solve_heuristic``    greedy + local search (the scalable path)
  - ``solve_decomposed``   hierarchically decomposed solver (10^5-10^6
                           devices: partition -> per-region sub-solve ->
                           stitch -> polish)
  - ``solve_uncapacitated``paper's Fig. 9 lower-bound variant

The greedy / rounding passes are *sequential* heuristics (each device's
choice depends on the loads left by every earlier device), vectorized
here by chunked speculation: evaluate a whole chunk of devices against
the chunk-start state in one ``(chunk, m)`` NumPy pass, then commit the
longest prefix whose picks provably match the sequential replay.  The
two regime changes that can invalidate a speculated pick are (a) an
earlier in-chunk pick *opening* a new edge — which lowers that edge's
cost for everyone after it — and (b) an edge *filling up* mid-chunk.
Feasibility only ever shrinks as devices commit, so until one of those
events the batch argmin and the sequential argmin coincide (the
sequential feasible set is a superset-masked view of the same cost row,
and ``np.argmin``'s lowest-index tie-break is identical).  Chunks whose
running loads graze a capacity bound within float noise are replayed
scalar so summation-order ULPs can never flip a decision: the
vectorized solvers are bit-compatible with the original per-device
loops (pinned by ``tests/test_solver_scale.py``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core.hflop import (HFLOPInstance, HFLOPSolution, build_ilp,
                              is_feasible, objective)
from repro_torch.core.milp import solve_milp
from repro_torch.core.partition import (AnyInstance, LanHFLOPInstance,
                                  partition_instance, sub_instance)
from repro_torch.telemetry import (SpanTracer, Telemetry,
                             maybe as _maybe_tel)
from repro_torch.telemetry.tracer import wall_clock

_CHUNK0 = 256                 # speculation chunk start size
_CHUNK_CELLS = 4_000_000      # cap chunk_rows * m (bounded memory)


def _chunk_cap(m: int) -> int:
    return max(_CHUNK0, _CHUNK_CELLS // max(m, 1))


def _cost_rows_fn(inst: AnyInstance) -> Callable[[np.ndarray], np.ndarray]:
    """Batch accessor for c_d rows — dense slice or implicit LAN rows."""
    if isinstance(inst, LanHFLOPInstance):
        return inst.cost_rows
    c_d = inst.c_d
    return lambda ids: c_d[ids]


def _objective_any(inst: AnyInstance, assign: np.ndarray) -> float:
    if isinstance(inst, LanHFLOPInstance):
        return inst.objective(assign)
    return objective(inst, assign)


def _local_costs_any(inst: AnyInstance, assign: np.ndarray) -> np.ndarray:
    if isinstance(inst, LanHFLOPInstance):
        return inst.local_costs(assign)
    return _assignment_cost_components(inst, assign)


# ---------------------------------------------------------------------------
# exact: brute force (oracle)
# ---------------------------------------------------------------------------

def solve_bruteforce(inst: HFLOPInstance) -> HFLOPSolution:
    t0 = wall_clock()
    n, m = inst.n, inst.m
    if (m + 1) ** n > 5_000_000:
        raise ValueError("instance too large for brute force")
    best = None
    best_cost = np.inf
    assign = np.full(n, -1, int)
    load = np.zeros(m)

    def rec(i: int, partial_local: float):
        nonlocal best, best_cost
        if partial_local >= best_cost:
            return
        if i == n:
            if int(np.sum(assign >= 0)) < inst.T:
                return
            cost = objective(inst, assign)
            if cost < best_cost:
                best_cost = cost
                best = assign.copy()
            return
        # option: skip device (only useful if enough devices remain)
        if (n - i - 1) + int(np.sum(assign[:i] >= 0)) >= inst.T:
            assign[i] = -1
            rec(i + 1, partial_local)
        for j in range(m):
            if load[j] + inst.lam[i] <= inst.r[j] + 1e-12:
                assign[i] = j
                load[j] += inst.lam[i]
                rec(i + 1, partial_local + inst.c_d[i, j] * inst.l)
                load[j] -= inst.lam[i]
        assign[i] = -1

    rec(0, 0.0)
    if best is None:
        return HFLOPSolution(np.full(n, -1), np.inf, optimal=False,
                             solver="bruteforce",
                             wall_time_s=wall_clock() - t0)
    return HFLOPSolution(best, best_cost, optimal=True, solver="bruteforce",
                         wall_time_s=wall_clock() - t0)


# ---------------------------------------------------------------------------
# chunked-speculation primitives (shared by greedy / close / rounding)
# ---------------------------------------------------------------------------

def _capacity_limit(picks, okmask, w, load, r):
    """Longest commit-safe prefix under capacity, assuming every earlier
    in-chunk pick lands.  Running per-edge loads come from a grouped
    cumsum (stable sort by edge keeps in-chunk order within each group).
    Returns ``(cut, guard)``: ``cut`` leading positions are safe;
    ``guard`` means some running load is within float noise of its bound
    and the caller must replay the chunk scalar to stay bit-exact."""
    sel = np.nonzero(okmask)[0]
    if sel.size == 0:
        return picks.shape[0], False
    srt = np.argsort(picks[sel], kind="stable")
    ps = picks[sel][srt]
    ws = w[sel][srt]
    cw = np.cumsum(ws)
    first = np.searchsorted(ps, ps, side="left")
    run = load[ps] + (cw - (cw[first] - ws[first]))
    margin = (r[ps] + 1e-12) - run
    if np.any(np.abs(margin) < 1e-9):
        return picks.shape[0], True
    bad = margin < 0.0
    if not bad.any():
        return picks.shape[0], False
    return int(sel[srt[bad]].min()), False


def _scalar_insert_chunk(rows, ids, lam, r, c_e, l, load, opened, assign):
    """Verbatim sequential insertion for one chunk (guard fallback)."""
    for k in range(ids.size):
        i = ids[k]
        costs = rows[k] * l + np.where(opened, 0.0, c_e)
        feas = load + lam[i] <= r + 1e-12
        costs = np.where(feas, costs, np.inf)
        j = int(np.argmin(costs))
        if np.isfinite(costs[j]):
            assign[i] = j
            load[j] += lam[i]
            opened[j] = True


def _greedy_insert(cost_rows, order, lam, r, c_e, l, load, opened, assign):
    """Chunk-speculated replay of the sequential cheapest-feasible-edge
    insertion.  Commits cut at the first in-chunk edge *open* (that pick
    is itself valid — commit through it) and before the first capacity
    overflow.  Mutates ``load`` / ``opened`` / ``assign`` in place."""
    m = r.shape[0]
    cap = _chunk_cap(m)
    pos, chunk = 0, _CHUNK0
    n_ord = order.shape[0]
    while pos < n_ord:
        ids = order[pos:pos + chunk]
        rows = cost_rows(ids)
        C = rows * l + np.where(opened, 0.0, c_e)[None, :]
        feas = load[None, :] + lam[ids][:, None] <= r[None, :] + 1e-12
        C = np.where(feas, C, np.inf)
        picks = np.argmin(C, axis=1)
        okm = np.isfinite(C[np.arange(ids.size), picks])
        cut = ids.size
        vo = np.nonzero(okm & ~opened[picks])[0]
        if vo.size:
            cut = int(vo[0]) + 1
        cap_cut, guard = _capacity_limit(picks[:cut], okm[:cut],
                                         lam[ids[:cut]], load, r)
        if guard:
            _scalar_insert_chunk(rows, ids, lam, r, c_e, l,
                                 load, opened, assign)
            pos += ids.size
            chunk = _CHUNK0
            continue
        cut = min(cut, cap_cut)
        com = okm[:cut]
        ci = ids[:cut][com]
        cp = picks[:cut][com]
        assign[ci] = cp
        np.add.at(load, cp, lam[ci])           # in-order adds, as sequential
        opened[cp] = True
        good = cut == ids.size
        pos += cut
        chunk = min(chunk * 4, cap) if good else _CHUNK0


def _relocation_trial(cost_rows, mem, j, lam, r, l, load, opened):
    """Trial relocation of every member of edge ``j`` onto other open
    edges (cheapest first per member, capacity-aware), chunk-speculated.
    Returns ``(moves, load2, delta)`` with ``delta`` accumulated in the
    exact sequential order (cumsum == repeated binary adds), or ``None``
    if some member cannot be relocated."""
    load2 = load.copy()
    moves = np.empty(mem.size, np.int64)
    deltas = np.empty(mem.size)
    cap = _chunk_cap(r.shape[0])
    pos, chunk = 0, _CHUNK0
    while pos < mem.size:
        ids = mem[pos:pos + chunk]
        rows = cost_rows(ids)
        C = rows * l
        feas = ((load2[None, :] + lam[ids][:, None] <= r[None, :] + 1e-12)
                & opened[None, :])
        feas[:, j] = False
        C = np.where(feas, C, np.inf)
        picks = np.argmin(C, axis=1)
        okm = np.isfinite(C[np.arange(ids.size), picks])
        cut = ids.size
        fail = False
        vb = np.nonzero(~okm)[0]
        if vb.size:
            cut = int(vb[0])
            fail = True
        cap_cut, guard = _capacity_limit(picks[:cut], np.ones(cut, bool),
                                         lam[ids[:cut]], load2, r)
        if guard:                               # scalar replay, bit-exact
            for k in range(ids.size):
                i = ids[k]
                costs = rows[k] * l
                f = (load2 + lam[i] <= r + 1e-12) & opened
                f[j] = False
                costs = np.where(f, costs, np.inf)
                kk = int(np.argmin(costs))
                if not np.isfinite(costs[kk]):
                    return None
                moves[pos + k] = kk
                deltas[pos + k] = (rows[k, kk] - rows[k, j]) * l
                load2[kk] += lam[i]
            pos += ids.size
            chunk = _CHUNK0
            continue
        if cap_cut < cut:
            cut = cap_cut
            fail = False
        cp = picks[:cut]
        moves[pos:pos + cut] = cp
        deltas[pos:pos + cut] = (rows[np.arange(cut), cp]
                                 - rows[:cut, j]) * l
        np.add.at(load2, cp, lam[ids[:cut]])
        good = cut == ids.size
        pos += cut
        if fail:
            return None
        chunk = min(chunk * 4, cap) if good else _CHUNK0
    delta = float(np.cumsum(deltas)[-1]) if mem.size else 0.0
    return moves, load2, delta


def _close_edges(cost_rows, lam, r, c_e, l, m, assign, load, opened):
    """Close-edge pass: for each open edge (fewest members first), move
    every member elsewhere if the relocation total beats the open cost.
    Mutates ``assign`` / ``load`` / ``opened`` in place."""
    for j in np.argsort(np.bincount(assign[assign >= 0] + 0,
                                    minlength=m))[:m]:
        if not opened[j]:
            continue
        members = np.nonzero(assign == j)[0]
        if members.size == 0:
            opened[j] = False
            continue
        mem = members[np.argsort(-lam[members])]
        res = _relocation_trial(cost_rows, mem, j, lam, r, l, load, opened)
        if res is None:
            continue
        moves, load2, delta = res
        if delta < c_e[j] - 1e-12:
            assign[mem] = moves
            load[:] = load2
            load[j] = 0.0
            opened[j] = False


# ---------------------------------------------------------------------------
# greedy + local search
# ---------------------------------------------------------------------------

def _assignment_cost_components(inst, assign):
    ok = assign >= 0
    local = np.zeros(inst.n)
    local[ok] = inst.c_d[np.arange(inst.n)[ok], assign[ok]] * inst.l
    return local


def solve_greedy(inst: AnyInstance) -> HFLOPSolution:
    """Capacity-aware greedy: place hard-to-fit devices first at their
    cheapest feasible edge (open cost amortized), then close unprofitable
    edges, then drop surplus devices if T < n.  Accepts dense or
    structured (LAN) instances; all passes are chunk-vectorized."""
    t0 = wall_clock()
    n, m = inst.n, inst.m
    assign = np.full(n, -1, int)
    load = np.zeros(m)
    opened = np.zeros(m, bool)
    order = np.argsort(-inst.lam)                      # big consumers first
    rows_of = _cost_rows_fn(inst)
    _greedy_insert(rows_of, order, inst.lam, inst.r, inst.c_e, inst.l,
                   load, opened, assign)
    _close_edges(rows_of, inst.lam, inst.r, inst.c_e, inst.l, m,
                 assign, load, opened)
    # participation trimming (T < n): dropping a device always saves >= 0.
    # Sorted by descending local cost, the sequential loop stops at the
    # first non-positive entry — i.e. it drops the prefix of positive
    # local costs, capped at the surplus.
    surplus = int(np.sum(assign >= 0)) - inst.T
    if surplus > 0:
        local = _local_costs_any(inst, assign)
        ordt = np.argsort(-local)
        drop = ordt[:min(surplus, int(np.sum(local > 0)))]
        np.subtract.at(load, assign[drop], inst.lam[drop])
        assign[drop] = -1
    cost = (_objective_any(inst, assign)
            if np.sum(assign >= 0) >= inst.T else np.inf)
    return HFLOPSolution(assign, cost, optimal=False, solver="greedy",
                         wall_time_s=wall_clock() - t0)


def local_search(inst: HFLOPInstance, sol: HFLOPSolution,
                 max_iters: int = 10_000) -> HFLOPSolution:
    """Vectorized best-improvement: all single-device relocation deltas
    (with edge open/close bookkeeping) are evaluated in one ``(n, m)``
    matrix pass per iteration; the best move commits and the state is
    rebuilt from scratch (keeps float accumulation order canonical)."""
    t0 = wall_clock()
    n, m = inst.n, inst.m
    if not np.isfinite(sol.cost) or not is_feasible(inst, sol.assign):
        return sol                      # nothing feasible to improve
    assign = sol.assign.copy()
    for _ in range(max_iters):
        ok = assign >= 0
        load = np.zeros(m)
        np.add.at(load, assign[ok], inst.lam[ok])
        counts = np.zeros(m, int)
        np.add.at(counts, assign[ok], 1)
        opened = counts > 0
        cur_local = np.where(ok, inst.c_d[np.arange(n),
                                          np.clip(assign, 0, m - 1)], 0.0)
        cur_local = cur_local * inst.l * ok
        # delta[i, j] = cost change of moving device i to edge j
        open_cost = np.where(opened, 0.0, inst.c_e)[None, :]
        close_save = np.where(ok & (counts[np.clip(assign, 0, m - 1)] == 1),
                              inst.c_e[np.clip(assign, 0, m - 1)], 0.0)
        delta = (inst.c_d * inst.l + open_cost
                 - cur_local[:, None] - close_save[:, None])
        feas = load[None, :] + inst.lam[:, None] <= inst.r[None, :] + 1e-12
        same = np.zeros((n, m), bool)
        same[np.arange(n)[ok], assign[ok]] = True
        delta = np.where(feas & ~same, delta, np.inf)
        i, j = np.unravel_index(np.argmin(delta), delta.shape)
        if delta[i, j] >= -1e-12:
            break
        assign[i] = j
    cost = objective(inst, assign)
    return HFLOPSolution(assign, cost, optimal=False,
                         solver=sol.solver + "+ls",
                         wall_time_s=sol.wall_time_s
                         + wall_clock() - t0)


def _batch_moves(inst: HFLOPInstance, assign: np.ndarray,
                 max_passes: int = 6) -> np.ndarray:
    """Bulk relocation accelerator for ``local_search``: commit *every*
    device's best improving move onto an already-open destination in one
    pass (destination capacities validated cumulatively in delta order).
    Each committed move's true saving is at least its computed delta —
    source-edge closures only add savings — so the objective strictly
    decreases; the single-move ``local_search`` afterwards keeps the
    classic best-improvement semantics for open/close moves."""
    n, m = inst.n, inst.m
    for _ in range(max_passes):
        ok = assign >= 0
        if not ok.any():
            break
        load = np.zeros(m)
        np.add.at(load, assign[ok], inst.lam[ok])
        opened = np.bincount(assign[ok], minlength=m) > 0
        cur = np.where(ok, inst.c_d[np.arange(n),
                                    np.clip(assign, 0, m - 1)],
                       0.0) * inst.l
        delta = inst.c_d * inst.l - cur[:, None]
        feas = ((load[None, :] + inst.lam[:, None]
                 <= inst.r[None, :] + 1e-12) & opened[None, :])
        same = np.zeros((n, m), bool)
        same[np.arange(n)[ok], assign[ok]] = True
        delta = np.where(feas & ~same, delta, np.inf)
        best_j = np.argmin(delta, axis=1)
        best_d = delta[np.arange(n), best_j]
        movers = np.nonzero(ok & (best_d < -1e-12))[0]
        if movers.size == 0:
            break
        ordm = movers[np.argsort(best_d[movers], kind="stable")]
        dest = best_j[ordm]
        w = inst.lam[ordm]
        srt = np.argsort(dest, kind="stable")
        ds, ws = dest[srt], w[srt]
        cw = np.cumsum(ws)
        first = np.searchsorted(ds, ds, side="left")
        run = load[ds] + (cw - (cw[first] - ws[first]))
        acc = srt[run <= inst.r[ds] + 1e-12]   # per-dest prefix (run grows)
        if acc.size == 0:
            break
        assign[ordm[acc]] = best_j[ordm[acc]]
    return assign


def _ejection_pass(inst: HFLOPInstance, assign: np.ndarray,
                   tries_per_edge: int = 4, max_rounds: int = 20,
                   cap_wait: int = 128) -> np.ndarray:
    """Ejection-chain neighborhood the single-move search cannot reach:
    evict one heavy member of an edge (a non-improving move on its own)
    to admit several waiting devices with positive savings into the
    freed capacity.  This is what closes the paper-cost gap — the
    optimum evicts one large-lam device from a full LAN edge so many
    small devices can come home, a length-k chain invisible to
    relocation/swap moves.  Commits only strictly improving chains."""
    n, m = inst.n, inst.m
    l = inst.l
    for _ in range(max_rounds):
        ok = assign >= 0
        load = np.zeros(m)
        np.add.at(load, assign[ok], inst.lam[ok])
        cur = np.where(ok, inst.c_d[np.arange(n),
                                    np.clip(assign, 0, m - 1)], 0.0) * l
        improved = False
        for j in range(m):
            sav = cur - inst.c_d[:, j] * l
            wait = np.nonzero(ok & (assign != j) & (sav > 1e-12))[0]
            if wait.size == 0:
                continue
            wait = wait[np.argsort(-sav[wait], kind="stable")][:cap_wait]
            members = np.nonzero(assign == j)[0]
            opened = np.bincount(assign[ok], minlength=m) > 0
            options = [(-1, 0.0, -1)]
            for e in members[np.argsort(-inst.lam[members])][:tries_per_edge]:
                feas = (load + inst.lam[e] <= inst.r + 1e-12) & opened
                feas[j] = False
                c = np.where(feas, inst.c_d[e] * l, np.inf)
                jp = int(np.argmin(c))
                if np.isfinite(c[jp]):
                    options.append((int(e),
                                    (inst.c_d[e, jp] - inst.c_d[e, j]) * l,
                                    jp))
            best = None
            for e, cost0, jp in options:
                room = inst.r[j] - load[j] + (inst.lam[e] if e >= 0 else 0.0)
                gain = -cost0
                admitted = []
                for k in wait:
                    if k != e and inst.lam[k] <= room + 1e-12:
                        room -= inst.lam[k]
                        gain += sav[k]
                        admitted.append(k)
                if admitted and gain > 1e-12 and (best is None
                                                 or gain > best[0]):
                    best = (gain, e, jp, admitted)
            if best is not None:
                _, e, jp, admitted = best
                if e >= 0:
                    load[assign[e]] -= inst.lam[e]
                    assign[e] = jp
                    load[jp] += inst.lam[e]
                for k in admitted:
                    load[assign[k]] -= inst.lam[k]
                    assign[k] = j
                    load[j] += inst.lam[k]
                cur = np.where(assign >= 0,
                               inst.c_d[np.arange(n),
                                        np.clip(assign, 0, m - 1)],
                               0.0) * l
                improved = True
        if not improved:
            break
    return assign


def _multi_construct(inst: AnyInstance) -> np.ndarray:
    """Greedy construction from several insertion orders (heavy-first,
    light-first, regret-first for dense costs), each followed by the
    close pass; keeps the candidate with the most devices placed, then
    the lowest cost.  Light-first matters for LAN-style costs: inserting
    heavy consumers first evicts many small devices from their free
    edge, where evicting one heavy device would have been cheaper."""
    orders = [np.argsort(-inst.lam), np.argsort(inst.lam)]
    if not isinstance(inst, LanHFLOPInstance) and inst.m >= 2:
        two = np.partition(inst.c_d, 1, axis=1)
        orders.append(np.argsort(-(two[:, 1] - two[:, 0])))
    n, m = inst.n, inst.m
    rows = _cost_rows_fn(inst)
    best = None
    for order in orders:
        assign = np.full(n, -1, int)
        load = np.zeros(m)
        opened = np.zeros(m, bool)
        _greedy_insert(rows, order, inst.lam, inst.r, inst.c_e, inst.l,
                       load, opened, assign)
        _close_edges(rows, inst.lam, inst.r, inst.c_e, inst.l, m,
                     assign, load, opened)
        key = (int(np.sum(assign >= 0)), -_objective_any(inst, assign))
        if best is None or key > best[0]:
            best = (key, assign)
    return best[1]


def solve_heuristic(inst: HFLOPInstance) -> HFLOPSolution:
    return local_search(inst, solve_greedy(inst))


# ---------------------------------------------------------------------------
# hierarchically decomposed solver (continuum scale)
# ---------------------------------------------------------------------------

def solve_decomposed(inst: AnyInstance, regions: Optional[int] = None,
                     ls_iters: int = 200, batch_passes: int = 6,
                     polish_cells: int = 4_000_000,
                     telemetry: Optional[Telemetry] = None,
                     ) -> HFLOPSolution:
    """Million-device HFLOP: partition the edge continuum into regions
    (LAN-balanced for structured instances, k-medoids on cost columns
    otherwise), solve each region as an independent dense capacitated
    sub-problem (vectorized greedy + bulk-move + local search), then
    stitch: globally repair devices their region could not place (they
    may cross region boundaries, re-opening edges), trim to T, and
    polish (full local search when the dense matrix fits
    ``polish_cells``; LAN-reclaim passes at larger scale).

    Returns a standard :class:`HFLOPSolution` with per-phase wall times,
    region stats and a cheap lower bound in ``sol.meta``.

    Phases are timed as tracer wall spans (``solve_decomposed.partition``
    / ``.subsolve`` / ``.stitch`` / ``.polish``): pass ``telemetry`` to
    collect them alongside everything else it records; without one a
    throwaway local tracer provides the same timing.  ``meta["phase_s"]``
    is a thin compatibility view of those spans' durations.
    """
    t0 = wall_clock()
    n, m = inst.n, inst.m
    lan = isinstance(inst, LanHFLOPInstance)
    tel = _maybe_tel(telemetry)
    tr = tel.tracer if tel is not None else SpanTracer()

    with tr.wall("solve_decomposed.partition", cat="solver") as sp_part:
        part = partition_instance(inst, regions=regions)

    with tr.wall("solve_decomposed.subsolve", cat="solver",
                 regions=int(part.n_regions)) as sp_sub:
        assign = np.full(n, -1, np.int64)
        for reg in range(part.n_regions):
            dev = part.devices_in(reg)
            if dev.size == 0:
                continue
            edg = part.edges_in(reg)
            if edg.size == 0:
                continue                  # stitch pass will repair these
            sub = sub_instance(inst, dev, edg)
            a = _multi_construct(sub)
            ach = int(np.sum(a >= 0))
            if ach < sub.T:               # region can't host everyone:
                sub = HFLOPInstance(sub.c_d, sub.c_e, sub.lam, sub.r,
                                    l=sub.l, T=ach)
            a = _polish_dense(sub, a, ls_iters, batch_passes)
            keep = a >= 0
            assign[dev[keep]] = edg[a[keep]]

    # stitch: boundary repair — leftover devices go wherever capacity
    # remains, cheapest (open-cost-amortized) edge first, across regions
    with tr.wall("solve_decomposed.stitch", cat="solver") as sp_stitch:
        ok = assign >= 0
        load = np.bincount(assign[ok], weights=inst.lam[ok], minlength=m)
        opened = np.bincount(assign[ok], minlength=m) > 0
        left = np.nonzero(~ok)[0]
        repaired = 0
        if left.size:
            before = int(ok.sum())
            order = left[np.argsort(-inst.lam[left])]
            _greedy_insert(_cost_rows_fn(inst), order, inst.lam, inst.r,
                           inst.c_e, inst.l, load, opened, assign)
            repaired = int(np.sum(assign >= 0)) - before
        surplus = int(np.sum(assign >= 0)) - inst.T
        if surplus > 0:                   # same trimming rule as greedy
            local = _local_costs_any(inst, assign)
            ordt = np.argsort(-local)
            drop = ordt[:min(surplus, int(np.sum(local > 0)))]
            np.subtract.at(load, assign[drop], inst.lam[drop])
            assign[drop] = -1
        # cross-region merge: regions solve in isolation, so the union
        # can hold redundant open edges near boundaries — the global
        # close pass drains and merges them wherever relocation beats
        # the open cost
        ok = assign >= 0
        load = np.bincount(assign[ok], weights=inst.lam[ok], minlength=m)
        opened = np.bincount(assign[ok], minlength=m) > 0
        _close_edges(_cost_rows_fn(inst), inst.lam, inst.r, inst.c_e,
                     inst.l, m, assign, load, opened)

    with tr.wall("solve_decomposed.polish", cat="solver") as sp_polish:
        if n * m <= polish_cells:
            dense = inst.to_dense() if lan else inst
            assign = _polish_dense(dense, assign.copy(), ls_iters,
                                   batch_passes)
            # small instances afford a second basin: a *global*
            # construction polished the same way; keep whichever places
            # more devices at lower cost (guards the optimality gap
            # where a region split is the wrong structure)
            alt = _polish_dense(dense, _multi_construct(dense),
                                ls_iters, batch_passes)
            if ((int(np.sum(alt >= 0)), -objective(dense, alt))
                    > (int(np.sum(assign >= 0)),
                       -objective(dense, assign))):
                assign = alt
        elif lan:
            assign = _lan_reclaim(inst, assign)

    # thin compatibility view of the tracer spans (one source of truth)
    phases = {"partition_s": sp_part.dur, "subsolve_s": sp_sub.dur,
              "stitch_s": sp_stitch.dur, "polish_s": sp_polish.dur}
    feasible = int(np.sum(assign >= 0)) >= inst.T
    cost = _objective_any(inst, assign) if feasible else np.inf
    lb = _lower_bound(inst)
    meta = {"phase_s": phases,
            "regions": int(part.n_regions),
            "partition_method": part.method,
            "repaired": int(repaired),
            "lower_bound": float(lb),
            "gap_vs_lb": (float(cost / lb - 1.0)
                          if lb > 0 and np.isfinite(cost)
                          else float("nan"))}
    return HFLOPSolution(assign, cost, optimal=False, solver="decomposed",
                         wall_time_s=wall_clock() - t0, meta=meta)


def _polish_dense(dense: HFLOPInstance, assign: np.ndarray,
                  ls_iters: int, batch_passes: int) -> np.ndarray:
    """Dense improvement stack: bulk moves, best-improvement local
    search, ejection chains, local search again."""
    a = _batch_moves(dense, assign, max_passes=batch_passes)
    s = local_search(dense, HFLOPSolution(a, objective(dense, a),
                                          solver="decomposed"),
                     max_iters=ls_iters)
    a = _ejection_pass(dense, s.assign)
    s = local_search(dense, HFLOPSolution(a, objective(dense, a),
                                          solver="decomposed"),
                     max_iters=ls_iters)
    return s.assign


def _lan_reclaim(inst: LanHFLOPInstance, assign: np.ndarray,
                 passes: int = 3) -> np.ndarray:
    """Continuum-scale polish for structured instances: pull cross-LAN
    devices back to their zero-cost home edge wherever slack allows
    (lightest devices first per edge maximizes the count).  Moves onto
    open homes always save ``l * unit_cost``; closed homes are only
    re-opened when the saving exceeds the open cost.  Each pass frees
    capacity on source edges, so iterate a few times."""
    for _ in range(passes):
        ok = assign >= 0
        load = np.bincount(assign[ok], weights=inst.lam[ok],
                           minlength=inst.m)
        opened = np.bincount(assign[ok], minlength=inst.m) > 0
        home = np.clip(inst.free, 0, inst.m - 1)
        allowed = opened[home] | (inst.l * inst.unit_cost > inst.c_e[home])
        cand = np.nonzero(ok & (inst.free >= 0) & (assign != inst.free)
                          & allowed)[0]
        if cand.size == 0:
            break
        h = inst.free[cand]
        w = inst.lam[cand]
        srt = np.lexsort((w, h))                  # per home, lightest first
        hs, ws = h[srt], w[srt]
        cw = np.cumsum(ws)
        first = np.searchsorted(hs, hs, side="left")
        run = load[hs] + (cw - (cw[first] - ws[first]))
        acc = srt[run <= inst.r[hs] + 1e-12]      # per-home prefix
        if acc.size == 0:
            break
        assign[cand[acc]] = inst.free[cand[acc]]
    return assign


def _lower_bound(inst: AnyInstance) -> float:
    """Cheap combinatorial lower bound: the T cheapest per-device local
    costs plus the cheapest set of edges large enough (by max capacity)
    to host the T lightest devices."""
    if inst.T <= 0:
        return 0.0
    if isinstance(inst, LanHFLOPInstance):
        cheap = np.where(inst.free >= 0, 0.0, inst.unit_cost)
    else:
        cheap = inst.c_d.min(axis=1)
    local_lb = float(np.sort(cheap)[:inst.T].sum()) * inst.l
    lam_t = np.sort(inst.lam)[:inst.T]
    rmax = float(np.max(inst.r))
    min_edges = max(1, int(np.ceil(lam_t.sum() / rmax))) if rmax > 0 else 1
    open_lb = float(np.sort(inst.c_e)[:min_edges].sum())
    return local_lb + open_lb


# ---------------------------------------------------------------------------
# exact: LP-relaxation branch & bound
# ---------------------------------------------------------------------------

def _round_lp(inst: HFLOPInstance, xfrac: np.ndarray) -> Optional[np.ndarray]:
    """Rounding heuristic fed to the B&B: assign each device to its
    largest-x edge if capacity admits (greedy by fractional mass).
    Chunk-speculated like ``_greedy_insert``; per-row preference order
    comes from one row-wise argsort turned into a rank matrix, so the
    batch pick (min-rank feasible candidate) matches the sequential
    scan exactly."""
    n, m = inst.n, inst.m
    xm = xfrac[:n * m].reshape(n, m)
    assign = np.full(n, -1, int)
    load = np.zeros(m)
    order = np.argsort(-np.max(xm, axis=1))
    pref = np.argsort(-xm, axis=1)
    rank = np.empty((n, m), np.int64)
    np.put_along_axis(rank, pref, np.arange(m)[None, :], axis=1)
    mass = xm >= 1e-9
    cap = _chunk_cap(m)
    pos, chunk = 0, _CHUNK0
    while pos < n:
        ids = order[pos:pos + chunk]
        feas = (load[None, :] + inst.lam[ids][:, None]
                <= inst.r[None, :] + 1e-12)
        R = np.where(feas & mass[ids], rank[ids], m)
        picks = np.argmin(R, axis=1)
        okm = R[np.arange(ids.size), picks] < m
        cut, guard = _capacity_limit(picks, okm, inst.lam[ids],
                                     load, inst.r)
        if guard:                                 # scalar replay, verbatim
            for k in range(ids.size):
                i = ids[k]
                for j in np.argsort(-xm[i]):
                    if xm[i, j] < 1e-9:
                        break
                    if load[j] + inst.lam[i] <= inst.r[j] + 1e-12:
                        assign[i] = j
                        load[j] += inst.lam[i]
                        break
            pos += ids.size
            chunk = _CHUNK0
            continue
        com = okm[:cut]
        ci = ids[:cut][com]
        cp = picks[:cut][com]
        assign[ci] = cp
        np.add.at(load, cp, inst.lam[ci])
        good = cut == ids.size
        pos += cut
        chunk = min(chunk * 4, cap) if good else _CHUNK0
    if int(np.sum(assign >= 0)) < inst.T:
        return None
    v = np.zeros(n * m + m)
    okv = assign >= 0
    v[np.arange(n)[okv] * m + assign[okv]] = 1.0
    v[n * m + np.unique(assign[okv])] = 1.0
    return v


def solve_bnb(inst: HFLOPInstance, time_limit_s: float = 600.0,
              max_nodes: int = 200_000) -> HFLOPSolution:
    t0 = wall_clock()
    ilp = build_ilp(inst)
    warm = solve_heuristic(inst)
    inc = None
    if np.isfinite(warm.cost):
        inc = np.zeros(ilp.c.shape[0])
        for i in range(inst.n):
            if warm.assign[i] >= 0:
                inc[ilp.x_index(i, warm.assign[i])] = 1.0
        for j in np.unique(warm.assign[warm.assign >= 0]):
            inc[ilp.y_index(j)] = 1.0
    prio = np.zeros(ilp.c.shape[0])
    prio[inst.n * inst.m:] = 1.0                      # branch y first
    res = solve_milp(ilp.c, ilp.A, ilp.b, incumbent_x=inc,
                     branch_priority=prio,
                     rounding=lambda xf: _round_lp(inst, xf),
                     max_nodes=max_nodes, time_limit_s=time_limit_s)
    if res.x is None:
        return HFLOPSolution(np.full(inst.n, -1), np.inf, optimal=False,
                             solver="bnb", nodes_explored=res.nodes,
                             wall_time_s=wall_clock() - t0)
    xm = res.x[:inst.n * inst.m].reshape(inst.n, inst.m)
    assign = np.where(xm.max(axis=1) > 0.5, np.argmax(xm, axis=1), -1)
    return HFLOPSolution(assign, objective(inst, assign),
                         optimal=res.status == "optimal", solver="bnb",
                         nodes_explored=res.nodes,
                         wall_time_s=wall_clock() - t0)


# ---------------------------------------------------------------------------
# uncapacitated variant (paper Fig. 9 lower bound)
# ---------------------------------------------------------------------------

def solve_uncapacitated(inst: HFLOPInstance,
                        exact: bool = False) -> HFLOPSolution:
    """With r_j = inf the problem is classic UFL.  Greedy+LS by default;
    ``exact=True`` routes through the B&B."""
    un = inst.uncapacitated()
    if exact:
        sol = solve_bnb(un)
    else:
        sol = solve_heuristic(un)
    sol.solver = "uncap-" + sol.solver
    return sol
