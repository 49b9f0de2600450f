"""Device-population partitioning for the hierarchically decomposed
HFLOP solver (``repro.core.solvers.solve_decomposed``).

The decomposition follows the client–edge–cloud structure of HFL
(Liu et al., arXiv:1905.06641) and heterogeneity-aware topology design
(Gao et al., arXiv:2409.19509): the *edge set* is partitioned into
regions, every device is attached to the region of its cheapest edge
(its LAN host in the paper's cost model), each region is solved as an
independent capacitated sub-problem, and a stitch pass repairs the
boundary.  Two partitioners:

  * **LAN grouping** — for the paper's cost structure (each device has
    one zero-cost edge, every other edge costs ``unit_cost``), edges
    are interchangeable beyond their home load, so regions are built by
    balanced-load grouping of edges (largest home load first, into the
    currently lightest region);
  * **k-medoids on cost columns** — for generic instances, edges are
    clustered by the similarity of their ``c_d`` column over a
    deterministic device sample, so edges that look alike to the
    device population land in the same region.

The module also carries :class:`LanHFLOPInstance` — an *implicit*
representation of the paper's Fig. 9 cost structure that never
materializes the dense ``(n, m)`` cost matrix.  At n = 10^6 devices x
m = 10^3 edges the dense matrix is 8 GB; the structured form is three
1-D arrays, and the decomposed solver only densifies per-region
``(n_r, m_r)`` blocks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np

from repro_torch.core.hflop import HFLOPInstance


# ---------------------------------------------------------------------------
# structured (LAN) instance — the paper cost model without the dense matrix
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LanHFLOPInstance:
    """The Fig. 9 cost structure in implicit form: device i costs 0 at
    its LAN edge ``free[i]`` (-1 = no LAN edge) and ``unit_cost`` at
    every other edge.  Semantically identical to the dense
    ``paper_cost_instance`` (``to_dense`` round-trips exactly) but O(n)
    memory, so million-device instances fit."""
    free: np.ndarray                 # (n,) int64, zero-cost edge or -1
    c_e: np.ndarray                  # (m,) edge open costs
    lam: np.ndarray                  # (n,) device request rates
    r: np.ndarray                    # (m,) edge serving capacities
    unit_cost: float = 1.0
    l: int = 2
    T: Optional[int] = None          # min participating devices (None -> n)

    def __post_init__(self):
        object.__setattr__(self, "free", np.asarray(self.free, np.int64))
        object.__setattr__(self, "c_e", np.asarray(self.c_e, np.float64))
        object.__setattr__(self, "lam", np.asarray(self.lam, np.float64))
        object.__setattr__(self, "r", np.asarray(self.r, np.float64))
        if self.T is None:
            object.__setattr__(self, "T", self.n)

    @property
    def n(self) -> int:
        return self.free.shape[0]

    @property
    def m(self) -> int:
        return self.c_e.shape[0]

    def cost_rows(self, ids: np.ndarray) -> np.ndarray:
        """Dense ``c_d`` rows for a batch of devices — the only shape
        the vectorized solvers ever need."""
        ids = np.asarray(ids)
        rows = np.full((ids.size, self.m), self.unit_cost)
        has = self.free[ids] >= 0
        rows[np.nonzero(has)[0], self.free[ids][has]] = 0.0
        return rows

    def local_costs(self, assign: np.ndarray) -> np.ndarray:
        """Per-device local cost of an assignment (0 on the LAN edge,
        ``unit_cost`` elsewhere; unassigned devices cost 0)."""
        assign = np.asarray(assign)
        ok = assign >= 0
        return np.where(ok & (assign != self.free),
                        self.unit_cost, 0.0) * self.l

    def objective(self, assign: np.ndarray) -> float:
        assign = np.asarray(assign)
        ok = assign >= 0
        local = float(np.sum(self.local_costs(assign)))
        open_edges = np.unique(assign[ok])
        return local + float(np.sum(self.c_e[open_edges]))

    def violations(self, assign: np.ndarray) -> List[str]:
        out = []
        assign = np.asarray(assign)
        if assign.shape != (self.n,):
            return [f"assign shape {assign.shape} != ({self.n},)"]
        if np.any(assign >= self.m):
            out.append("assignment to nonexistent edge")
        participating = int(np.sum(assign >= 0))
        if participating < self.T:
            out.append(f"participation {participating} < T={self.T}")
        valid = (assign >= 0) & (assign < self.m)
        loads = np.bincount(assign[valid], weights=self.lam[valid],
                            minlength=self.m)
        for j in np.nonzero(loads > self.r + 1e-9)[0]:
            out.append(f"edge {j}: load {loads[j]:.3f} > "
                       f"r={self.r[j]:.3f}")
        return out

    def is_feasible(self, assign: np.ndarray) -> bool:
        return not self.violations(assign)

    def to_dense(self) -> HFLOPInstance:
        """Materialize the dense instance (small n only — 8 GB at
        n=10^6, m=10^3)."""
        c_d = np.full((self.n, self.m), self.unit_cost)
        has = self.free >= 0
        c_d[np.nonzero(has)[0], self.free[has]] = 0.0
        return HFLOPInstance(c_d, self.c_e, self.lam, self.r,
                             l=self.l, T=self.T)


def paper_cost_lan(n: int, m: int, seed: int = 0, l: int = 2,
                   capacity_slack: float = 1.5) -> LanHFLOPInstance:
    """The Fig. 9 setup in structured form.  Consumes the generator
    stream in exactly the order ``hflop.paper_cost_instance`` does, so
    ``paper_cost_lan(n, m, seed).to_dense()`` equals
    ``paper_cost_instance(n, m, seed)`` array-for-array (asserted in
    the tests) — the structured path is the *same* instance, just never
    materialized."""
    rng = np.random.default_rng(seed)
    free = rng.integers(0, m, n)
    lam = rng.uniform(0.1, 1.0, n)
    raw = rng.uniform(0.5, 1.5, m)
    r = raw / raw.sum() * lam.sum() * capacity_slack
    return LanHFLOPInstance(free=free, c_e=np.ones(m), lam=lam, r=r,
                            unit_cost=1.0, l=l, T=n)


AnyInstance = Union[HFLOPInstance, LanHFLOPInstance]


def sub_instance(inst: AnyInstance, devices: np.ndarray,
                 edges: np.ndarray, T: Optional[int] = None,
                 ) -> HFLOPInstance:
    """Dense region sub-problem: the (devices x edges) block of the
    cost structure with the region's own capacities."""
    devices = np.asarray(devices)
    edges = np.asarray(edges)
    if isinstance(inst, LanHFLOPInstance):
        c_d = np.full((devices.size, edges.size), inst.unit_cost)
        inv = np.full(inst.m, -1, np.int64)
        inv[edges] = np.arange(edges.size)
        loc = np.where(inst.free[devices] >= 0,
                       inv[np.clip(inst.free[devices], 0, inst.m - 1)], -1)
        has = loc >= 0
        c_d[np.nonzero(has)[0], loc[has]] = 0.0
    else:
        c_d = inst.c_d[np.ix_(devices, edges)]
    return HFLOPInstance(c_d, inst.c_e[edges], inst.lam[devices],
                         inst.r[edges], l=inst.l,
                         T=devices.size if T is None else T)


# ---------------------------------------------------------------------------
# partitioners
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Partition:
    """Region labels over edges and devices.  Devices always live in
    the region of their cheapest edge; region indices are dense
    ``0..n_regions-1``."""
    region_of_edge: np.ndarray       # (m,) int64
    region_of_device: np.ndarray     # (n,) int64
    n_regions: int
    method: str = ""

    def edges_in(self, region: int) -> np.ndarray:
        return np.nonzero(self.region_of_edge == region)[0]

    def devices_in(self, region: int) -> np.ndarray:
        return np.nonzero(self.region_of_device == region)[0]


def default_regions(n: int, m: int, target_edges: int = 16,
                    target_devices: int = 50_000) -> int:
    """Region count balancing sub-problem size: ~``target_edges`` edges
    and at most ~``target_devices`` devices per region."""
    return max(1, min(m, max(-(-m // target_edges),
                             -(-n // target_devices))))


def _balance_edges(weight: np.ndarray, k: int) -> np.ndarray:
    """Greedy balanced grouping: heaviest edge first, into the region
    with the least total weight so far (deterministic: stable sort,
    lowest-index region on ties)."""
    m = weight.shape[0]
    labels = np.empty(m, np.int64)
    totals = np.zeros(k)
    for j in np.argsort(-weight, kind="stable"):
        g = int(np.argmin(totals))
        labels[j] = g
        totals[g] += weight[j]
    return labels


def _kmedoids_edges(c_d: np.ndarray, k: int, sample_rows: int = 512,
                    iters: int = 8) -> np.ndarray:
    """Deterministic k-medoids over the columns of ``c_d``: edges whose
    cost columns look alike to (a sample of) the device population end
    up in the same region.  Farthest-point init from the most central
    column; a few alternation rounds of assign / medoid-update."""
    n, m = c_d.shape
    if k >= m:
        return np.arange(m, dtype=np.int64)
    rows = (c_d if n <= sample_rows
            else c_d[np.linspace(0, n - 1, sample_rows).astype(np.int64)])
    X = np.ascontiguousarray(rows.T)               # (m, s) edge profiles
    D = np.abs(X[:, None, :] - X[None, :, :]).mean(axis=2)
    med = [int(np.argmin(D.sum(axis=1)))]          # most central edge
    while len(med) < k:
        d_min = D[:, med].min(axis=1)
        d_min[med] = -np.inf
        med.append(int(np.argmax(d_min)))
    med = np.asarray(sorted(med), np.int64)
    labels = np.argmin(D[:, med], axis=1)
    for _ in range(iters):
        new_med = med.copy()
        for g in range(k):
            members = np.nonzero(labels == g)[0]
            if members.size == 0:
                continue
            within = D[np.ix_(members, members)].sum(axis=1)
            new_med[g] = int(members[np.argmin(within)])
        new_labels = np.argmin(D[:, new_med], axis=1)
        if np.array_equal(new_med, med) and np.array_equal(new_labels,
                                                          labels):
            break
        med, labels = new_med, new_labels
    # compact away empty regions
    used, labels = np.unique(labels, return_inverse=True)
    return labels.astype(np.int64)


def _device_home_edges(inst: AnyInstance, chunk: int = 65_536,
                       ) -> np.ndarray:
    """Cheapest edge per device (the LAN host under the paper cost
    model), computed in bounded-memory chunks for dense instances."""
    if isinstance(inst, LanHFLOPInstance):
        # devices without a LAN edge are indifferent: home them on edge 0
        return np.where(inst.free >= 0, inst.free, 0)
    n = inst.n
    out = np.empty(n, np.int64)
    for a in range(0, n, chunk):
        out[a:a + chunk] = np.argmin(inst.c_d[a:a + chunk], axis=1)
    return out


def partition_instance(inst: AnyInstance,
                       regions: Optional[int] = None) -> Partition:
    """Partition the continuum: group edges into ``regions`` regions
    (LAN-load balancing for structured instances, k-medoids on cost
    columns otherwise) and attach every device to the region of its
    cheapest edge."""
    n, m = inst.n, inst.m
    k = default_regions(n, m) if regions is None else int(regions)
    k = max(1, min(k, m))
    home = _device_home_edges(inst)
    if isinstance(inst, LanHFLOPInstance):
        weight = np.bincount(home, weights=inst.lam, minlength=m)
        region_of_edge = _balance_edges(weight, k)
        method = "lan-balanced"
    else:
        region_of_edge = _kmedoids_edges(inst.c_d, k)
        method = "kmedoids"
    region_of_device = region_of_edge[home]
    return Partition(region_of_edge=region_of_edge,
                     region_of_device=region_of_device,
                     n_regions=int(region_of_edge.max()) + 1,
                     method=method)
