"""Reconfiguration-budget accountant for the reactive loop.

HFL reconfiguration is not free: every re-clustered deployment pays a
migration window (``CoSimConfig.reconfig_s`` seconds of
``migration_share`` demand on every open edge plus a per-request
penalty), so reacting to every alarm can cost more than it recovers —
Čilić et al. (arXiv:2412.03385) ration reconfiguration under an explicit
communication/cost budget for exactly this reason.

:class:`ReconfigBudget` meters every ``CoSim.apply_deployment``: each
attempted deployment swap is charged its modeled migration cost
(``CoSim.reconfig_cost``, in edge-compute-seconds), and once the budget
is spent further swaps are vetoed — the ``ReactivePolicy`` then defers
optional reclusterings (latency derates, idle restores, mobility
reclusters) while, by default, still forcing through correctness-
critical ones (node-failure reclusters).  The ledger records every
charge and veto, so a run reports exactly what its reactions cost and
what they were denied.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass(frozen=True)
class BudgetEntry:
    """One metered ``apply_deployment`` attempt."""
    t: float
    reason: str
    cost: float
    applied: bool
    forced: bool = False


@dataclass
class ReconfigBudget:
    """Fixed reconfiguration allowance for one co-simulation run.

    ``total`` is in the same units as ``CoSim.reconfig_cost`` —
    edge-compute-seconds of modeled migration load.  ``math.inf``
    reproduces the unconstrained reactive loop while still keeping the
    ledger."""
    total: float = math.inf
    spent: float = 0.0
    ledger: List[BudgetEntry] = field(default_factory=list)
    #: optional per-charge callback (e.g. CoSim mirrors the ledger into
    #: telemetry registry metrics); pure observation — called after the
    #: entry is recorded, must not mutate the budget.  Excluded from
    #: equality/repr so budgets stay comparable.
    observer: Optional[Callable[[BudgetEntry], None]] = field(
        default=None, repr=False, compare=False)

    @property
    def remaining(self) -> float:
        return max(self.total - self.spent, 0.0)

    def can_afford(self, cost: float) -> bool:
        return float(cost) <= self.remaining + 1e-9

    def charge(self, t: float, cost: float, reason: str,
               forced: bool = False) -> bool:
        """Attempt to spend ``cost``.  Returns True (and records the
        spend) when affordable or ``forced``; False records a veto.
        Forced charges may drive ``spent`` past ``total`` — the overrun
        stays visible in the ledger."""
        ok = forced or self.can_afford(cost)
        entry = BudgetEntry(t=float(t), reason=str(reason),
                            cost=float(cost), applied=ok,
                            forced=bool(forced))
        self.ledger.append(entry)
        if ok:
            self.spent += float(cost)
        if self.observer is not None:
            self.observer(entry)
        return ok

    @property
    def reconfigs(self) -> int:
        return sum(1 for e in self.ledger if e.applied)

    @property
    def vetoes(self) -> int:
        return sum(1 for e in self.ledger if not e.applied)

    def summary(self) -> str:
        return (f"spent {self.spent:.1f}/{self.total:.1f} "
                f"({self.reconfigs} reconfigs, {self.vetoes} vetoed)")
