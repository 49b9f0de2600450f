"""Decision audit log for the orchestration control loop.

Every orchestration action taken (or declined) by `ReactiveLoop` /
`LearningController` / `CoSim.apply_deployment` records *why*: the
trigger that fired (drift alarm, windowed-p95 breach, NODE_FAILURE,
unreliable-device mark, ...), the evidence values behind it (measured
p95 vs threshold, drift MSE, dropped-epoch counts), the budget charge,
and the outcome:

- ``applied``  — the action went through (budget charged if metered)
- ``forced``   — applied despite an exhausted budget (visible overrun)
- ``deferred`` — the loop wanted to act but the budget said no
- ``vetoed``   — `apply_deployment` itself refused the charge
- ``noted``    — an observation that informed later decisions
                 (failure seen, straggler drops, device move)

The audit log is additive observation only: it never mutates the
`actions` list, the budget ledger, or any simulation state, so control
fingerprints stay bit-identical with auditing on or off.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

OUTCOMES = ("applied", "forced", "deferred", "vetoed", "noted")


@dataclass(frozen=True)
class AuditRecord:
    t: float
    action: str
    trigger: str
    outcome: str
    evidence: Mapping[str, object] = field(default_factory=dict)
    cost: float = 0.0
    charged: bool = False
    forced: bool = False

    def as_dict(self) -> Dict[str, object]:
        return {"t": self.t, "action": self.action,
                "trigger": self.trigger, "outcome": self.outcome,
                "evidence": dict(self.evidence), "cost": self.cost,
                "charged": self.charged, "forced": self.forced}


class DecisionAudit:
    def __init__(self) -> None:
        self.records: List[AuditRecord] = []

    def record(self, t: float, action: str, trigger: str, outcome: str,
               evidence: Optional[Mapping[str, object]] = None,
               cost: float = 0.0, charged: bool = False,
               forced: bool = False) -> AuditRecord:
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown outcome {outcome!r}; "
                             f"expected one of {OUTCOMES}")
        rec = AuditRecord(t=float(t), action=action, trigger=trigger,
                          outcome=outcome, evidence=dict(evidence or {}),
                          cost=float(cost), charged=charged,
                          forced=forced)
        self.records.append(rec)
        return rec

    def by_action(self, action: str) -> List[AuditRecord]:
        return [r for r in self.records if r.action == action]

    def by_outcome(self, outcome: str) -> List[AuditRecord]:
        return [r for r in self.records if r.outcome == outcome]

    def counts(self) -> Dict[str, int]:
        """Record count per outcome (zero-filled over OUTCOMES)."""
        out = {o: 0 for o in OUTCOMES}
        for r in self.records:
            out[r.outcome] += 1
        return out

    def as_dicts(self) -> List[Dict[str, object]]:
        return [r.as_dict() for r in self.records]

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r.as_dict()) + "\n")

    def __len__(self) -> int:
        return len(self.records)
