"""EVT001: every EventKind carries a window-fusion classification.

``repro_torch.sim.events.EVENT_EFFECTS`` tells the fused request-plane replay
which control events can invalidate an open occupancy window.  A kind
*missing* from the dict silently defaults to "mutates routing" at
dispatch — safe but forfeiting fusion — and, worse, a kind someone adds
for a new scenario without thinking about its request-plane contract is
exactly the case that corrupts fused replays.  This rule fails the
build until the author classifies the new kind explicitly.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.core import Finding, Project, Rule, dotted_name

# Port: the package name (repro/analysis/events_rules.py:18)
EVENTS_MODULE = "repro_torch.sim.events"


def _enum_members(cls: ast.ClassDef) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                if isinstance(target, ast.Name) and not \
                        target.id.startswith("_"):
                    out.append((target.id, stmt.lineno))
        elif isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name) and stmt.value is not None:
            if not stmt.target.id.startswith("_"):
                out.append((stmt.target.id, stmt.lineno))
    return out


class EventEffectsRule(Rule):
    """EVT001: EVENT_EFFECTS must cover EventKind exactly."""

    id = "EVT001"
    name = "event-effects-complete"
    description = ("every EventKind member needs an EVENT_EFFECTS "
                   "classification (and no stale keys), so window "
                   "fusion never guesses a new event's request-plane "
                   "contract")

    def check_project(self, project: Project) -> List[Finding]:
        path = project.module_path(EVENTS_MODULE)
        if path is None:
            return []           # fixture trees without a sim package
        ctx = project.context(path)
        kind_cls: Optional[ast.ClassDef] = None
        effects: Optional[ast.Dict] = None
        effects_line = 1
        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.ClassDef) and stmt.name == "EventKind":
                kind_cls = stmt
            target = None
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target = stmt.targets[0]
            elif isinstance(stmt, ast.AnnAssign):
                target = stmt.target
            if (isinstance(target, ast.Name)
                    and target.id == "EVENT_EFFECTS"
                    and isinstance(stmt.value, ast.Dict)):
                effects = stmt.value
                effects_line = stmt.lineno
        findings: List[Finding] = []
        if kind_cls is None:
            return [Finding(path=ctx.rel_path, line=1, rule=self.id,
                            message="EventKind class not found in "
                                    f"{EVENTS_MODULE}")]
        if effects is None:
            return [Finding(path=ctx.rel_path, line=1, rule=self.id,
                            message="EVENT_EFFECTS dict literal not "
                                    f"found in {EVENTS_MODULE}")]
        members = _enum_members(kind_cls)
        member_names = {name for name, _ in members}
        covered: Set[str] = set()
        for key in effects.keys:
            name = dotted_name(key) if key is not None else None
            if name is None or not name.startswith("EventKind."):
                findings.append(Finding(
                    path=ctx.rel_path, line=key.lineno if key else
                    effects_line, rule=self.id,
                    message="EVENT_EFFECTS key is not an EventKind "
                            "attribute"))
                continue
            member = name.split(".", 1)[1]
            if member not in member_names:
                findings.append(Finding(
                    path=ctx.rel_path,
                    line=key.lineno, rule=self.id,
                    message=f"EVENT_EFFECTS has stale key EventKind."
                            f"{member} (no such member)"))
            covered.add(member)
        for name, line in members:
            if name not in covered:
                findings.append(Finding(
                    path=ctx.rel_path, line=line, rule=self.id,
                    message=f"EventKind.{name} has no EVENT_EFFECTS "
                            f"classification; add it (and decide "
                            f"whether it mutates routing inputs)"))
        return findings
