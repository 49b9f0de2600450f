"""Telemetry non-perturbation rules.

The observability layer's core promise (see ``repro_torch.telemetry``):
enabling tracing/metrics/audit changes *nothing* about the simulated
system — control fingerprints are bit-identical with telemetry on or
off, and disabled mode costs one is-None branch.  Two rules keep that
promise honest:

- TEL001: telemetry code never perturbs the simulation.  Inside
  ``repro_torch.telemetry`` itself and inside ``if self._tel is not None:``
  guarded blocks anywhere, no RNG draws, no event scheduling
  (``.schedule()`` / ``heappush``), and — in guarded blocks — no
  mutation of non-telemetry state the surrounding code can observe.
- TEL002: instrumented classes resolve the telemetry facade once at
  construction (``self._tel = maybe(telemetry)``), never per call in
  hot paths — ``maybe()`` in a loop or a non-init method is a finding.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.core import (FileContext, Finding, Rule, dotted_name)

#: np.random.Generator draw methods (the explicit-stream idiom means the
#: receiver is conventionally named ``rng``/``_rng``)
RNG_DRAW_METHODS = {
    "random", "normal", "standard_normal", "uniform", "integers",
    "choice", "shuffle", "permutation", "exponential", "poisson",
    "binomial", "gamma", "beta", "lognormal", "geometric",
}

#: attribute components that mark a chain as telemetry-owned state
TEL_COMPONENTS = {"tel", "_tel", "tracer", "metrics", "audit",
                  "telemetry"}

#: list/set/dict methods that mutate their receiver
MUTATING_METHODS = {"append", "add", "extend", "insert", "update", "pop",
                    "remove", "clear", "setdefault", "discard",
                    "popleft", "appendleft"}


def _chain_parts(node: ast.AST) -> List[str]:
    name = dotted_name(node)
    return name.split(".") if name else []


def _is_tel_chain(node: ast.AST, tel_locals: Set[str]) -> bool:
    parts = _chain_parts(node)
    if not parts:
        return False
    if parts[0] in tel_locals:
        return True
    return any(p in TEL_COMPONENTS for p in parts)


def _derives_from_tel(node: ast.AST, tel_locals: Set[str]) -> bool:
    """Whether an expression's value flows out of the telemetry facade
    (``self._tel.metrics``, ``m.counter(...)`` with tel-derived ``m``)."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Attribute, ast.Name)):
            if _is_tel_chain(sub, tel_locals):
                return True
    return False


def _guard_is_tel_check(test: ast.expr) -> bool:
    """``<chain ending in tel/_tel> is not None`` — possibly one clause
    of an ``and`` chain, possibly a bare truthiness test on the chain."""
    clauses = (test.values if isinstance(test, ast.BoolOp)
               and isinstance(test.op, ast.And) else [test])
    for clause in clauses:
        target: Optional[ast.expr] = None
        if (isinstance(clause, ast.Compare)
                and len(clause.ops) == 1
                and isinstance(clause.ops[0], ast.IsNot)
                and isinstance(clause.comparators[0], ast.Constant)
                and clause.comparators[0].value is None):
            target = clause.left
        elif isinstance(clause, (ast.Attribute, ast.Name)):
            target = clause
        if target is not None:
            parts = _chain_parts(target)
            if parts and parts[-1] in ("tel", "_tel", "telemetry"):
                return True
    return False


class _RegionChecker:
    """Shared deny-list walk over one telemetry-only region."""

    def __init__(self, ctx: FileContext, rule_id: str,
                 check_mutations: bool):
        self.ctx = ctx
        self.rule_id = rule_id
        self.check_mutations = check_mutations
        self.findings: List[Finding] = []
        # plain-name locals assigned inside the region (scratch state the
        # outside can't observe) and the subset derived from telemetry
        self.block_locals: Set[str] = set()
        self.tel_locals: Set[str] = set()

    def _emit(self, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            path=self.ctx.rel_path, line=node.lineno, rule=self.rule_id,
            message=message))

    def check_stmts(self, stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            self._check_stmt(stmt)

    def _check_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.With):
            # `with self._tel.tracer.wall("x"): <timed work>` — the body
            # is the *measured* code, not telemetry code; the span
            # context manager wraps work that runs either way
            if any(_derives_from_tel(item.context_expr, self.tel_locals)
                   for item in stmt.items):
                return
            self._check_exprs_in(stmt)
            self.check_stmts(stmt.body)
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            self._check_assign(stmt)
            if stmt.value is not None:
                self._check_exprs(stmt.value)
            return
        self._check_exprs_in(stmt)
        for attr in ("body", "orelse", "finalbody"):
            self.check_stmts(getattr(stmt, attr, []) or [])
        for handler in getattr(stmt, "handlers", []) or []:
            self.check_stmts(handler.body)

    def _check_assign(self, stmt: ast.stmt) -> None:
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        value = stmt.value
        tel_value = value is not None and _derives_from_tel(
            value, self.tel_locals)
        for target in targets:
            if isinstance(target, ast.Name):
                self.block_locals.add(target.id)
                if tel_value:
                    self.tel_locals.add(target.id)
            elif isinstance(target, ast.Tuple):
                for elt in target.elts:
                    if isinstance(elt, ast.Name):
                        self.block_locals.add(elt.id)
            elif (self.check_mutations
                  and isinstance(target, (ast.Attribute, ast.Subscript))):
                base = (target.value if isinstance(target, ast.Subscript)
                        else target)
                parts = _chain_parts(base)
                root_local = bool(parts) and parts[0] in self.block_locals
                if (not _is_tel_chain(base, self.tel_locals)
                        and not root_local and not tel_value):
                    name = dotted_name(base) or "<expr>"
                    self._emit(target,
                               f"telemetry-guarded block mutates "
                               f"non-telemetry state {name!r}")

    def _check_exprs_in(self, stmt: ast.stmt) -> None:
        for field_value in ast.iter_fields(stmt):
            value = field_value[1]
            if isinstance(value, ast.expr):
                self._check_exprs(value)
            elif isinstance(value, list):
                for item in value:
                    if isinstance(item, ast.expr):
                        self._check_exprs(item)

    def _check_exprs(self, expr: ast.expr) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = dotted_name(func) or ""
            parts = name.split(".")
            last = parts[-1] if parts else ""
            if last == "schedule":
                self._emit(node, "telemetry code schedules a simulation "
                                 "event (.schedule call)")
            elif last in ("heappush", "heappop", "heapreplace",
                          "heappushpop"):
                self._emit(node, f"telemetry code touches an event heap "
                                 f"({last})")
            elif (last in RNG_DRAW_METHODS and len(parts) >= 2
                  and ("rng" in parts[-2] or "random" in parts[-2])):
                self._emit(node, f"telemetry code draws randomness "
                                 f"({name}); RNG streams must be "
                                 f"untouched by observability")
            elif (self.check_mutations and last in MUTATING_METHODS
                  and isinstance(func, ast.Attribute)):
                base_parts = _chain_parts(func.value)
                root_local = (bool(base_parts)
                              and base_parts[0] in self.block_locals)
                if (base_parts and not root_local
                        and not _is_tel_chain(func.value,
                                              self.tel_locals)):
                    recv = dotted_name(func.value) or "<expr>"
                    self._emit(node,
                               f"telemetry-guarded block mutates "
                               f"non-telemetry state via "
                               f"{recv}.{last}()")


class NonPerturbationRule(Rule):
    """TEL001: telemetry never perturbs simulation state."""

    id = "TEL001"
    name = "telemetry-non-perturbation"
    description = ("repro_torch.telemetry and `if self._tel is not None:` "
                   "blocks must not draw RNG, schedule events, or "
                   "mutate non-telemetry state")

    def check_file(self, ctx: FileContext) -> List[Finding]:
        # Port: the package name (repro/analysis/telemetry_rules.py:217-221)
        if ctx.module is None or not ctx.module.startswith("repro_torch"):
            return []
        findings: List[Finding] = []
        if (ctx.module == "repro_torch.telemetry"
                or ctx.module.startswith("repro_torch.telemetry.")):
            checker = _RegionChecker(ctx, self.id, check_mutations=False)
            checker.check_stmts(ctx.tree.body)
            findings.extend(checker.findings)
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    mods = ([a.name for a in node.names]
                            if isinstance(node, ast.Import)
                            else [node.module or ""])
                    if "random" in mods:
                        findings.append(Finding(
                            path=ctx.rel_path, line=node.lineno,
                            rule=self.id,
                            message="telemetry module imports stdlib "
                                    "random"))
        else:
            for node in ast.walk(ctx.tree):
                if (isinstance(node, ast.If)
                        and _guard_is_tel_check(node.test)):
                    checker = _RegionChecker(ctx, self.id,
                                             check_mutations=True)
                    checker.check_stmts(node.body)
                    findings.extend(checker.findings)
        return findings


class TelemetryBindOnceRule(Rule):
    """TEL002: resolve the telemetry facade once, at construction."""

    id = "TEL002"
    name = "telemetry-bind-once"
    description = ("maybe()/_maybe_tel() must run at construction "
                   "(__init__/__post_init__/bind) or module-function "
                   "scope, never inside loops or per-call methods")

    ALLOWED_METHODS = {"__init__", "__post_init__", "bind", "attach"}

    def check_file(self, ctx: FileContext) -> List[Finding]:
        # Port: the package name (repro/analysis/telemetry_rules.py:259-266)
        if ctx.module is None or not ctx.module.startswith("repro_torch"):
            return []
        if ctx.module.startswith("repro_torch.telemetry"):
            return []           # the resolver's own home
        resolver_names = {"maybe", "_maybe_tel"}
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.ImportFrom)
                    and (node.module or "").startswith(
                        "repro_torch.telemetry")):
                for alias in node.names:
                    if alias.name in ("maybe", "_maybe_tel"):
                        resolver_names.add(alias.asname or alias.name)
        findings: List[Finding] = []

        def visit(node: ast.AST, in_loop: bool,
                  method_of_class: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                child_loop = in_loop or isinstance(
                    child, (ast.For, ast.While, ast.AsyncFor))
                child_method = method_of_class
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    if isinstance(node, ast.ClassDef):
                        child_method = child.name
                    else:
                        child_method = None
                    child_loop = False
                elif isinstance(child, ast.ClassDef):
                    child_method = None
                if (isinstance(child, ast.Call)
                        and isinstance(child.func, ast.Name)
                        and child.func.id in resolver_names):
                    if child_loop:
                        findings.append(Finding(
                            path=ctx.rel_path, line=child.lineno,
                            rule=self.id,
                            message="telemetry facade resolved inside a "
                                    "loop; bind self._tel = maybe(...) "
                                    "once at construction"))
                    elif (child_method is not None
                          and child_method not in self.ALLOWED_METHODS):
                        findings.append(Finding(
                            path=ctx.rel_path, line=child.lineno,
                            rule=self.id,
                            message=f"telemetry facade resolved per-call "
                                    f"in method {child_method}(); bind "
                                    f"once in __init__/bind"))
                visit(child, child_loop, child_method)

        visit(ctx.tree, False, None)
        return findings
