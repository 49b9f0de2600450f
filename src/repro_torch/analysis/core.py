"""Rule framework for the contract checker (numpy/stdlib-only).

The checker is a small static-analysis engine over the repo's own
source tree: every rule states one invariant the reproduction's
correctness rests on (import layering, RNG discipline, telemetry
non-perturbation, event-effect completeness, hot-path binding — see
CONTRACTS.md), and CI runs ``python -m repro_torch.analysis`` as a hard
gate so a violation fails before a test ever has to catch it.

Pieces:

- :class:`FileContext` — one parsed file: AST, source lines, module
  name, and the inline suppressions found in it.  Parsed once per
  (path, mtime, size) through the process-wide :class:`AstCache`, so
  rules share the work.
- :class:`Rule` — per-file rules implement :meth:`Rule.check_file`;
  whole-tree rules (the import graph, the EVENT_EFFECTS cross-check)
  implement :meth:`Rule.check_project` instead.
- :class:`Project` — the scanned tree (``<root>/src/repro_torch`` or
  ``<root>/repro_torch``) with path <-> module-name mapping.
- :func:`run_analysis` — run rules, drop suppressed findings, return
  them sorted plus the list of suppressions actually used (CONTRACTS.md
  enumerates the sanctioned sites; the self-check test pins them).

Suppressions: a ``# contract: ok RULE001`` comment on the offending
line (or alone on the line directly above) suppresses that rule there;
``# contract: ok`` with no id suppresses every rule on the line.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*contract:\s*ok(?:\s+(?P<ids>[A-Z][A-Z0-9]*(?:\s*,\s*[A-Z][A-Z0-9]*)*))?")

#: suppress-all marker used in FileContext.suppressions values
ALL_RULES = "*"


@dataclass(frozen=True, order=True)
class Finding:
    """One contract violation at a source location."""
    path: str                        # repo-root-relative, '/'-separated
    line: int
    rule: str                        # rule id, e.g. "DET001"
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message}


@dataclass
class FileContext:
    """One parsed source file, shared by all rules."""
    path: str                        # absolute path on disk
    rel_path: str                    # repo-root-relative display path
    module: Optional[str]            # dotted module name, None outside pkg
    source: str
    lines: List[str]
    tree: ast.Module
    # line number -> suppressed rule ids ({ALL_RULES} = every rule)
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)

    def suppressed(self, line: int, rule_id: str) -> bool:
        ids = self.suppressions.get(line)
        return ids is not None and (ALL_RULES in ids or rule_id in ids)


def _parse_suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """``# contract: ok [IDS]`` markers.  A marker sharing its line with
    code covers that line; a comment-only marker covers the next line
    (and itself, so marker placement never creates a hole)."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(text)
        if m is None:
            continue
        ids_raw = m.group("ids")
        ids = ({ALL_RULES} if not ids_raw
               else {s.strip() for s in ids_raw.split(",")})
        covers = [i]
        if text.lstrip().startswith("#"):
            covers.append(i + 1)
        for ln in covers:
            out.setdefault(ln, set()).update(ids)
    return out


class AstCache:
    """Per-file parse cache keyed by (mtime_ns, size): re-running the
    checker (or several rules over one file) parses each file once."""

    def __init__(self) -> None:
        self._cache: Dict[str, Tuple[Tuple[int, int], FileContext]] = {}

    def get(self, path: str, rel_path: str,
            module: Optional[str]) -> FileContext:
        st = os.stat(path)
        key = (st.st_mtime_ns, st.st_size)
        hit = self._cache.get(path)
        if hit is not None and hit[0] == key:
            return hit[1]
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        lines = source.splitlines()
        tree = ast.parse(source, filename=path)
        ctx = FileContext(path=path, rel_path=rel_path, module=module,
                          source=source, lines=lines, tree=tree,
                          suppressions=_parse_suppressions(lines))
        self._cache[path] = (key, ctx)
        return ctx


_GLOBAL_CACHE = AstCache()


class Project:
    """The scanned package tree.  ``root`` is the repo root; the package
    lives at ``<root>/src/repro_torch`` (this repo's layout) or
    ``<root>/repro_torch``
    (the test fixtures' mini-trees)."""

    def __init__(self, root: str, cache: Optional[AstCache] = None):
        self.root = os.path.abspath(root)
        self.cache = cache if cache is not None else _GLOBAL_CACHE
        # Port: the port's package (repro/analysis/core.py:134-141)
        for candidate in (os.path.join(self.root, "src", "repro_torch"),
                          os.path.join(self.root, "repro_torch")):
            if os.path.isdir(candidate):
                self.pkg_dir = candidate
                break
        else:
            raise FileNotFoundError(
                f"no 'src/repro_torch' or 'repro_torch' package under "
                f"{self.root}")
        self.pkg_root = os.path.dirname(self.pkg_dir)  # sys.path entry

    def iter_paths(self) -> Iterable[str]:
        for dirpath, dirnames, filenames in os.walk(self.pkg_dir):
            dirnames.sort()
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)

    def module_name(self, path: str) -> str:
        rel = os.path.relpath(os.path.abspath(path), self.pkg_root)
        parts = rel[:-3].split(os.sep)          # strip ".py"
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    def module_path(self, module: str) -> Optional[str]:
        """Filesystem path of a dotted internal module, if it exists."""
        base = os.path.join(self.pkg_root, *module.split("."))
        if os.path.isfile(base + ".py"):
            return base + ".py"
        init = os.path.join(base, "__init__.py")
        if os.path.isfile(init):
            return init
        return None

    def context(self, path: str) -> FileContext:
        rel = os.path.relpath(os.path.abspath(path), self.root)
        return self.cache.get(os.path.abspath(path),
                              rel.replace(os.sep, "/"),
                              self.module_name(path))

    def contexts(self) -> List[FileContext]:
        return [self.context(p) for p in self.iter_paths()]


class Rule:
    """One invariant.  Subclasses set ``id``/``name``/``description``
    and implement ``check_file`` (per-file) or ``check_project``
    (whole-tree); the runner calls both."""

    id: str = "RULE000"
    name: str = "unnamed"
    description: str = ""

    def check_file(self, ctx: FileContext) -> List[Finding]:
        return []

    def check_project(self, project: Project) -> List[Finding]:
        return []


# ---------------------------------------------------------------------------
# shared AST helpers used by several rules
# ---------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def in_module_scope(tree: ast.Module, node: ast.stmt) -> bool:
    """Whether ``node`` executes at import time: module body, or nested
    only under module-level ``if``/``try`` blocks (never inside a
    function or class body)."""
    return node in _eager_statements(tree)


def _eager_statements(tree: ast.Module) -> List[ast.stmt]:
    out: List[ast.stmt] = []
    stack: List[ast.stmt] = list(tree.body)
    while stack:
        stmt = stack.pop()
        out.append(stmt)
        if isinstance(stmt, ast.If):
            if _is_type_checking(stmt.test):
                stack.extend(stmt.orelse)
            else:
                stack.extend(stmt.body)
                stack.extend(stmt.orelse)
        elif isinstance(stmt, ast.Try):
            stack.extend(stmt.body)
            stack.extend(stmt.orelse)
            stack.extend(stmt.finalbody)
            for h in stmt.handlers:
                stack.extend(h.body)
        elif isinstance(stmt, (ast.With,)):
            stack.extend(stmt.body)
    return out


def _is_type_checking(test: ast.expr) -> bool:
    name = dotted_name(test)
    return name in ("TYPE_CHECKING", "typing.TYPE_CHECKING")


def eager_imports(tree: ast.Module) -> List[Tuple[str, int]]:
    """(imported module, line) pairs that execute at import time.
    ``from X import Y`` yields ``X`` and — so package-submodule imports
    resolve — ``X.Y``; relative imports are returned with leading dots
    for the caller to resolve."""
    out: List[Tuple[str, int]] = []
    for stmt in _eager_statements(tree):
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                out.append((alias.name, stmt.lineno))
        elif isinstance(stmt, ast.ImportFrom):
            prefix = "." * stmt.level + (stmt.module or "")
            out.append((prefix, stmt.lineno))
            for alias in stmt.names:
                if alias.name != "*":
                    out.append((prefix + "." + alias.name, stmt.lineno))
    return out


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

@dataclass
class AnalysisResult:
    findings: List[Finding]
    files_checked: int
    # suppressions that actually absorbed a finding: (path, line, rule)
    suppressions_used: List[Tuple[str, int, str]]

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> Dict[str, object]:
        counts: Dict[str, int] = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return {
            "ok": self.ok,
            "files_checked": self.files_checked,
            "findings": [f.to_dict() for f in self.findings],
            "counts": counts,
            "suppressions_used": [
                {"path": p, "line": ln, "rule": r}
                for p, ln, r in self.suppressions_used],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2) + "\n"

    def format(self) -> str:
        if self.ok:
            lines = [f"contract check OK: {self.files_checked} files, "
                     f"0 findings"]
        else:
            lines = [f.format() for f in self.findings]
            lines.append(f"contract check FAILED: {len(self.findings)} "
                         f"finding(s) across {self.files_checked} files")
        if self.suppressions_used:
            lines.append("suppressions in effect:")
            lines.extend(f"  {p}:{ln}  {r}"
                         for p, ln, r in self.suppressions_used)
        return "\n".join(lines)


def default_rules() -> List[Rule]:
    # local import: the rule modules import this one
    from repro_torch.analysis.determinism import (FreshRngInFaultPathRule,
                                            GlobalRngRule, WallClockRule)
    from repro_torch.analysis.events_rules import EventEffectsRule
    from repro_torch.analysis.imports import JaxFreeImportRule, LazyFacadeRule
    from repro_torch.analysis.telemetry_rules import (NonPerturbationRule,
                                                TelemetryBindOnceRule)
    return [JaxFreeImportRule(), LazyFacadeRule(), GlobalRngRule(),
            WallClockRule(), FreshRngInFaultPathRule(),
            NonPerturbationRule(), TelemetryBindOnceRule(),
            EventEffectsRule()]


def run_analysis(root: str, rules: Optional[Sequence[Rule]] = None,
                 ) -> AnalysisResult:
    project = Project(root)
    if rules is None:
        rules = default_rules()
    contexts = project.contexts()
    by_path = {ctx.rel_path: ctx for ctx in contexts}
    raw: List[Finding] = []
    for rule in rules:
        for ctx in contexts:
            raw.extend(rule.check_file(ctx))
        raw.extend(rule.check_project(project))
    findings: List[Finding] = []
    used: List[Tuple[str, int, str]] = []
    for f in sorted(set(raw)):
        ctx = by_path.get(f.path)
        if ctx is not None and ctx.suppressed(f.line, f.rule):
            used.append((f.path, f.line, f.rule))
        else:
            findings.append(f)
    return AnalysisResult(findings=findings, files_checked=len(contexts),
                          suppressions_used=sorted(set(used)))
