"""Import-layering rules: who may pull in jax at import time.

The co-simulation / routing / solver / telemetry stack is deliberately
numpy-only so scenario grids, scaling studies, and CI import in
milliseconds and run on jax-free boxes; jax lives behind the training
modules (``repro_torch.fl`` internals, ``repro_torch.models``,
``repro_torch.training``) and the lazy serving facade.  These rules
walk the *eager* import graph (top-level statements only —
function-local and ``TYPE_CHECKING`` imports are free) and fail if a
protected module can reach an accelerator framework (for the port,
torch) at import time.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import (Finding, Project, Rule, eager_imports)

#: accelerator frameworks that must stay out of protected import closures
HEAVY_MODULES = ("jax", "jaxlib", "flax", "optax", "torch", "tensorflow")

#: namespaces that must import jax-free (prefix match on dotted name);
#: Port: the package name here and in LAZY_FACADES
#: (repro/analysis/imports.py:22-33)
PROTECTED_NAMESPACES = (
    "repro_torch.routing",
    "repro_torch.sim",
    "repro_torch.core",
    "repro_torch.telemetry",
    "repro_torch.configs",
    "repro_torch.fl.schedule",
)

#: lazy facades: their own eager body must stay jax-free even though the
#: names they re-export resolve to jax-backed modules on attribute access
LAZY_FACADES = ("repro_torch.serving", "repro_torch.fl")


def _resolve_relative(importer: str, is_pkg: bool, name: str) -> str:
    """Resolve a leading-dots import name against the importing module."""
    if not name.startswith("."):
        return name
    level = len(name) - len(name.lstrip("."))
    remainder = name[level:]
    parts = importer.split(".")
    if not is_pkg:
        parts = parts[:-1]
    # one leading dot = current package; each extra dot goes up one
    parts = parts[: len(parts) - (level - 1)] if level > 1 else parts
    base = ".".join(parts)
    return base + ("." + remainder if remainder else "")


class _ImportGraph:
    """Eager import edges between internal (``repro_torch.*``) modules, plus
    the heavy third-party modules each file names directly."""

    def __init__(self, project: Project):
        self.project = project
        # module -> [(target module name, line)]
        self.edges: Dict[str, List[Tuple[str, int]]] = {}
        # module -> [(heavy root, line)]
        self.heavy: Dict[str, List[Tuple[str, int]]] = {}
        for path in project.iter_paths():
            ctx = project.context(path)
            mod = ctx.module or ""
            is_pkg = path.endswith("__init__.py")
            edges: List[Tuple[str, int]] = []
            heavy: List[Tuple[str, int]] = []
            for name, line in eager_imports(ctx.tree):
                name = _resolve_relative(mod, is_pkg, name)
                root = name.split(".")[0]
                if root in HEAVY_MODULES:
                    heavy.append((root, line))
                    continue
                internal = self._to_internal(name)
                if internal is not None:
                    edges.append((internal, line))
            self.edges[mod] = edges
            self.heavy[mod] = heavy

    def _to_internal(self, name: str) -> Optional[str]:
        """Longest prefix of ``name`` that is an internal module (so
        ``from repro_torch.fl.schedule import RoundWindow`` maps to
        ``repro_torch.fl.schedule``, not a non-module attribute)."""
        if not name.startswith("repro_torch"):  # Port: imports.py:83
            return None
        parts = name.split(".")
        while parts:
            cand = ".".join(parts)
            if cand in self.project_modules:
                return cand
            parts = parts[:-1]
        return None

    @property
    def project_modules(self) -> Set[str]:
        cached = getattr(self, "_modules", None)
        if cached is None:
            cached = {self.project.module_name(p)
                      for p in self.project.iter_paths()}
            # importing a submodule also imports its ancestor packages
            self._modules = cached
        return cached

    def ancestors(self, module: str) -> List[str]:
        parts = module.split(".")
        return [".".join(parts[:i]) for i in range(1, len(parts))]

    def heavy_chain(self, start: str) -> Optional[List[str]]:
        """Shortest eager-import chain from ``start`` to a heavy module,
        as ``[start, ..., leaf, heavy_root]``; None if unreachable."""
        seen = {start}
        queue: List[List[str]] = [[start]]
        while queue:
            chain = queue.pop(0)
            mod = chain[-1]
            heavy = self.heavy.get(mod)
            if heavy:
                return chain + [heavy[0][0]]
            nxt: List[str] = []
            for target, _line in self.edges.get(mod, ()):  # direct edges
                nxt.append(target)
                nxt.extend(self.ancestors(target))  # pkg __init__ runs too
            for target in nxt:
                if target not in seen and target in self.edges:
                    seen.add(target)
                    queue.append(chain + [target])
        return None


def _is_protected(module: str, namespaces: Sequence[str]) -> bool:
    return any(module == ns or module.startswith(ns + ".")
               for ns in namespaces)


class JaxFreeImportRule(Rule):
    """LAYER001: protected namespaces must be jax-free at import time."""

    id = "LAYER001"
    name = "jax-free-import"
    description = ("repro_torch.routing/sim/core/telemetry/configs and "
                   "repro_torch.fl.schedule must not reach "
                   f"{'/'.join(HEAVY_MODULES[:2])}/... through their "
                   "eager import closure")
    namespaces = PROTECTED_NAMESPACES

    def check_project(self, project: Project) -> List[Finding]:
        graph = _ImportGraph(project)
        findings: List[Finding] = []
        for path in project.iter_paths():
            ctx = project.context(path)
            mod = ctx.module or ""
            if not _is_protected(mod, self.namespaces):
                continue
            for root, line in graph.heavy.get(mod, ()):  # direct import
                findings.append(Finding(
                    path=ctx.rel_path, line=line, rule=self.id,
                    message=f"protected module {mod} imports {root} "
                            f"at import time"))
            for target, line in graph.edges.get(mod, ()):  # transitive
                for hop in [target] + graph.ancestors(target):
                    chain = graph.heavy_chain(hop)
                    if chain is not None:
                        findings.append(Finding(
                            path=ctx.rel_path, line=line, rule=self.id,
                            message=(f"protected module {mod} reaches "
                                     f"{chain[-1]} at import time via "
                                     + " -> ".join(chain))))
                        break
        return findings


class LazyFacadeRule(Rule):
    """LAYER002: lazy facades' own eager bodies must stay jax-free.

    ``repro_torch.serving.__init__`` and ``repro_torch.fl.__init__`` re-export
    jax-backed names through PEP 562 ``__getattr__``; the contract is
    that *importing the package* stays cheap — only attribute access
    pays.  This checks the facades' eager closure like LAYER001 does
    for protected namespaces.
    """

    id = "LAYER002"
    name = "lazy-facade"
    description = ("repro_torch.serving and repro_torch.fl package "
                   "__init__ must stay lazy: eager import closure jax-free")
    facades = LAZY_FACADES

    def check_project(self, project: Project) -> List[Finding]:
        graph = _ImportGraph(project)
        findings: List[Finding] = []
        for facade in self.facades:
            path = project.module_path(facade)
            if path is None or not path.endswith("__init__.py"):
                continue
            ctx = project.context(path)
            for root, line in graph.heavy.get(facade, ()):
                findings.append(Finding(
                    path=ctx.rel_path, line=line, rule=self.id,
                    message=f"lazy facade {facade} imports {root} "
                            f"eagerly"))
            for target, line in graph.edges.get(facade, ()):
                for hop in [target] + graph.ancestors(target):
                    chain = graph.heavy_chain(hop)
                    if chain is not None:
                        findings.append(Finding(
                            path=ctx.rel_path, line=line, rule=self.id,
                            message=(f"lazy facade {facade} reaches "
                                     f"{chain[-1]} eagerly via "
                                     + " -> ".join(chain))))
                        break
        return findings
