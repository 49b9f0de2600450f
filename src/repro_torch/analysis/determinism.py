"""Determinism rules: RNG discipline and wall-clock isolation.

Every replayed experiment in this repo — co-sim scenario grids, solver
gap gates, routing fingerprints — depends on two conventions:

- all randomness flows through explicitly passed
  ``numpy.random.Generator`` objects drawn in heap order (DET001:
  global-state ``np.random.*`` and the stdlib ``random`` module are
  forbidden; constructing generators via ``default_rng(seed)`` is the
  sanctioned entry point);
- simulated time is the only time sim/control/solver code may read
  (DET002: ``time.time``/``perf_counter``/``monotonic`` and argless
  ``datetime.now`` are forbidden there; code that legitimately measures
  real elapsed time calls ``repro_torch.telemetry.tracer.wall_clock`` — the
  single audited read);
- chaos and retry/failover code draws ONLY from the shared per-run
  generator the co-sim passes in (DET003: constructing a fresh
  Generator — even the DET001-sanctioned ``default_rng(seed)`` — inside
  ``repro_torch.sim.faults`` or a retry/backoff/failover/fault helper would
  fork the draw stream and break heap-vs-batched retry-schedule
  parity).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Sequence, Set

from repro_torch.analysis.core import (FileContext, Finding, Rule, dotted_name)

#: np.random constructors that are fine — they create explicit streams
RNG_CONSTRUCTORS = {
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64",
}

#: time-module attributes that read the wall clock
WALL_CLOCK_ATTRS = {
    "time", "time_ns", "perf_counter", "perf_counter_ns",
    "monotonic", "monotonic_ns", "process_time", "process_time_ns",
}

#: datetime methods that read the wall clock
DATETIME_NOW = {"now", "utcnow", "today"}


def module_aliases(tree: ast.Module, module: str) -> Set[str]:
    """Local names bound to ``module`` by top-level or nested imports
    (``import numpy as np`` -> {"np"})."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == module:
                    out.add(alias.asname or module.split(".")[0])
    return out


def from_imports(tree: ast.Module, module: str) -> Dict[str, str]:
    """``{local name: original name}`` for ``from <module> import ...``."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for alias in node.names:
                if alias.name != "*":
                    out[alias.asname or alias.name] = alias.name
    return out


def _in_scope(module: str, include: Sequence[str],
              exclude: Sequence[str]) -> bool:
    def hit(namespaces: Sequence[str]) -> bool:
        return any(module == ns or module.startswith(ns + ".")
                   for ns in namespaces)
    return hit(include) and not hit(exclude)


class GlobalRngRule(Rule):
    """DET001: no global-state RNG anywhere in the package."""

    id = "DET001"
    name = "no-global-rng"
    description = ("randomness must flow through explicitly passed "
                   "np.random.Generator objects: global-state "
                   "np.random.* calls and the stdlib random module are "
                   "forbidden")
    include = ("repro_torch",)  # Port: repro/analysis/determinism.py:87
    exclude: Sequence[str] = ()

    def check_file(self, ctx: FileContext) -> List[Finding]:
        if ctx.module is None or not _in_scope(ctx.module, self.include,
                                               self.exclude):
            return []
        findings: List[Finding] = []
        np_names = module_aliases(ctx.tree, "numpy") | {"numpy"}
        npr_names = (module_aliases(ctx.tree, "numpy.random")
                     | set(from_imports(ctx.tree, "numpy").get(k, "")
                           for k in ()))
        # `from numpy import random [as r]`
        for local, orig in from_imports(ctx.tree, "numpy").items():
            if orig == "random":
                npr_names.add(local)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "random":
                        findings.append(Finding(
                            path=ctx.rel_path, line=node.lineno,
                            rule=self.id,
                            message="stdlib random module imported; use "
                                    "an explicit np.random.Generator"))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "random":
                    findings.append(Finding(
                        path=ctx.rel_path, line=node.lineno,
                        rule=self.id,
                        message="stdlib random import; use an explicit "
                                "np.random.Generator"))
                elif node.module in ("numpy.random", "numpy"):
                    mod_attrs = (RNG_CONSTRUCTORS
                                 if node.module == "numpy.random"
                                 else set())
                    for alias in node.names:
                        if (node.module == "numpy.random"
                                and alias.name not in mod_attrs):
                            findings.append(Finding(
                                path=ctx.rel_path, line=node.lineno,
                                rule=self.id,
                                message=f"global-state numpy.random."
                                        f"{alias.name} imported; draw "
                                        f"from a passed Generator"))
            elif isinstance(node, ast.Attribute):
                name = dotted_name(node)
                if name is None:
                    continue
                parts = name.split(".")
                # np.random.X / numpy.random.X
                if (len(parts) >= 3 and parts[0] in np_names
                        and parts[1] == "random"
                        and parts[2] not in RNG_CONSTRUCTORS):
                    findings.append(Finding(
                        path=ctx.rel_path, line=node.lineno, rule=self.id,
                        message=f"global-state np.random.{parts[2]}; "
                                f"draw from a passed Generator"))
                # nprandom.X  (import numpy.random as nprandom)
                elif (len(parts) >= 2 and parts[0] in npr_names
                        and parts[0] != ""
                        and parts[1] not in RNG_CONSTRUCTORS):
                    findings.append(Finding(
                        path=ctx.rel_path, line=node.lineno, rule=self.id,
                        message=f"global-state numpy.random."
                                f"{parts[1]}; draw from a passed "
                                f"Generator"))
        return findings


class WallClockRule(Rule):
    """DET002: sim/control/solver paths never read the wall clock."""

    id = "DET002"
    name = "no-wall-clock"
    description = ("sim/control/solver code must not reference "
                   "time.time/perf_counter/monotonic or argless "
                   "datetime.now; real elapsed time goes through "
                   "repro_torch.telemetry.tracer.wall_clock")
    # Port: the package name (repro/analysis/determinism.py:166-173)
    include = ("repro_torch.sim", "repro_torch.routing",
               "repro_torch.core", "repro_torch.orchestration",
               "repro_torch.fl", "repro_torch.data", "repro_torch.configs",
               "repro_torch.checkpoint", "repro_torch.analysis")
    # tracer.py hosts the one audited read; training/launch/benchmark
    # code measures real time legitimately
    exclude = ("repro_torch.telemetry.tracer", "repro_torch.launch",
               "repro_torch.serving", "repro_torch.models",
               "repro_torch.kernels", "repro_torch.training",
               "repro_torch.fl.hierarchy_bench")

    def check_file(self, ctx: FileContext) -> List[Finding]:
        if ctx.module is None or not _in_scope(ctx.module, self.include,
                                               self.exclude):
            return []
        findings: List[Finding] = []
        time_names = module_aliases(ctx.tree, "time") | {"time"}
        dt_locals = from_imports(ctx.tree, "datetime")
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name in WALL_CLOCK_ATTRS:
                        findings.append(Finding(
                            path=ctx.rel_path, line=node.lineno,
                            rule=self.id,
                            message=f"time.{alias.name} imported in a "
                                    f"sim/control path; use "
                                    f"telemetry.tracer.wall_clock"))
            elif isinstance(node, ast.Attribute):
                name = dotted_name(node)
                if name is None:
                    continue
                parts = name.split(".")
                # time.perf_counter etc. — flag the *reference*, not just
                # calls: `default_factory=time.monotonic` never calls it
                # at this site but still injects wall time
                if (len(parts) >= 2 and parts[0] in time_names
                        and parts[1] in WALL_CLOCK_ATTRS):
                    findings.append(Finding(
                        path=ctx.rel_path, line=node.lineno, rule=self.id,
                        message=f"wall-clock read time.{parts[1]} in a "
                                f"sim/control path; use "
                                f"telemetry.tracer.wall_clock"))
                # datetime.datetime.now / dt.now / date.today
                elif parts[-1] in DATETIME_NOW and (
                        parts[0] in module_aliases(ctx.tree, "datetime")
                        or parts[0] in dt_locals):
                    findings.append(Finding(
                        path=ctx.rel_path, line=node.lineno, rule=self.id,
                        message=f"wall-clock read {name} in a "
                                f"sim/control path"))
        return findings


class FreshRngInFaultPathRule(Rule):
    """DET003: fault/retry code never constructs its own Generator.

    Retry schedules, failover decisions and fault timelines must be
    bit-identical between the heap and the batched request planes —
    which holds only when every draw comes from the ONE shared per-run
    generator, consumed in event order.  ``default_rng(seed)`` is fine
    elsewhere (DET001 sanctions it as the explicit-stream entry point),
    but inside the chaos module or a retry/backoff/failover helper it
    forks a private stream whose draws don't interleave with the run's,
    silently desynchronizing the two engines.
    """

    id = "DET003"
    name = "no-fresh-rng-in-fault-path"
    description = ("chaos plans and retry/backoff/failover helpers may "
                   "draw randomness only from the shared per-run "
                   "Generator passed in; constructing a fresh Generator "
                   "(np.random.default_rng & co.) there is forbidden")
    #: whole modules where any Generator construction is forbidden
    # Port: the package name (repro/analysis/determinism.py:238-242)
    module_scope: Sequence[str] = ("repro_torch.sim.faults",)
    #: modules where only fault-path functions are checked (they host
    #: sanctioned constructors elsewhere, e.g. bootstrap CIs)
    function_scope: Sequence[str] = ("repro_torch.sim.request_plane",
                                     "repro_torch.routing.simulator")
    _FAULT_FUNC = re.compile(r"retry|backoff|failover|fault",
                             re.IGNORECASE)

    def _constructor_calls(self, ctx: FileContext,
                           root: ast.AST) -> List[Finding]:
        np_names = module_aliases(ctx.tree, "numpy") | {"numpy"}
        npr_names = module_aliases(ctx.tree, "numpy.random")
        for local, orig in from_imports(ctx.tree, "numpy").items():
            if orig == "random":
                npr_names.add(local)
        bare = {local for local, orig
                in from_imports(ctx.tree, "numpy.random").items()
                if orig in RNG_CONSTRUCTORS}
        findings: List[Finding] = []
        for node in ast.walk(root):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            parts = name.split(".")
            hit = (
                # np.random.default_rng(...) / numpy.random.Generator(...)
                (len(parts) >= 3 and parts[0] in np_names
                 and parts[1] == "random"
                 and parts[2] in RNG_CONSTRUCTORS)
                # nprandom.default_rng(...)
                or (len(parts) >= 2 and parts[0] in npr_names
                    and parts[1] in RNG_CONSTRUCTORS)
                # default_rng(...) via `from numpy.random import ...`
                or (len(parts) == 1 and parts[0] in bare))
            if hit:
                findings.append(Finding(
                    path=ctx.rel_path, line=node.lineno, rule=self.id,
                    message=f"fresh Generator ({name}) constructed in a "
                            f"fault/retry path; draw from the shared "
                            f"per-run Generator instead"))
        return findings

    def check_file(self, ctx: FileContext) -> List[Finding]:
        if ctx.module is None:
            return []
        if _in_scope(ctx.module, self.module_scope, ()):
            return self._constructor_calls(ctx, ctx.tree)
        if not _in_scope(ctx.module, self.function_scope, ()):
            return []
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and self._FAULT_FUNC.search(node.name)):
                findings.extend(self._constructor_calls(ctx, node))
        return findings
