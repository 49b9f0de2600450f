"""Contract checker: AST-based invariant linter, the port's copy.

Run ``python -m repro_torch.analysis`` (CI does, as a hard gate).  The rules
and the invariants behind them are documented in CONTRACTS.md at the
repo root; suppress a sanctioned violation inline with
``# contract: ok RULE001`` and document the site there.

This is ``repro/analysis`` copied but for the package name: it scans
``src/repro_torch`` and holds the port to the reference's contracts,
with ``torch`` the heavy framework the numpy-only layers must not reach
(``imports.HEAVY_MODULES`` lists it).  Each place where the package
name is a string is marked ``Port:`` with the reference's line.
"""
from repro_torch.analysis.core import (AnalysisResult, AstCache, FileContext,
                                 Finding, Project, Rule, default_rules,
                                 run_analysis)
from repro_torch.analysis.determinism import (FreshRngInFaultPathRule,
                                        GlobalRngRule, WallClockRule)
from repro_torch.analysis.events_rules import EventEffectsRule
from repro_torch.analysis.imports import JaxFreeImportRule, LazyFacadeRule
from repro_torch.analysis.telemetry_rules import (NonPerturbationRule,
                                            TelemetryBindOnceRule)

__all__ = [
    "AnalysisResult", "AstCache", "FileContext", "Finding", "Project",
    "Rule", "default_rules", "run_analysis",
    "FreshRngInFaultPathRule", "JaxFreeImportRule", "LazyFacadeRule", "GlobalRngRule",
    "WallClockRule", "NonPerturbationRule", "TelemetryBindOnceRule",
    "EventEffectsRule",
]
