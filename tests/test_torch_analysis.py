"""The port's contract checker (``repro_torch.analysis``): every case of
``tests/test_analysis.py`` run through it over port versions of
``tests/analysis_fixtures`` (each tree copied with ``repro/`` renamed
``repro_torch/`` and ``repro.`` read as ``repro_torch.``), its findings
equal to the reference checker's on every fixture once the package name
is mapped, and the live port tree clean under it, with the one
sanctioned suppression pinned."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro import analysis as ref_analysis
from repro_torch.analysis import (AstCache, EventEffectsRule,
                                  FreshRngInFaultPathRule, GlobalRngRule,
                                  JaxFreeImportRule, LazyFacadeRule,
                                  NonPerturbationRule, Project,
                                  TelemetryBindOnceRule, WallClockRule,
                                  default_rules, run_analysis)

HERE = os.path.dirname(os.path.abspath(__file__))
REF_FIXTURES = os.path.join(HERE, "analysis_fixtures")
REPO_ROOT = os.path.dirname(HERE)
SRC = os.path.join(REPO_ROOT, "src")


def _port_name(text):
    return re.sub(r"\brepro\b", "repro_torch", text)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The reference's fixture trees with the package renamed: a
    ``repro`` directory becomes ``repro_torch``, and ``repro.`` in a
    source reads ``repro_torch.``.  No line moves, so findings keep
    their lines."""
    out = tmp_path_factory.mktemp("port_fixtures")
    for dirpath, _dirs, names in os.walk(REF_FIXTURES):
        rel = os.path.relpath(dirpath, REF_FIXTURES)
        parts = ["repro_torch" if p == "repro" else p
                 for p in rel.split(os.sep) if p != "."]
        dst = os.path.join(str(out), *parts)
        os.makedirs(dst, exist_ok=True)
        for name in names:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                source = f.read()
            with open(os.path.join(dst, name), "w") as f:
                f.write(re.sub(r"\brepro\.", "repro_torch.", source))
    return str(out)


def file_findings(fixtures, rule, case, name, module):
    """A per-file rule over one fixture file, with suppressions applied
    the way the runner applies them."""
    path = os.path.join(fixtures, case, name + ".py")
    ctx = AstCache().get(path, f"{case}/{name}.py", module)
    return [f for f in rule.check_file(ctx)
            if not ctx.suppressed(f.line, f.rule)]


# ---------------------------------------------------------------------------
# per-file rules: DET001 / DET002 / DET003 / TEL001 / TEL002
# ---------------------------------------------------------------------------

FILE_RULE_CASES = [
    (GlobalRngRule, "det001", "repro_torch.sim.fixture", 3),
    (FreshRngInFaultPathRule, "det003", "repro_torch.sim.faults", 4),
    (WallClockRule, "det002", "repro_torch.sim.fixture", 3),
    (NonPerturbationRule, "tel001", "repro_torch.sim.fixture", 4),
    (TelemetryBindOnceRule, "tel002", "repro_torch.sim.fixture", 2),
]


@pytest.mark.parametrize("rule_cls,case,module,min_bad", FILE_RULE_CASES)
def test_bad_fixture_flagged(fixtures, rule_cls, case, module, min_bad):
    findings = file_findings(fixtures, rule_cls(), case, "bad", module)
    assert len(findings) >= min_bad, [f.format() for f in findings]
    assert all(f.rule == rule_cls.id for f in findings)
    assert all(f.line > 0 for f in findings)


@pytest.mark.parametrize("rule_cls,case,module,_", FILE_RULE_CASES)
def test_good_fixture_clean(fixtures, rule_cls, case, module, _):
    findings = file_findings(fixtures, rule_cls(), case, "good", module)
    assert findings == [], [f.format() for f in findings]


@pytest.mark.parametrize("rule_cls,case,module,_", FILE_RULE_CASES)
def test_suppressed_fixture_clean(fixtures, rule_cls, case, module, _):
    rule = rule_cls()
    path = os.path.join(fixtures, case, "suppressed.py")
    ctx = AstCache().get(path, "suppressed.py", module)
    assert rule.check_file(ctx), "the suppressed violation is real"
    assert file_findings(fixtures, rule, case, "suppressed", module) == []


def test_det001_out_of_scope_module_ignored(fixtures):
    path = os.path.join(fixtures, "det001", "bad.py")
    ctx = AstCache().get(path, "bad.py", "not_repro_torch.module")
    assert GlobalRngRule().check_file(ctx) == []
    # the reference's package is out of the port checker's scope
    ctx = AstCache().get(path, "bad.py", "repro.sim.fixture")
    assert GlobalRngRule().check_file(ctx) == []


def test_det003_function_scope_only_flags_fault_helpers(fixtures):
    rule = FreshRngInFaultPathRule()
    path = os.path.join(fixtures, "det003", "bad.py")
    findings = rule.check_file(
        AstCache().get(path, "bad.py", "repro_torch.routing.simulator"))
    module_findings = rule.check_file(
        AstCache().get(path, "bad.py", "repro_torch.sim.faults"))
    assert 0 < len(findings) < len(module_findings)
    assert {f.line for f in module_findings} - {f.line for f in findings}
    ctx = AstCache().get(path, "bad.py", "repro_torch.benchmark.helper")
    assert rule.check_file(ctx) == []
    # the port's live fault/retry code is clean under the rule
    for rel in ("repro_torch/sim/faults.py",
                "repro_torch/sim/request_plane.py",
                "repro_torch/routing/simulator.py"):
        live = AstCache().get(os.path.join(SRC, rel), rel,
                              rel[:-3].replace("/", "."))
        assert rule.check_file(live) == [], rel


def test_det002_allows_tracer_module(fixtures):
    path = os.path.join(fixtures, "det002", "bad.py")
    ctx = AstCache().get(path, "bad.py", "repro_torch.telemetry.tracer")
    assert WallClockRule().check_file(ctx) == []


# ---------------------------------------------------------------------------
# project rules: LAYER001 / LAYER002 / EVT001 over mini-trees
# ---------------------------------------------------------------------------

def project_findings(fixtures, rule, tree):
    return rule.check_project(Project(os.path.join(fixtures, tree)))


def test_layer001_transitive_jax_flagged(fixtures):
    findings = project_findings(fixtures, JaxFreeImportRule(),
                                "layer001_bad")
    assert any("repro_torch/sim/engine.py" in f.path for f in findings)
    assert any("jax" in f.message and "->" in f.message
               for f in findings)


def test_layer001_lazy_imports_clean(fixtures):
    assert project_findings(fixtures, JaxFreeImportRule(),
                            "layer001_good") == []


def test_layer002_eager_facade_flagged(fixtures):
    findings = project_findings(fixtures, LazyFacadeRule(), "layer002_bad")
    assert findings
    assert all(f.rule == "LAYER002" for f in findings)


def test_layer002_lazy_facade_clean(fixtures):
    assert project_findings(fixtures, LazyFacadeRule(),
                            "layer002_good") == []


def test_evt001_missing_and_stale_flagged(fixtures):
    msgs = [f.message for f in project_findings(
        fixtures, EventEffectsRule(), "evt001_bad")]
    assert any("TELEMETRY" in m and "no EVENT_EFFECTS" in m
               for m in msgs), msgs
    assert any("stale key" in m and "ROUND_END" in m for m in msgs), msgs


def test_evt001_complete_mapping_clean(fixtures):
    assert project_findings(fixtures, EventEffectsRule(),
                            "evt001_good") == []


# ---------------------------------------------------------------------------
# parity: the port's checker reports what the reference's does
# ---------------------------------------------------------------------------

FILE_FIXTURES = [(case, name, module)
                 for _, case, module, _ in FILE_RULE_CASES
                 for name in ("bad", "good", "suppressed")]
TREE_FIXTURES = ["layer001_bad", "layer001_good", "layer002_bad",
                 "layer002_good", "evt001_bad", "evt001_good"]


def _mapped(findings):
    return sorted((_port_name(f.path), f.line, f.rule, _port_name(f.message))
                  for f in findings)


@pytest.mark.parametrize("case,name,module", FILE_FIXTURES,
                         ids=[f"{c}/{n}" for c, n, _ in FILE_FIXTURES])
def test_file_findings_equal_the_references(fixtures, case, name, module):
    """Every rule over one fixture file, raw and with suppressions."""
    ref_path = os.path.join(REF_FIXTURES, case, name + ".py")
    port_path = os.path.join(fixtures, case, name + ".py")
    rel = f"{case}/{name}.py"
    ref_module = "repro" + module[len("repro_torch"):]
    ref_ctx = ref_analysis.AstCache().get(ref_path, rel, ref_module)
    port_ctx = AstCache().get(port_path, rel, module)
    assert ref_ctx.suppressions == port_ctx.suppressions
    n_rules = 0
    for ref_rule, port_rule in zip(ref_analysis.default_rules(),
                                   default_rules()):
        assert ref_rule.id == port_rule.id
        ref = ref_rule.check_file(ref_ctx)
        port = port_rule.check_file(port_ctx)
        assert _mapped(port) == _mapped(ref), ref_rule.id
        n_rules += bool(ref)
    if name != "good":
        assert n_rules >= 1            # the fixture exercises a rule


@pytest.mark.parametrize("tree", TREE_FIXTURES)
def test_tree_findings_equal_the_references(fixtures, tree):
    """The whole runner over one mini-tree: findings, files checked and
    suppressions in effect."""
    ref = ref_analysis.run_analysis(os.path.join(REF_FIXTURES, tree))
    port = run_analysis(os.path.join(fixtures, tree))
    assert _mapped(port.findings) == _mapped(ref.findings)
    assert port.files_checked == ref.files_checked
    assert port.suppressions_used == [
        (_port_name(p), ln, r) for p, ln, r in ref.suppressions_used]
    assert ref.ok == tree.endswith("_good")


# ---------------------------------------------------------------------------
# live tree: the port satisfies the reference's contracts
# ---------------------------------------------------------------------------

def test_live_tree_zero_findings():
    result = run_analysis(REPO_ROOT)
    assert result.ok, "\n" + result.format()
    assert result.files_checked > 100
    # the one sanctioned suppression, the copy of the reference's
    # (cosim's budget-observer wiring, CONTRACTS.md)
    assert result.suppressions_used == [
        ("src/repro_torch/sim/cosim.py", 205, "TEL001")]


# ---------------------------------------------------------------------------
# CLI: exit codes and JSON output
# ---------------------------------------------------------------------------

def run_cli(*argv):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT)


def test_cli_clean_tree_exit_zero():
    proc = run_cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "contract check OK" in proc.stdout
    assert "src/repro_torch/sim/cosim.py:205  TEL001" in proc.stdout


def test_cli_bad_tree_exit_one(fixtures, tmp_path):
    proc = run_cli("--root", os.path.join(fixtures, "layer001_bad"),
                   "--rules", "LAYER001",
                   "--json", str(tmp_path / "out.json"))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "LAYER001" in proc.stdout
    data = json.loads((tmp_path / "out.json").read_text())
    assert data["ok"] is False
    assert data["counts"].get("LAYER001", 0) >= 1


def test_cli_unknown_rule_exit_two():
    assert run_cli("--rules", "NOPE999").returncode == 2


def test_cli_missing_root_exit_two(tmp_path):
    # the reference's tree alone is no port tree
    (tmp_path / "src" / "repro").mkdir(parents=True)
    assert run_cli("--root", str(tmp_path)).returncode == 2


# ---------------------------------------------------------------------------
# injection: mutating the port's tree trips the gate
# ---------------------------------------------------------------------------

def copy_src_tree(tmp_path):
    shutil.copytree(os.path.join(SRC, "repro_torch"),
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build",
                                                  "csrc"))
    return tmp_path


def test_injected_global_rng_fails_gate(tmp_path):
    root = copy_src_tree(tmp_path)
    target = root / "src" / "repro_torch" / "sim" / "request_plane.py"
    with open(target, "a") as f:
        f.write("\n\ndef _injected(n):\n"
                "    import numpy as np\n"
                "    return np.random.rand(n)\n")
    result = run_analysis(str(root))
    assert any(f.rule == "DET001" and "request_plane" in f.path
               for f in result.findings)


def test_added_event_kind_without_effects_fails_gate(tmp_path):
    root = copy_src_tree(tmp_path)
    target = root / "src" / "repro_torch" / "sim" / "events.py"
    source = target.read_text()
    marker = "    REQUEST_ARRIVAL = 15"
    assert marker in source
    target.write_text(source.replace(
        marker, marker + "\n    INJECTED_KIND = 16", 1))
    result = run_analysis(str(root))
    assert any(f.rule == "EVT001" and "INJECTED_KIND" in f.message
               for f in result.findings)


@pytest.mark.parametrize("heavy", ["torch", "jax"])
def test_injected_eager_heavy_import_fails_gate(tmp_path, heavy):
    """A protected module that imports the port's own framework (torch)
    or the reference's (jax) eagerly fails LAYER001, and so does a
    facade that goes eager (LAYER002)."""
    root = copy_src_tree(tmp_path)
    pkg = root / "src" / "repro_torch"
    target = pkg / "routing" / "simulator.py"
    target.write_text(f"import {heavy}\n" + target.read_text())
    facade = pkg / "serving" / "__init__.py"
    facade.write_text(facade.read_text()
                      + "\nfrom repro_torch.serving.engine import "
                        "ServeEngine\n")
    result = run_analysis(str(root))
    assert any(f.rule == "LAYER001" and "simulator" in f.path
               and heavy in f.message for f in result.findings)
    assert any(f.rule == "LAYER002" and "serving" in f.path
               and "torch" in f.message for f in result.findings)
