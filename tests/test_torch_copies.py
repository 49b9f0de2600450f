"""The numpy-only layers of the port are copies of the JAX package's:
each module's syntax tree equals its original's once ``repro.`` imports
read ``repro_torch.`` and docstrings are dropped.  The one sanctioned
difference is the controller's ``device``, passed through to the port's
``ReplicaPool``.  Then the quickstart's own inputs at seed 0 go through
both packages: the HFLOP topology, the routing simulator's latencies and
tier fractions, and the communication costs are identical."""
import ast
import dataclasses
import os
import re

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

COPIES = [
    "data/traffic.py", "fl/schedule.py", "core/hflop.py",
    "core/topology.py", "telemetry/tracer.py", "telemetry/registry.py",
    "telemetry/audit.py", "telemetry/__init__.py", "core/milp.py",
    "core/partition.py", "core/costmodel.py", "core/solvers.py",
    "core/__init__.py", "orchestration/gpo.py",
    "orchestration/controller.py", "orchestration/__init__.py",
    "routing/rules.py", "serving/workload.py", "sim/events.py",
    "sim/request_plane.py", "routing/simulator.py", "serving/page_pool.py",
    "serving/scheduler.py", "configs/xlstm_125m.py",
    "configs/whisper_small.py", "configs/internvl2_76b.py",
    "configs/llama3_405b.py", "configs/__init__.py", "data/tokens.py",
    "data/__init__.py", "sim/budget.py", "sim/faults.py",
    "sim/interference.py", "sim/cosim.py", "sim/reactive.py",
    "sim/scenarios.py", "sim/__init__.py", "analysis/__init__.py",
    "analysis/__main__.py", "analysis/core.py", "analysis/determinism.py",
    "analysis/events_rules.py", "analysis/imports.py",
    "analysis/telemetry_rules.py",
]
#: copies with a documented difference: the names it adds
DIFFERENCES = {"orchestration/controller.py": "device"}


def _rename(module):
    if module == "repro" or module.startswith("repro."):
        return "repro_torch" + module[len("repro"):]
    return module


class _Normalise(ast.NodeTransformer):
    """Drops docstrings and maps ``repro.`` imports to ``repro_torch.``,
    and the package's name as a word in any string (a dotted path in
    ``sim/__init__.py``'s lazy map, the bare ``"repro"`` and
    ``"src/repro"`` the contract checker scans) to ``repro_torch``."""

    def _drop_docstring(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = _drop_docstring
    visit_FunctionDef = visit_AsyncFunctionDef = _drop_docstring

    def visit_ImportFrom(self, node):
        if node.level == 0:
            node.module = _rename(node.module)
        return node

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = _rename(alias.name)
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = re.sub(r"\brepro\b", "repro_torch", node.value)
        return node


class _Remove(ast.NodeTransformer):
    """Takes a documented addition out: every parameter, keyword
    argument and annotated field called ``name``."""

    def __init__(self, name):
        self.name, self.removed = name, 0

    def visit_arguments(self, node):
        self.generic_visit(node)
        keep = [a.arg != self.name for a in node.args]
        n_pos = len(node.args)
        defaults = [None] * (n_pos - len(node.defaults)) + node.defaults
        node.args = [a for a, k in zip(node.args, keep) if k]
        node.defaults = [d for d, k in zip(defaults, keep)
                         if k and d is not None]
        self.removed += keep.count(False)
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        before = len(node.keywords)
        node.keywords = [k for k in node.keywords if k.arg != self.name]
        self.removed += before - len(node.keywords)
        return node

    def visit_AnnAssign(self, node):
        if isinstance(node.target, ast.Name) and node.target.id == self.name:
            self.removed += 1
            return None
        return node


def _tree(package, rel):
    with open(os.path.join(SRC, package, rel)) as f:
        return _Normalise().visit(ast.parse(f.read()))


@pytest.mark.parametrize("rel", COPIES)
def test_module_is_a_copy_of_the_jax_packages(rel):
    want = ast.dump(_tree("repro", rel))
    got = _tree("repro_torch", rel)
    if rel in DIFFERENCES:
        assert ast.dump(got) != want
        remove = _Remove(DIFFERENCES[rel])
        got = remove.visit(got)
        # the field, the parameter and the two places that pass it on
        assert remove.removed == 4
    assert ast.dump(got) == want


def test_sharding_rules_equal_the_references():
    """``launch/shardings.py``'s rule tables, and ``rules_for`` with and
    without overrides, are the reference's by value."""
    from repro.launch import shardings as ref
    from repro_torch.launch import shardings as port
    assert port.DEFAULT_RULES == ref.DEFAULT_RULES
    assert port.EXPERT_PARALLEL_RULES == ref.EXPERT_PARALLEL_RULES
    for overrides in ((), (("expert", ("model",)), ("mlp", ()))):
        assert port.rules_for(None, None, overrides) == ref.rules_for(
            None, None, overrides)


# ---------------------------------------------------------------------------
# the quickstart's inputs through both packages
# ---------------------------------------------------------------------------

def _quickstart(port):
    if port:
        from repro_torch.core import flat_fl_cost, hfl_cost
        from repro_torch.data.traffic import generate, select_fl_sensors
        from repro_torch.orchestration import (DeviceNode, EdgeNode,
                                               Inventory, LearningController)
        from repro_torch.routing import SimConfig, compare_methods
    else:
        from repro.core import flat_fl_cost, hfl_cost
        from repro.data.traffic import generate, select_fl_sensors
        from repro.orchestration import (DeviceNode, EdgeNode, Inventory,
                                         LearningController)
        from repro.routing import SimConfig, compare_methods
    ds = generate(num_days=30, seed=0)
    sensors = select_fl_sensors(ds, per_cluster=2, seed=0)
    lam = np.random.default_rng(0).uniform(2.0, 6.0, len(sensors))
    devices = [DeviceNode(i, lam=float(lam[i]),
                          lan_edge=int(ds.cluster_of[sensors[i]]))
               for i in range(len(sensors))]
    edges = [EdgeNode(j, capacity_rps=float(lam.sum() / 4 * 1.4))
             for j in range(4)]
    controller = LearningController(Inventory(devices, edges), l=2)
    assign = controller.deploy().topology.assign
    inst = controller.inventory.to_instance(l=2)
    logs = compare_methods(inst, {"flat": None, "hflop": assign},
                           SimConfig(duration_s=60, seed=0))
    return {"sensors": sensors, "assign": assign,
            "latency": {k: (log.mean_latency(), log.std_latency(),
                            log.tier_fractions())
                        for k, log in logs.items()},
            "costs": [dataclasses.asdict(flat_fl_cost(inst.n,
                                                      total_rounds=100)),
                      dataclasses.asdict(hfl_cost(inst, assign,
                                                  total_rounds=100))]}


@pytest.fixture(scope="module")
def quickstarts():
    return _quickstart(port=True), _quickstart(port=False)


def test_quickstart_topology_is_identical(quickstarts):
    got, want = quickstarts
    np.testing.assert_array_equal(got["sensors"], want["sensors"])
    np.testing.assert_array_equal(got["assign"], want["assign"])
    assert (got["assign"] >= 0).all()


def test_quickstart_routing_latencies_are_identical(quickstarts):
    got, want = quickstarts
    assert set(got["latency"]) == {"flat", "hflop"}
    assert got["latency"] == want["latency"]
    assert all(np.isfinite(m) and np.isfinite(s)
               for m, s, _ in got["latency"].values())


def test_quickstart_costs_are_identical(quickstarts):
    got, want = quickstarts
    assert got["costs"] == want["costs"]
    assert got["costs"][1]["metered_bytes"] < got["costs"][0]["metered_bytes"]
