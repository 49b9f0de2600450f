"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and every
``examples/*_torch.py`` import neither JAX nor anything of the JAX
package ``repro``.  Checked
twice: at run time, importing every module of the port in a subprocess
where a meta-path finder blocks ``jax``, ``jaxlib`` and ``repro``; and
statically, by an AST scan of every import."""
import ast
import glob
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")

BLOCKER = textwrap.dedent("""
    import sys

    BLOCKED = %r

    class _Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} imported while blocked")
            return None

    sys.meta_path.insert(0, _Blocker())
""" % (FORBIDDEN,))


def _port_modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def _run_blocked(body):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", BLOCKER + body],
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_blocker_blocks_the_jax_package_but_not_the_port():
    proc = _run_blocked("import repro\n")
    assert proc.returncode != 0 and "blocked" in proc.stderr
    proc = _run_blocked("import repro_torch\nprint('ok')\n")
    assert proc.returncode == 0, proc.stderr


def test_every_port_module_imports_with_jax_and_repro_blocked():
    modules = _port_modules()
    assert "repro_torch.serving.replica" in modules
    assert "repro_torch.kernels.gru_cell" in modules
    for m in ("training.optimizer", "training.train_step", "fl.collectives",
              "fl.compression", "data.tokens", "launch.train", "launch.mesh",
              "launch.shardings", "launch.specs", "launch.analytic",
              "launch.roofline", "launch.dryrun", "models.sharded",
              "sim.budget", "sim.faults", "sim.interference", "sim.cosim",
              "sim.reactive", "sim.scenarios"):
        assert "repro_torch." + m in modules
    body = "".join(f"import {m}\n" for m in modules)
    body += "import sys\nprint(sorted(m for m in sys.modules " \
            "if m.split('.')[0] in BLOCKED))\n"
    proc = _run_blocked(body)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _scanned_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    files += glob.glob(os.path.join(ROOT, "examples", "*_torch.py"))
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_every_port_example_is_scanned():
    names = {os.path.basename(p) for p in _scanned_files()}
    assert {f"{e}_torch.py" for e in (
        "quickstart", "tiered_serving", "train_lm_hfl",
        "continual_hfl_traffic", "orchestrate_dynamic",
        "reactive_orchestration", "scenario_suite",
        "trace_reactive_run")} <= names


@pytest.mark.parametrize("path", _scanned_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


# ---------------------------------------------------------------------------
# contract LAYER001 / LAYER002 on the port: the numpy-only layers and the
# lazy facades import without torch, as the reference's import without jax
# (tests/test_import_contracts.py)
# ---------------------------------------------------------------------------

PROTECTED = ["repro_torch.routing", "repro_torch.sim", "repro_torch.core",
             "repro_torch.telemetry", "repro_torch.configs",
             "repro_torch.fl.schedule"]
FACADES = ["repro_torch.serving", "repro_torch.fl"]
TORCH_BLOCKER = BLOCKER.replace(repr(FORBIDDEN),
                                repr(FORBIDDEN + ("torch",)))


@pytest.mark.parametrize("module", PROTECTED + FACADES)
def test_protected_namespace_imports_with_torch_blocked(module):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-c",
         TORCH_BLOCKER + f"import {module}\nprint('imported-ok')\n"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported-ok" in proc.stdout


def test_torch_blocker_blocks_torch():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", TORCH_BLOCKER
                           + "import repro_torch.serving.engine\n"],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0 and "torch imported while blocked" \
        in proc.stderr


def test_normal_import_keeps_torch_out_until_a_lazy_name_is_read():
    body = "".join(f"import {m}\n" for m in PROTECTED + FACADES)
    body += textwrap.dedent("""
        import sys
        import repro_torch
        assert "torch" not in sys.modules, "torch leaked in"
        from repro_torch.serving import poisson_requests
        from repro_torch.fl import round_schedule
        assert "torch" not in sys.modules, "torch leaked in"
        pool = repro_torch.serving.ReplicaPool
        assert "torch" in sys.modules
        assert pool.__module__ == "repro_torch.serving.replica"
        from repro_torch import resolve_device
        assert str(resolve_device("cpu")) == "cpu"
        assert repro_torch.fl.fedavg.__module__ == "repro_torch.fl.aggregation"
        print("lazy-ok")
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", body], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "lazy-ok" in proc.stdout


@pytest.mark.parametrize("facade", ["repro_torch", "repro_torch.serving",
                                    "repro_torch.fl"])
def test_facade_names_resolve(facade):
    """Every name a facade exports resolves, and an unknown one raises
    AttributeError."""
    import importlib
    mod = importlib.import_module(facade)
    for name in mod.__all__:
        assert getattr(mod, name) is not None, name
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_name")
