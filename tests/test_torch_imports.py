"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and
``examples/quickstart_torch.py`` import neither JAX nor anything of the
JAX package ``repro``.  Checked twice: at run time, importing every
module of the port in a subprocess where a meta-path finder blocks
``jax``, ``jaxlib`` and ``repro``; and statically, by an AST scan of
every import."""
import ast
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
    body = "".join(f"import {m}\n" for m in modules)
    body += "import sys\nprint(sorted(m for m in sys.modules " \
            "if m.split('.')[0] in BLOCKED))\n"
    proc = _run_blocked(body)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _scanned_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "examples", "quickstart_torch.py")]
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


@pytest.mark.parametrize("path", _scanned_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
