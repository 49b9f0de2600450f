"""What the harness may import: no JAX and no JAX package anywhere (top-
level names compared whole, so ``repro_torch`` is not ``repro``), the
port only in ``benchkit/program.py`` (and the faults planted in it),
and in ``reference/`` nothing of the port or of the harness but the
architectures' modules (``configs/``), which import no port either."""
import ast
import sys
from pathlib import Path

import pytest

import run
from benchkit.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _top_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not set(_top_names(path)) & FORBIDDEN


def test_port_only_through_program():
    users = {p.relative_to(BENCH_DIR).as_posix() for p in SOURCES
             if "repro_torch" in set(_top_names(p))
             and "tests" not in p.parts}
    # the system under test, and the faults planted in it for the tests
    assert users == {"benchkit/program.py", "benchkit/faults.py"}


def test_reference_is_plain():
    for p in (BENCH_DIR / "reference").glob("*.py"):
        names = set(_top_names(p))
        assert not names & {"repro_torch", "benchkit", "repro"}, p
        assert names <= {"__future__", "contextlib", "math", "typing",
                         "torch", "reference", "configs"}, (p, names)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchkit import program  # noqa: F401  (loads repro_torch)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.sim", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["jaxlib", "repro"]
