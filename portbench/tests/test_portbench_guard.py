"""What portbench may load: never JAX or the JAX package ``repro``
(compared by whole top-level module name: ``repro_torch`` is not
``repro``), never the JAX package's ``benchmarks/``; and the references
nothing of the program."""
import ast
from pathlib import Path

import pytest

from portbench import harness

SOURCES = sorted(p for p in harness.PKG.rglob("*.py")
                 if "__pycache__" not in p.parts)


def imported(path: Path):
    """Top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def strings(path: Path):
    return [n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(harness.PKG))
                              for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & set(harness.FORBIDDEN)
    if "tests" in path.relative_to(harness.PKG).parts:
        return      # the tests spell the forbidden names out to check them
    # nothing names the JAX package's folder or modules as a path to load
    for s in strings(path):
        assert "benchmarks/" not in s and not s.startswith("repro.")


@pytest.mark.parametrize("path", sorted(
    (harness.PKG / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)
    assert imported(path) <= {"__future__", "math", "typing", "numpy",
                              "torch", "portbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference")


def test_the_guard_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                   "import repro_torch\n")
    assert imported(bad) & set(harness.FORBIDDEN) == {"jax", "repro"}
