"""No file the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program.  Module names are
compared by their whole top-level name: the port's begins with the JAX
package's."""
import ast

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "phd_qmclib_tpu", "bench",
             "benchmarks", "chip_smoke"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((BENCH / "reference").rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "phd_qmclib_torch" not in top_level_imports(path)


def test_the_check_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom phd_qmclib_tpu import x\n"
                   "import phd_qmclib_torch\n")
    names = top_level_imports(bad)
    assert names & FORBIDDEN == {"jax", "phd_qmclib_tpu"}
    assert "phd_qmclib_torch" in names
