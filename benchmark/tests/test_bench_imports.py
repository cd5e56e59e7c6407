"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the plain
reference imports nothing of the port: each module's imports read by AST,
each name compared by its part before the first dot, whole (the port's
name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "gb25_tpu"}


def imported(path):
    """The top-level names a module imports (relative imports excepted)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert "gb25_tpu_torch" not in imported(path)


def test_the_guard_reads_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import gb25_tpu_torch.models\nfrom jax import numpy\n"
                 "import importlib\nimportlib.import_module('gb25_tpu.ops')\n")
    assert imported(f) == {"gb25_tpu_torch", "jax", "importlib", "gb25_tpu"}
    assert imported(f) & FORBIDDEN == {"jax", "gb25_tpu"}
