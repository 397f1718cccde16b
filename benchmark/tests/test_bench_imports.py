"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port.  Names are compared by whole
top-level module name: ``pympc_quadruped_tpu_torch`` is not
``pympc_quadruped_tpu``."""
import ast
from pathlib import Path

import pytest

from benchmark.harness import guard

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(guard.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert top_level_imports(path) <= {"__future__", "dataclasses", "math", "numpy", "torch",
                                       "benchmark"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("benchmark"):
            assert node.module.startswith("benchmark.reference")


def test_guard_compares_whole_names():
    assert guard.forbidden_loaded({"pympc_quadruped_tpu_torch": 1, "torch": 1, "jaxtyping": 1}) == []
    assert guard.forbidden_loaded({"jax.numpy": 1, "pympc_quadruped_tpu.ops": 1}) == [
        "jax.numpy", "pympc_quadruped_tpu.ops"]
