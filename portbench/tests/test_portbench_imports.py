"""No module under portbench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and nothing under portbench/reference/ imports the port."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "graphnets_tpu"}
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_the_guard_compares_whole_names():
    assert "graphnets_tpu_torch" not in FORBIDDEN
    assert "graphnets_tpu" in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "graphnets_tpu_torch" not in top_level_imports(path)
