"""What the benchmark may import: nothing of JAX or the JAX package
anywhere, nothing of the program in the reference, and the program only
through ``lib/port.py``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "multimodal_alzheimer_tpu"}
PORT = "multimodal_alzheimer_tpu_torch"


def top_level_imports(path: Path) -> set:
    """Top-level names of every module a file imports, compared whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in top_level_imports(path)


def test_the_program_only_through_port():
    users = {str(p.relative_to(BENCH)) for p in SOURCES
             if PORT in top_level_imports(p)}
    assert users == {"lib/port.py"}


def test_whole_names_are_compared():
    from benchmark import run

    assert "multimodal_alzheimer_tpu_torch".split(".")[0] not in run.FORBIDDEN
    assert "multimodal_alzheimer_tpu" in run.FORBIDDEN
