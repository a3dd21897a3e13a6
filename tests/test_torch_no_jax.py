"""The PyTorch port imports no JAX-family package and nothing of the JAX
package.

A static scan: the test process itself has jax loaded (conftest.py), so
``sys.modules`` cannot tell what the port pulls in.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multimodal_alzheimer_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
             "multimodal_alzheimer_tpu"}
# What the serving front end may import: it runs no tensor code itself.
SERVER_IMPORTS = {"__future__", "concurrent", "numpy", "queue", "threading",
                  "time", "typing"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name: str) -> str:
    return name.split(".")[0]


PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax(path):
    for name in _imports(path):
        assert _top(name) not in FORBIDDEN, f"{path.name} imports {name}"


def test_server_imports_only_the_standard_library_and_numpy():
    """The port's BatchingServer is framework-free: it drives the Predictor
    and never touches a tensor itself."""
    path = PORT / "inference" / "server.py"
    assert {_top(name) for name in _imports(path)} <= SERVER_IMPORTS
