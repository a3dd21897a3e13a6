"""The PyTorch port imports no JAX-family package and nothing of the JAX
package, and needs nothing that the machine with the card lacks.

A static scan: the test process itself has jax loaded (conftest.py), so
``sys.modules`` cannot tell what the port pulls in. The card's machine has
no pandas, yaml, plotting packages or optuna: no module of the port, and
not chip_smoke.py, imports one of them at module level, only the
confusion-matrix rendering (``metrics/confusion_plot.py``, reached only when
a caller asks for images) imports plotting packages, inside its functions,
and only ``train/hpo.py``'s ``create_study`` tries optuna, inside the
function, falling back to the TPE shim.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multimodal_alzheimer_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
             "multimodal_alzheimer_tpu"}
NOT_ON_THE_CARD = {"pandas", "yaml", "matplotlib", "seaborn", "PIL",
                   "optuna"}
PLOTTING = {"pandas", "matplotlib", "seaborn", "PIL"}
RENDERING = PORT / "metrics" / "confusion_plot.py"
STUDY = PORT / "train" / "hpo.py"
# What the serving front end may import: it runs no tensor code itself.
SERVER_IMPORTS = {"__future__", "concurrent", "numpy", "queue", "threading",
                  "time", "typing"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _module_level_imports(path: Path):
    """Imports that run when the module is imported: every import outside a
    function body (under ``if`` and ``try`` at module level too)."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (alias.name for alias in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module
            yield from walk(child)

    yield from walk(ast.parse(path.read_text(), str(path)))


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


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_nothing_the_card_lacks_at_module_level(path):
    for name in _module_level_imports(path):
        assert _top(name) not in NOT_ON_THE_CARD, \
            f"{path.name} imports {name} at module level"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_only_the_rendering_route_imports_plotting_packages(path):
    """yaml nowhere; pandas and the plotting packages only in the functions
    of metrics/confusion_plot.py; optuna only in train/hpo.py's
    functions."""
    allowed = {RENDERING: PLOTTING, STUDY: {"optuna"}}.get(path, set())
    for name in _imports(path):
        top = _top(name)
        assert top not in NOT_ON_THE_CARD or top in allowed, \
            f"{path.name} imports {name}"


def test_the_scan_sees_function_level_imports():
    """The rendering module does import the plotting packages, and the
    study factory optuna, inside functions: the scan must find them there
    and only there."""
    assert {_top(n) for n in _imports(RENDERING)} >= PLOTTING
    assert not {_top(n) for n in _module_level_imports(RENDERING)} & PLOTTING
    assert "optuna" in {_top(n) for n in _imports(STUDY)}
    assert "optuna" not in {_top(n) for n in _module_level_imports(STUDY)}


# The entry points a user calls; each takes ``device`` and defaults to the
# card (the tests pass "cpu").
ENTRY_POINTS = {"main", "train", "train_anat", "train_anat_fast",
                "optuna_optimization", "run_training", "evaluate",
                "evaluate_checkpoint", "evaluate_tabpfn"}
CLIS = ("convert_medicalnet", "convert_reference", "export_artifact",
        "quality_eval")


def _device_defaults(path: Path):
    """{function name: the default of its ``device`` argument} for the
    module-level entry-point functions of ``path`` that take one."""
    out = {}
    for node in ast.parse(path.read_text(), str(path)).body:
        if not (isinstance(node, ast.FunctionDef)
                and node.name in ENTRY_POINTS):
            continue
        args = node.args.args + node.args.kwonlyargs
        defaults = ([None] * (len(node.args.args) - len(node.args.defaults))
                    + node.args.defaults + node.args.kw_defaults)
        for arg, default in zip(args, defaults):
            if arg.arg == "device":
                out[node.name] = (default.value if isinstance(
                    default, ast.Constant) else default)
    return out


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_entry_points_default_to_the_card(path):
    for name, default in _device_defaults(path).items():
        assert default == "cuda", f"{path.name}:{name} device={default!r}"


@pytest.mark.parametrize("name", CLIS)
def test_deployment_clis_take_a_device(name):
    path = PORT / "tools" / f"{name}.py"
    assert _device_defaults(path) == {"main": "cuda"}
