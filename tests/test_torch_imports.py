"""The port stands alone: no module of `safediffcon_torch/`, and not
`chip_smoke.py`, imports JAX, flax, optax or the JAX package. Checked on the
source (every import statement, at any depth), so a lazy import inside a
function is caught too. Every module also imports where there is no card,
nvcc or triton: kernels build at their first launch, never at import."""
import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "safediffcon_tpu")
SOURCES = sorted((ROOT / "safediffcon_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_port_sources_exist():
    assert len(SOURCES) > 10 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "safediffcon_torch").rglob("*.py"))


def test_port_reads_arrow_without_datasets_or_pyarrow():
    """The card's host has neither `datasets` nor `pyarrow`: the port reads
    the HF on-disk layout with its own reader (`utils/arrow_ipc.py`)."""
    for path in SOURCES:
        bad = sorted(set(_imported_roots(path)) & {"datasets", "pyarrow"})
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    assert "safediffcon_torch.utils.arrow_ipc" in MODULES
    assert "safediffcon_torch.experiments.round1" in MODULES


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_without_a_card(name):
    from safediffcon_torch.ops import build

    before = dict(build._LOADED)
    importlib.import_module(name)
    assert build._LOADED == before  # no kernel was built or loaded


def _strings_outside_docstrings(path: Path):
    """(line, value) of every string constant of `path` that is not a bare
    string statement (a docstring); comments are not in the tree."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bare = {id(node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in bare):
            yield node.lineno, node.value


def test_names_no_path_of_the_jax_package():
    """No module of the port reads a file of the JAX package: no string
    outside comments and docstrings names `safediffcon_tpu` (the surrogate's
    weights are the port's own copy)."""
    paths = sorted((ROOT / "safediffcon_torch").rglob("*.py"))
    assert len(paths) > 50
    bad = {}
    for path in paths:
        hits = [(line, v) for line, v in _strings_outside_docstrings(path)
                if "safediffcon_tpu" in v]
        if hits:
            bad[str(path.relative_to(ROOT))] = hits
    assert not bad, f"modules of the port name the JAX package: {bad}"
