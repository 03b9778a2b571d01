"""The port stands alone: no file of cmx_torch/ or chip_smoke.py imports
JAX, flax, optax or anything of the cmx package; the CUDA and Triton kernels
are built or imported only inside the functions that launch them."""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cmx", "triton"}
PORT_FILES = sorted((ROOT / "cmx_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, node.module or ""


def _top_level(tree):
    """Import statements executed when the module is imported."""
    top = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            top.add(node)
    return top


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax_and_no_cmx(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    top = _top_level(tree)
    for node, name in _imports(tree):
        root = name.split(".")[0]
        if root == "triton":  # allowed only inside the launching function
            assert node not in top, f"{path}: module-level import of triton"
            continue
        assert root not in FORBIDDEN, f"{path}: imports {name}"


def test_port_modules_import_without_a_gpu_stack():
    for path in sorted((ROOT / "cmx_torch").rglob("*.py")):
        mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))
