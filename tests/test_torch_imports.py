"""The port stands alone: no file of ``ndstpu_torch/`` and not
``chip_smoke.py`` imports JAX or the JAX package ``ndstpu``."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "ndstpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_has_files():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ndstpu_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "ndstpu")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
