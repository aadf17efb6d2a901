"""The port stands alone: no file of ``ndstpu_torch/`` and not
``chip_smoke.py`` imports JAX or the JAX package ``ndstpu``."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
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


OUT_OF_CORE = ("ndstpu_torch/parallel/__init__.py",
               "ndstpu_torch/parallel/mesh.py",
               "ndstpu_torch/parallel/exchange.py",
               "ndstpu_torch/parallel/dplan.py",
               "ndstpu_torch/analysis/cost.py",
               "ndstpu_torch/analysis/lowering.py",
               "ndstpu_torch/io/gdict.py",
               "ndstpu_torch/io/loader.py")


def test_out_of_core_modules_import_without_jax():
    """The out-of-core slice's modules are among the files checked above,
    and importing them (the loader's streaming scan with them) loads no
    module of JAX or of the JAX package."""
    import subprocess
    import sys
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert set(OUT_OF_CORE) <= names
    mods = ", ".join(m[:-3].replace("/", ".").removesuffix(".__init__")
                     for m in OUT_OF_CORE)
    code = (f"import sys, {mods}\n"
            "from ndstpu_torch.io.loader import (ChunkScanPool, "
            "TableChunkSource, attach_stream_source)\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'ndstpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
