"""The port stands alone: no module under src/repro_torch, and not
chip_smoke.py, imports JAX or the JAX package `repro`."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path}: imports {bad}"


def test_package_is_nonempty():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py").exists()
