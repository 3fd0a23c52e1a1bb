"""Hygiene of the PyTorch port: every source compiles, no tabs or trailing
whitespace (as tests/test_hygiene.py checks the JAX package), and neither the
port nor chip_smoke.py imports JAX, cv2 or the JAX package at any depth: the
machine with the card has none of them."""
import ast
import pathlib
import py_compile

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "opticalflowcontainer_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "cv2", "opticalflowcontainer_tpu")


def _imported_modules(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            mods.add(str(node.args[0].value))
    return mods


def test_port_sources_exist():
    assert (PKG / "__init__.py").is_file() and (ROOT / "chip_smoke.py").is_file()
    assert sorted(p.name for p in (PKG / "ops" / "csrc").glob("*.cu"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_compiles_and_imports_no_jax_or_cv2(path):
    py_compile.compile(str(path), doraise=True)
    bad = sorted(m for m in _imported_modules(path)
                 if m.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path.name} imports {bad}"


def test_no_tabs_or_trailing_whitespace():
    offenders = []
    files = SOURCES + sorted((PKG / "ops" / "csrc").glob("*.cu"))
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if "\t" in line:
                offenders.append(f"{f.name}:{i} tab")
            elif line != line.rstrip():
                offenders.append(f"{f.name}:{i} trailing ws")
    assert not offenders, offenders[:10]


def test_relative_imports_stay_inside_the_port():
    """A relative import climbing out of the package would reach the JAX
    package beside it."""
    for path in PKG.rglob("*.py"):
        depth = len(path.relative_to(PKG).parts) - 1
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level - 1 <= depth, f"{path}: level {node.level}"
