"""The port stands alone: no module of ``dispersy_tpu_torch`` and no line of
``chip_smoke.py`` imports JAX, jaxlib, flax or the JAX package (importing
even a JAX-free module of ``dispersy_tpu`` runs its ``__init__``, which
pulls in JAX)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dispersy_tpu"}
SOURCES = sorted((ROOT / "dispersy_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"engine.py", "bridge.py", "chip_smoke.py", "intake_triton.py",
            "timeline.py", "profiling.py"} <= names
