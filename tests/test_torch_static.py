"""Static checks of the PyTorch port's sources: the repository's stdlib-AST
lint (tests/test_static_analysis.py), and no import of jax or of the JAX
package anywhere in the port or in chip_smoke.py."""

import ast
from pathlib import Path

import pytest

from test_static_analysis import _module_lint

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "satellite_approximation_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
IDS = [str(p.relative_to(REPO)) for p in SOURCES]


def _imported_roots(tree: ast.AST) -> set[str]:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_found():
    assert len(SOURCES) >= 15
    assert (PORT / "csrc" / "jacobi.cu").exists() and (PORT / "csrc" / "residual.cu").exists()


@pytest.mark.parametrize("path", SOURCES, ids=IDS)
def test_lint_clean_and_no_jax(path):
    problems = _module_lint(path)
    assert not problems, "lint findings:\n" + "\n".join(problems)
    roots = _imported_roots(ast.parse(path.read_text(), filename=str(path)))
    assert not roots & {"jax", "jaxlib", "satellite_approximation_tpu"}, roots
