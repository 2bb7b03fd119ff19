"""Static checks of the PyTorch port's sources: the repository's stdlib-AST
lint (tests/test_static_analysis.py), no import of jax or of the JAX
package anywhere in the port, chip_smoke.py or chip_profile.py, no
``torch.compile`` (the port's arithmetic is eager ops, rounded one by one),
no handler in chip_smoke.py that could catch a failed phase while the run
goes on, and console scripts of the port that point into the port."""

import ast
import tomllib
from pathlib import Path

import pytest

from test_static_analysis import _module_lint

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "satellite_approximation_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_profile.py"]
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


@pytest.mark.parametrize("path", SOURCES, ids=IDS)
def test_no_torch_compile(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id == "torch":
            assert node.attr not in ("compile", "jit"), f"{path.name}:{node.lineno}: torch.{node.attr}"


def test_detection_modules_are_covered():
    have = set(IDS)
    for rel in (
        "ops/masks.py", "ops/stats.py", "ops/image.py", "ops/blur.py", "ops/morphology.py",
        "ops/geometry.py", "ops/pitfill.py", "ops/components.py", "native/__init__.py",
        "utils/geotiff.py", "utils/tiffmb.py", "utils/types.py", "utils/profiling.py",
        "utils/errors.py", "utils/dates.py", "utils/filesystem.py", "utils/db.py", "utils/loader.py",
        "models/detection/cloud_mask.py", "models/detection/shadow_mask.py",
        "models/detection/matching.py", "models/detection/refinement.py",
        "models/detection/refinement_torch.py", "models/detection/evaluation.py",
        "models/detection/pipeline.py", "indices.py", "models/closest.py",
        "utils/imageio.py", "utils/rasterio_.py", "utils/compute.py", "utils/__init__.py",
        "cli/__init__.py", "cli/laplace_main.py", "cli/poisson_main.py",
        "cli/cloud_detection_main.py",
    ):
        assert f"satellite_approximation_tpu_torch/{rel}" in have, rel


def test_chip_smoke_phases_cannot_fail_quietly():
    """Every phase raises on failure and nothing catches it: the script has
    no bare ``except`` and no handler for ``Exception`` / ``BaseException``,
    and ``main`` runs the detection and entry-point phases beside the others."""
    path = REPO / "chip_smoke.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            assert node.type is not None, f"bare except at line {node.lineno}"
            names = {n.id for n in ast.walk(node.type) if isinstance(n, ast.Name)}
            assert not names & {"Exception", "BaseException"}, f"broad except at line {node.lineno}"
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    called = {n.func.id for n in ast.walk(main) if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert {"phase_device", "phase_build", "phase_kernels", "phase_main_path", "phase_full_tile",
            "phase_general_iterate", "phase_benchmark_paths", "phase_detect",
            "phase_entry_points"} <= called


def test_console_scripts_point_into_the_port():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    ours = {name: target for name, target in scripts.items() if name.startswith("sat-torch-")}
    assert sorted(ours) == ["sat-torch-cloud-detection", "sat-torch-laplace", "sat-torch-poisson"]
    for target in ours.values():
        module, func = target.split(":")
        assert module.startswith("satellite_approximation_tpu_torch.cli.") and func == "main"
        assert (REPO / (module.replace(".", "/") + ".py")).exists(), module
