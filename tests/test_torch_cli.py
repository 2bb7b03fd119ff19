"""The port's three command-line entry points (``cli/``) held against the JAX
package's on the same files, on the CPU: the port with ``--device cpu``,
the reference with its C++ library patched away
(``torch_parity.jax_package_without_native``).

- ``laplace_main`` on a 48x64 PNG: the written PNG equal, except that a
  pixel whose JAX value lies within 1e-5 of an integer may differ by one
  level (the u8 cast truncates a solve held to 1e-5);
- ``poisson_main`` on a 6-page 40x48 TIFF: within 1e-5 a pixel, the closed
  mask bit-equal;
- ``cloud_detection_main`` on ``mini_scene(256)`` written as GeoTIFFs: the
  four masks bit-equal, the printed line equal, ``cached`` on a second run.

Beside them: the console scripts point into the port, ``python -m`` runs a
CLI, and a CLI without ``--device`` on a host without CUDA fails with the
resolver's error instead of running on the CPU."""

import subprocess
import sys
import tomllib
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from satellite_approximation_tpu.cli import cloud_detection_main as j_detect_main
from satellite_approximation_tpu.cli import laplace_main as j_laplace_main
from satellite_approximation_tpu.cli import poisson_main as j_poisson_main
from satellite_approximation_tpu.models import laplace as j_laplace
from satellite_approximation_tpu.ops import morphology as j_morphology
from satellite_approximation_tpu_torch.cli import cloud_detection_main as t_detect_main
from satellite_approximation_tpu_torch.cli import laplace_main as t_laplace_main
from satellite_approximation_tpu_torch.cli import poisson_main as t_poisson_main
from satellite_approximation_tpu_torch.utils.geotiff import GeoTIFF, write_geotiff
from satellite_approximation_tpu_torch.utils.tiffmb import write_multiband_tiff
from torch_parity import jax_package_without_native, mini_scene, smooth

REPO = Path(__file__).resolve().parent.parent
MASKS = ("cloud_mask", "potential_shadows", "object_based_shadows", "shadow_mask")


def run(main, argv) -> tuple[int, str]:
    out = StringIO()
    with redirect_stdout(out):
        code = main([str(a) for a in argv])
    return code, out.getvalue()


# ------------------------------------------------------------------ laplace_main


def laplace_inputs(tmp_path: Path, seed: int, h=48, w=64):
    """An RGB base PNG (three smooth fields scaled to u8) and a marker PNG
    whose red/green pixels mark a few ellipses."""
    base = np.stack([smooth(h, w, seed + c) for c in range(3)], axis=-1)
    base = (base / base.max() * 255).astype(np.uint8)
    rng = np.random.default_rng(seed)
    marker = (rng.random((h, w, 3)) * 200).astype(np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(4):
        cy, cx, ry, rx = rng.integers(4, h - 4), rng.integers(4, w - 4), *rng.integers(2, 9, 2)
        blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        marker[blob, 0] = rng.integers(220, 256)
        marker[blob, 1] = rng.integers(0, 151)
    Image.fromarray(base).save(tmp_path / "base.png")
    Image.fromarray(marker).save(tmp_path / "marker.png")
    return base, marker


@pytest.mark.parametrize("threshold", [None, 230.0])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_laplace_main_matches_jax(tmp_path, seed, threshold):
    base, marker = laplace_inputs(tmp_path, seed)
    extra = [] if threshold is None else ["--red-threshold", threshold]
    files = [tmp_path / "base.png", tmp_path / "marker.png"]
    assert run(t_laplace_main.main, [*files, tmp_path / "port.png", "--device", "cpu", *extra])[0] == 0
    assert run(j_laplace_main.main, [*files, tmp_path / "jax.png", *extra])[0] == 0
    got = np.asarray(Image.open(tmp_path / "port.png")).astype(int)
    want = np.asarray(Image.open(tmp_path / "jax.png")).astype(int)
    assert got.shape == want.shape == base.shape

    value = j_laplace.apply_laplace(base.astype(np.float64), marker,
                                    red_threshold=threshold or 220.0)
    assert np.array_equal(np.clip(value, 0, 255).astype(np.uint8), want)
    near_integer = np.abs(value - np.round(value)) <= 1e-5
    differ = got != want
    assert not (differ & ~near_integer).any()
    assert (np.abs(got - want) <= 1).all()
    invalid = (marker[..., 0] >= (threshold or 220.0)) & (marker[..., 1] <= 150)
    assert np.array_equal(got[~invalid], base[~invalid])
    assert (got[invalid] != base[invalid]).any()


def test_laplace_main_as_module(tmp_path):
    """``python -m`` runs the entry point (the console script's module)."""
    laplace_inputs(tmp_path, 4, h=20, w=24)
    proc = subprocess.run(
        [sys.executable, "-m", "satellite_approximation_tpu_torch.cli.laplace_main",
         tmp_path / "base.png", tmp_path / "marker.png", tmp_path / "out.png", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert np.asarray(Image.open(tmp_path / "out.png")).shape == (20, 24, 3)


# ------------------------------------------------------------------ poisson_main


def poisson_inputs(tmp_path: Path, seed: int, layout: str, h=40, w=48):
    """A 6-page f32 TIFF (5 bands, band 6 the cloud band) and a 5-band
    replacement, as PIL pages or as one planar multi-band file."""
    rng = np.random.default_rng(seed)
    bands = np.stack([smooth(h, w, seed + k) for k in range(5)])
    cloud = np.zeros((h, w), np.float32)
    for _ in range(3):
        r0, c0 = rng.integers(3, h - 12), rng.integers(3, w - 14)
        cloud[r0 : r0 + rng.integers(3, 9), c0 : c0 + rng.integers(3, 11)] = rng.integers(1, 4)
    cloud[rng.random((h, w)) > 0.97] = 1.0  # speckle the closing joins or keeps
    repl = np.stack([smooth(h, w, 50 + seed + k) for k in range(5)]) * 1.5
    stack = np.concatenate([bands, cloud[None]])
    if layout == "pages":
        for name, arrs in (("input.tif", stack), ("repl.tif", repl)):
            pages = [Image.fromarray(a) for a in arrs]
            pages[0].save(tmp_path / name, save_all=True, append_images=pages[1:])
    else:
        write_geotiff(stack, tmp_path / "input.tif")
        write_geotiff(repl, tmp_path / "repl.tif")
    return bands, cloud, repl


@pytest.mark.parametrize("layout", ["pages", "planar"])
@pytest.mark.parametrize("seed", [5, 6])
def test_poisson_main_matches_jax(tmp_path, seed, layout):
    outs = {}
    for tag, main in (("port", t_poisson_main.main), ("jax", j_poisson_main.main)):
        work = tmp_path / tag
        work.mkdir()
        bands, cloud, repl = poisson_inputs(work, seed, layout)
        argv = [work / "input.tif", work / "repl.tif"] + (["--device", "cpu"] if tag == "port" else [])
        assert run(main, argv)[0] == 0
        written = sorted((work / "poisson_simple_replace").glob("*.tif"))
        assert [p.name for p in written] == ["input.tif"]
        outs[tag] = GeoTIFF.open(written[0])
    got, want = outs["port"].read_all(), outs["jax"].read_all()
    assert outs["port"].num_bands == 5 and got.shape == want.shape == bands.shape
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    mask = t_poisson_main.preprocess_cloud_band(cloud, device="cpu")
    ref = j_poisson_main.preprocess_cloud_band(cloud)
    assert mask.dtype == ref.dtype == np.bool_ and np.array_equal(mask, ref)
    assert np.array_equal(ref, np.asarray(j_morphology.close(jnp.asarray(cloud != 0), 5)))
    assert np.array_equal(got[:, ~mask], bands[:, ~mask])
    assert not np.array_equal(got[:, mask], bands[:, mask])


@pytest.mark.parametrize("radius_case", ["empty", "full", "single"])
def test_preprocess_cloud_band_edges(radius_case):
    band = np.zeros((20, 24), np.float32)
    if radius_case == "full":
        band[:] = 2.0
    elif radius_case == "single":
        band[10, 12] = -1.0
    got = t_poisson_main.preprocess_cloud_band(band, device="cpu")
    assert np.array_equal(got, j_poisson_main.preprocess_cloud_band(band))


# ------------------------------------------------------------------ cloud_detection_main

N = 256
# a georeferenced template: 20 m pixels in degrees, WGS84
GEO_TAGS = [
    (33550, 12, (1.8e-4, 1.8e-4, 0.0)),
    (33922, 12, (0.0, 0.0, 0.0, -113.0, 51.0, 0.0)),
    (34735, 3, (1, 1, 0, 2, 1024, 0, 1, 2, 2048, 0, 1, 4326)),
]


def detection_folder(base: Path, scene: dict) -> Path:
    folder = base / "2019-05-22"
    folder.mkdir(parents=True)
    template = base / "template.tif"
    write_multiband_tiff(np.zeros((1, 4, 4), np.uint8), template, extra_tags=GEO_TAGS)
    for name, raster in scene.items():
        write_geotiff(raster, folder / f"{name}.tif", template_path=template)
    return folder


@pytest.fixture(scope="module")
def scene():
    return mini_scene(N)


@pytest.mark.parametrize("args", [
    ["--bbox", -113.0, 50.98, -112.98, 51.0],
    [],  # the bbox from B08's geotransform
    ["--skip-shadows-above", 0.01],
], ids=["bbox", "geotransform", "skip-shadows"])
def test_cloud_detection_main_matches_jax(tmp_path, scene, args):
    folders = {tag: detection_folder(tmp_path / tag, scene) for tag in ("port", "jax")}
    code, printed = run(t_detect_main.main, [folders["port"], *args, "--device", "cpu"])
    assert code == 0
    with jax_package_without_native():
        want_code, want_printed = run(j_detect_main.main, [folders["jax"], *args])
    assert want_code == 0
    assert printed == want_printed and printed.startswith("clouds: ")
    assert ("shadows:" in printed) == (args[:1] != ["--skip-shadows-above"])
    for name in MASKS:
        path = folders["port"] / f"{name}.tif"
        if not (folders["jax"] / f"{name}.tif").exists():
            assert not path.exists(), name
            continue
        got = GeoTIFF.open(path)
        want = GeoTIFF.open(folders["jax"] / f"{name}.tif")
        assert np.array_equal(got.read(), want.read()), name
        assert got.geo_transform == want.geo_transform
    assert GeoTIFF.open(folders["port"] / "cloud_mask.tif").read().any()
    assert GeoTIFF.open(folders["port"] / "B08.tif").geo_transform is not None

    # the cache: with both the cloud and the shadow mask written nothing
    # runs; with the shadows skipped the folder is detected again
    again = run(t_detect_main.main, [folders["port"], *args, "--device", "cpu"])
    cached = (folders["port"] / "shadow_mask.tif").exists()
    assert again == (0, "cached: outputs already exist\n" if cached else printed)
    assert cached == (args[:1] != ["--skip-shadows-above"])


# ------------------------------------------------------------------ packaging and devices

SCRIPTS = {
    "sat-torch-laplace": t_laplace_main,
    "sat-torch-poisson": t_poisson_main,
    "sat-torch-cloud-detection": t_detect_main,
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_console_script_resolves_to_the_port(script):
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    module, func = scripts[script].split(":")
    assert module.startswith("satellite_approximation_tpu_torch.cli.")
    mod = SCRIPTS[script]
    assert module == mod.__name__ and getattr(mod, func) is mod.main
    # the JAX package's scripts stay beside them
    assert scripts[script.replace("torch-", "")].startswith("satellite_approximation_tpu.cli.")


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_cli_without_device_needs_cuda(tmp_path, monkeypatch, script):
    laplace_inputs(tmp_path, 7, h=24, w=24)
    poisson_inputs(tmp_path, 7, "pages", h=24, w=24)
    argv = {
        "sat-torch-laplace": [tmp_path / "base.png", tmp_path / "marker.png", tmp_path / "o.png"],
        "sat-torch-poisson": [tmp_path / "input.tif", tmp_path / "repl.tif"],
        "sat-torch-cloud-detection": [tmp_path],
    }[script]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(SCRIPTS[script].main, argv)
    assert not (tmp_path / "o.png").exists()
    assert not (tmp_path / "poisson_simple_replace").exists()
