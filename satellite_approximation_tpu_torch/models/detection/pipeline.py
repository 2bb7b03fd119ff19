"""The full detection pipeline: detect / detect_clouds / detect_in_folder
(``satellite_approximation_tpu/models/detection/pipeline.py``).

Rebuild of lib/cloud_shadow_detection/source/automatic_detection.cpp. Where
the reference lazily spins up an OpenCL context and compiles kernels
(automatic_detection.cpp:87-89), every entry point here takes ``device=``:
``None`` is the CUDA device (and raises without one), ``"cpu"`` runs the
same torch ops on the CPU.
"""

from __future__ import annotations

import dataclasses
import threading
from pathlib import Path

import numpy as np
import torch

from ...config import DEFAULT_DETECTION, DetectionConfig
from ...device import as_tensor, divide, resolve_device
from ...ops import geometry
from ...ops.masks import fetch_mask
from ...utils.dates import Date
from ...utils.db import DataBase
from ...utils.filesystem import multispectral_folders
from ...utils.geotiff import GeoTIFF, write_geotiff_deflated
from ...utils.log import create_logger
from ...utils.perf import Stopwatch
from ...utils import profiling
from ...utils.profiling import StageTimer
from ...utils.types import percent_non_zero
from . import cloud_mask as cm
from . import matching, placement, refinement, refinement_torch
from . import shadow_mask as sm

_logger = create_logger("detection.pipeline")

_overlap_executor = None


_overlap_lock = threading.Lock()


def _get_overlap_executor():
    """Shared 3-worker pool for the big-scene mask writes (D2H fetch + TIFF
    encode ride the host and the disk while the device stages run; no data
    deps)."""
    global _overlap_executor
    with _overlap_lock:
        if _overlap_executor is None:
            from concurrent.futures import ThreadPoolExecutor

            _overlap_executor = ThreadPoolExecutor(
                max_workers=3, thread_name_prefix="sat-overlap"
            )
    return _overlap_executor


@dataclasses.dataclass
class CloudParams:
    """Input/output path conventions for one date folder
    (automatic_detection.cpp:40-71)."""

    nir_path: Path = Path()
    clp_path: Path = Path()
    cld_path: Path = Path()
    scl_path: Path = Path()
    rgb_path: Path = Path()
    view_zenith_path: Path = Path()
    view_azimuth_path: Path = Path()
    sun_zenith_path: Path = Path()
    sun_azimuth_path: Path = Path()

    @classmethod
    def from_root(cls, root: Path | str) -> "CloudParams":
        root = Path(root)
        return cls(
            nir_path=root / "B08.tif",
            clp_path=root / "CLP.tif",
            cld_path=root / "CLD.tif",
            scl_path=root / "SCL.tif",
            rgb_path=root / "RGB.tif",
            view_zenith_path=root / "viewZenithMean.tif",
            view_azimuth_path=root / "viewAzimuthMean.tif",
            sun_zenith_path=root / "sunZenithAngles.tif",
            sun_azimuth_path=root / "sunAzimuthAngles.tif",
        )

    def cloud_path(self) -> Path:
        return self.nir_path.parent / "cloud_mask.tif"

    def shadow_potential_path(self) -> Path:
        return self.nir_path.parent / "potential_shadows.tif"

    def object_based_shadow_path(self) -> Path:
        return self.nir_path.parent / "object_based_shadows.tif"

    def shadow_path(self) -> Path:
        return self.nir_path.parent / "shadow_mask.tif"


@dataclasses.dataclass
class SkipShadowDetection:
    """Skip the slow shadow stage when cloud cover is above ``threshold``
    (automatic_detection.h SkipShadowDetection)."""

    decision: bool = False
    threshold: float = 0.0

    def __repr__(self) -> str:
        return f"<SkipShadowDetection: {self.decision} (threshold: {self.threshold})>"


@dataclasses.dataclass
class Status:
    """Per-date detection result persisted to the DB
    (cloud_shadow_detection/db.h Status)."""

    percent_clouds: float = 0.0
    percent_shadows: float | None = None
    percent_invalid: float = 0.0
    clouds_computed: bool = False
    shadows_computed: bool = False


def get_diagonal_distance(
    min_long: float, min_lat: float, max_long: float, max_lat: float
) -> float:
    """Geodetic diagonal of the scene bbox in km (automatic_detection.cpp:73-78)."""
    return geometry.haversine_distance((min_long, min_lat), (max_long, max_lat))


def _read_normalized_u8(path: Path, max_value: float, inputs: dict[str, np.ndarray] | None = None,
                        device=None) -> torch.Tensor:
    """Decode an integer raster and normalize to [0, 1] f32 ON ``device``.

    The raw u8/u16 bytes upload as they are (2-4x less than host-normalized
    f32) and are divided there in f32 by ``device.divide``: IEEE f32
    division is correctly rounded on the CPU and on a CUDA device, so the
    result is bit-identical to the host numpy f32 division for EVERY
    representable u8/u16 value and all three divisors (held exhaustively by
    the tests, on the CPU and on the card)."""
    dev = resolve_device(device)
    raw = inputs.get(path.stem) if inputs else None
    if raw is None:
        raw = GeoTIFF.open(path).read()
    if raw.dtype == np.uint8:
        values = as_tensor(raw, dev)
    elif raw.dtype == np.uint16:
        # torch has no arithmetic on uint16: the same bytes as int16, made
        # non-negative again on the device
        values = as_tensor(raw.view(np.int16), dev).to(torch.int32) & 0xFFFF
    else:
        return as_tensor(raw.astype(np.float32) / np.float32(max_value), dev)
    return divide(values.to(torch.float32), max_value)


def _read_angles(
    path: Path,
    what: str,
    inputs: dict[str, np.ndarray] | None = None,
    dtype=np.float64,
) -> np.ndarray:
    """``dtype``: the pipeline passes f32 — the LS reductions cast to f32
    anyway, and an f64 upcast would cost ~1 GB of host RAM per full-tile
    raster."""
    raw = inputs.get(path.stem) if inputs else None
    if raw is not None:
        # zero-copy when the caller's raster already has the target dtype
        return np.asarray(raw, dtype)
    try:
        return np.asarray(GeoTIFF.open(path).read(), dtype)
    except Exception as e:  # noqa: BLE001
        raise RuntimeError(f"Failed to open {what} file. Provided path: {path}") from e


def _write_mask(mask, out_path: Path, template: Path) -> None:
    # deflated by zlib, which releases the GIL: a write on a worker does not
    # stall the stages on the calling thread. A bool holds 0 or 1 in a byte,
    # so the mask is written as the u8 view of its own bytes, not a copy
    write_geotiff_deflated(fetch_mask(mask).view(np.uint8), out_path, template_path=template)


def detect(
    params: CloudParams,
    diagonal_distance: float,
    skip_shadow_detection: SkipShadowDetection = SkipShadowDetection(),
    use_cache: bool = True,
    config: DetectionConfig = DEFAULT_DETECTION,
    timer: "StageTimer | None" = None,
    inputs: dict[str, np.ndarray] | None = None,
    mesh="auto",
    device=None,
) -> Status | None:
    """Run the full cloud + shadow detection for one date folder
    (automatic_detection.cpp:80-236). Returns None when cached outputs exist.

    ``timer``: optional StageTimer accumulating per-stage wall times (the
    reference's spdlog stopwatches, automatic_detection.cpp:263-323); give
    it the same ``device`` so that every stage ends with a synchronise.

    ``inputs``: optional pre-decoded rasters keyed by file stem ("B08",
    "CLP", ..., "sunZenithAngles"); rasters present here skip the disk read.
    `detect_in_folder` uses this to overlap TIFF decode of the next dates
    with the current date's compute (the reference decodes every raster on
    the critical path, automatic_detection.cpp:286-324).

    ``mesh``: where the device stages run (``parallel.mesh.resolve_mesh``):
    "auto" (default), None and "off" keep them on ``device``; a
    ``parallel.ShardMesh`` shards them over its shards (the sweep over
    heights, beta over shadows, alpha, the histograms and the final mask
    over rows), bit-equal to the unsharded stages. Only the device-stage
    route (``placement.place``) shards. Anything else raises
    ``ValueError``.

    ``device``: ``None`` is the CUDA device (raises without one); ``"cpu"``
    runs the same stages on the CPU.
    """
    with profiling.call("detect"):
        return _detect(params, diagonal_distance, skip_shadow_detection, use_cache, config,
                       timer, inputs, mesh, device)


def _detect(params, diagonal_distance, skip_shadow_detection, use_cache, config, timer, inputs,
            mesh, device):
    from ...parallel.mesh import resolve_mesh

    dev = resolve_device(device)
    mesh = resolve_mesh(mesh)
    if use_cache and params.cloud_path().exists() and params.shadow_path().exists():
        _logger.debug(
            "Skipping %s because both the clouds and the shadows have been computed",
            params.cloud_path().parent,
        )
        return None

    if timer is None:
        timer = StageTimer(dev)
    status = Status()

    with timer.stage("read inputs"):
        clp = _read_normalized_u8(params.clp_path, 255, inputs, dev)
        cld = _read_normalized_u8(params.cld_path, 100, inputs, dev)
        scl_host = (
            inputs[params.scl_path.stem]
            if inputs and params.scl_path.stem in inputs
            else GeoTIFF.open(params.scl_path).read()
        )
        scl = as_tensor(scl_host, dev)  # upload u8 once; both stages reuse it

        where = placement.place(clp.numel(), dev, config, mesh)
        if where.shadow_on_host:
            # host f32 division of u16 values equals the device
            # normalization bit-for-bit
            raw = inputs.get(params.nir_path.stem) if inputs else None
            if raw is None:
                raw = GeoTIFF.open(params.nir_path).read()
            nir = raw.astype(np.float32) / np.float32(np.iinfo(np.uint16).max)
        else:
            nir = _read_normalized_u8(params.nir_path, np.iinfo(np.uint16).max, inputs, dev)
    shape = tuple(clp.shape)
    timer.routes.update(where.routes(dev))

    _logger.debug(" --- Cloud Detection...")
    with timer.stage("cloud mask"):
        generated = cm.generate_cloud_mask_ignore_low_probability(
            clp, cld, scl, config.cloud_mask, device_output=where.device_stages
        )
        status.clouds_computed = True
        status.percent_clouds = percent_non_zero(generated.cloud_mask)
        status.percent_invalid = status.percent_clouds

    # every write is joined before detect returns, so the on-disk cache
    # contract holds
    pending_writes = []

    def _submit_write(arr, out_path, stage_name):
        def task():
            with timer.stage(stage_name):
                _write_mask(arr, out_path, params.nir_path)

        if where.overlap_writes:
            # the D2H fetch and the TIFF encode hide behind the device stages
            pending_writes.append(_get_overlap_executor().submit(profiling.carry(task)))
        else:
            task()

    try:
        _submit_write(generated.cloud_mask, params.cloud_path(), "write cloud mask")

        if skip_shadow_detection.decision:
            if status.percent_clouds >= skip_shadow_detection.threshold:
                _logger.debug(
                    "Skipping %s because too much of the image is clouds (%.2f%% clouds)",
                    params.cloud_path().parent,
                    status.percent_clouds * 100,
                )
                for fut in pending_writes:
                    fut.result()
                return status

        _logger.debug(" --- Potential Shadow Mask Generation...")
        with timer.stage("potential shadow mask"):
            psm = sm.generate_potential_shadow_mask(
                nir,
                generated.cloud_mask_no_processing,
                scl_host if where.shadow_on_host else scl,
                config.shadow_mask,
                device_output=where.device_stages,
                device=dev,
            )

        # potential-shadow mask is final as soon as the stage ends — its write
        # hides behind the geometry/matching/refinement stages
        _submit_write(psm.mask, params.shadow_potential_path(), "write shadow masks")

        angle_dtype = np.float32  # the LS reduction uses f32 directions
        with timer.stage("read angles"):
            sun_zenith = _read_angles(params.sun_zenith_path, "Sun Zenith", inputs, angle_dtype)
            sun_azimuth = _read_angles(params.sun_azimuth_path, "Sun Azimuth", inputs, angle_dtype)
            view_zenith = _read_angles(params.view_zenith_path, "View Zenith", inputs, angle_dtype)
            view_azimuth = _read_angles(params.view_azimuth_path, "View Azimuth", inputs, angle_dtype)

        _logger.debug(" --- Solving for Sun and Satellite Position...")
        with timer.stage("sun/view geometry"):
            # two equivalent f32-direction reductions (~1e-7 relative
            # agreement, far inside the 25 m height quantization of the
            # downstream sweep): host chunked numpy, or one upload + a
            # bandwidth-bound device pass on the device route
            if where.device_stages:
                def ls_point(zen, azi, *args):
                    return geometry.ls_point_equal_to_device(zen, azi, *args, device=dev)
            else:
                ls_point = geometry.ls_point_equal_to_chunked
            sun_pos = ls_point(
                sun_zenith, sun_azimuth, shape, diagonal_distance,
                config.distance_to_sun_km,
            )
            view_pos = ls_point(
                view_zenith, view_azimuth, shape, diagonal_distance,
                config.distance_to_view_km,
            )
            del sun_zenith, sun_azimuth, view_zenith, view_azimuth

        _logger.debug(" --- Cloud Partitioning...")
        with timer.stage("cloud partition"):
            # the device route's mask is partitioned where it lies (kernel 10
            # on the card) and its id map stays there for the matching's
            # sweep; a host mask takes the native flood
            cloud_map, clouds = cm.partition_cloud_mask(
                generated.cloud_mask_no_processing,
                diagonal_distance,
                config.min_cloud_size_for_ray_casting,
                device=dev,
            )

        _logger.debug(" --- Object-based Shadow Mask Generation...")
        with timer.stage("cloud-shadow matching"):
            # with a mesh the similarity sweep splits its heights over the
            # shards (bit-equal per (height, cloud) cell); the rest of the
            # matching is shared
            sweep_fn = None
            if where.mesh is not None:
                from ...parallel import detect as parallel_detect

                sweep_fn = parallel_detect.sharded_sweep(where.mesh)
            match = matching.match_clouds_shadows(
                clouds,
                cloud_map,
                generated.cloud_mask_no_processing,
                psm.mask,
                diagonal_distance,
                sun_pos,
                view_pos,
                config.matching,
                timer=timer,
                use_native=where.native_matching,
                sweep_fn=sweep_fn,
                device=dev,
            )
        del cloud_map  # a device id map is not held through the refinement

        # object-based shadow mask is final after matching — write it while
        # the refinement stages compute
        _submit_write(
            match.shadow_mask, params.object_based_shadow_path(), "write shadow masks"
        )

        _logger.debug(" --- Generating Probability Function...")
        # the three routes of each stage take the same leading arguments
        ref_cfg, alpha_rows = config.refinement, None
        with timer.stage("alpha map"):
            diff = psm.difference_of_pitfill_nir
            if where.mesh is not None:
                # row shards, padded: the sharded stages below chain on them
                alpha, alpha_rows = parallel_detect.sharded_alpha_map(
                    diff, where.mesh, ref_cfg.alpha_a, ref_cfg.alpha_b, padded_output=True)
            elif where.refine_on_device:
                # stays a tensor: its only consumers are device stages
                alpha = refinement_torch.alpha_map(
                    diff, ref_cfg.alpha_a, ref_cfg.alpha_b, device=dev)
            else:
                alpha = refinement.alpha_map(diff, ref_cfg)
        with timer.stage("beta map"):
            args = (match.shadows, match.solutions, generated.blended_cloud_probability,
                    diagonal_distance)
            if where.mesh is not None:
                # the shadows split over the shards, an exact maximum merges
                beta = parallel_detect.sharded_beta_map(
                    *args, where.mesh, ref_cfg, device_output=True)
            elif where.device_stages:
                # its inputs (blended CLP, shadow windows) are on the device
                beta = refinement_torch.beta_map(*args, ref_cfg, device_output=True, device=dev)
            else:
                # per-shadow EDT windows are cheap on the host at small scales
                beta = refinement.beta_map(*args, ref_cfg)
                if where.refine_on_device:
                    beta = as_tensor(beta, dev)  # upload once; surface + sampling reuse
        with timer.stage("probability surface"):
            args = (match.shadow_mask, alpha, beta)
            if where.mesh is not None:
                # row-sharded histograms, merged by exact int32 sums
                surface = parallel_detect.sharded_probability_map(
                    *args, where.mesh, ref_cfg, rows=alpha_rows)
            elif where.refine_on_device:
                surface = refinement_torch.probability_map(*args, ref_cfg, device=dev)
            else:
                surface = refinement.probability_map(*args, ref_cfg)

        _logger.debug(" --- Final Shadow Mask Generation...")
        with timer.stage("final mask"):
            args = (match.shadow_mask, generated.cloud_mask, alpha, beta, surface,
                    config.probability_threshold)
            if where.mesh is not None:
                final = parallel_detect.sharded_improved_shadow_mask(
                    *args, where.mesh, device_output=where.device_stages, rows=alpha_rows)
                if isinstance(final, torch.Tensor):
                    final = final.to(dev)
            elif where.refine_on_device:
                final = refinement_torch.improved_shadow_mask(
                    *args, device_output=where.device_stages, device=dev)
            else:
                final = refinement.improved_shadow_mask(*args)
        _logger.debug("...Finished Algorithm.")

        status.shadows_computed = True
        status.percent_shadows = percent_non_zero(final)
        total_mask = generated.cloud_mask | final
        status.percent_invalid = percent_non_zero(total_mask)

        _logger.debug("Saving shadow results")
        _submit_write(final, params.shadow_path(), "write shadow masks")
        with timer.stage("write shadow masks (wait)"):
            for fut in pending_writes:
                fut.result()
        return status
    finally:
        # Error paths must not leak orphaned writer threads racing the
        # output files (a caller that catches and retries would collide
        # with them, and their failures would vanish). On success every
        # future was already joined (and raised) above, so this drain is
        # free; on an exception it blocks until writers finish and logs
        # their failures instead of dropping them.
        for fut in pending_writes:
            try:
                fut.result()
            except Exception:
                _logger.exception("background mask write failed")


def detect_clouds(folder: Path | str, db: DataBase, config: DetectionConfig = DEFAULT_DETECTION,
                  device=None) -> Status:
    """Cloud-only variant (automatic_detection.cpp:238-258)."""
    folder = Path(folder)
    dev = resolve_device(device)
    clp = _read_normalized_u8(folder / "CLP.tif", 255, device=dev)
    cld = _read_normalized_u8(folder / "CLD.tif", 100, device=dev)
    scl = GeoTIFF.open(folder / "SCL.tif").read()

    generated = cm.generate_cloud_mask_ignore_low_probability(
        clp, cld, scl, config.cloud_mask, device=dev)
    status = Status(
        clouds_computed=True,
        percent_clouds=percent_non_zero(generated.cloud_mask),
    )
    status.percent_invalid = status.percent_clouds
    _write_mask(generated.cloud_mask, folder / "cloud_mask.tif", folder / "B08.tif")
    db.write_detection_result(Date.from_string(folder.name), status)
    return status


def detect_single_folder(
    directory: Path | str,
    diagonal_distance: float,
    skip_shadow_detection: SkipShadowDetection = SkipShadowDetection(),
    use_cache: bool = True,
    config: DetectionConfig = DEFAULT_DETECTION,
    device=None,
) -> Status | None:
    """Detect one date folder and persist the Status to the parent's DB
    (automatic_detection.cpp:260-284)."""
    directory = Path(directory)
    _logger.debug("Starting calculation")
    sw = Stopwatch()
    params = CloudParams.from_root(directory)
    status = detect(params, diagonal_distance, skip_shadow_detection, use_cache, config,
                    device=device)
    db = DataBase(directory.parent)
    if status is not None:
        db.write_detection_result(Date.from_string(directory.name), status)
    db.close()
    _logger.debug("Finished in %.2f s", sw.elapsed())
    return status


def detect_in_folder(
    folder_path: Path | str,
    diagonal_distance: float,
    skip_shadow_detection: SkipShadowDetection = SkipShadowDetection(),
    use_cache: bool = True,
    config: DetectionConfig = DEFAULT_DETECTION,
    device=None,
) -> dict[Date, Status]:
    """Detect every multispectral date folder under ``folder_path``
    (automatic_detection.cpp:286-324).

    Unlike the reference, which decodes every raster sequentially on the
    critical path, a background thread pool decodes the next dates' TIFFs
    while the current date computes (FolderPrefetcher; PIL's zlib decode
    releases the GIL, so decode overlaps both device compute and the
    host-side pipeline stages)."""
    device = resolve_device(device)
    folder_path = Path(folder_path)
    results: dict[Date, Status] = {}
    _logger.debug("Starting calculation")
    sw = Stopwatch()
    folders = multispectral_folders(folder_path)
    if use_cache:
        # Don't burn decode threads on dates detect() would short-circuit.
        pending = [
            d
            for d in folders
            if not (
                CloudParams.from_root(d).cloud_path().exists()
                and CloudParams.from_root(d).shadow_path().exists()
            )
        ]
    else:
        pending = folders
    from ...utils.loader import FolderPrefetcher

    for directory, inputs in FolderPrefetcher(folders=pending):
        _logger.info("Calculating for %s", directory.name)
        params = CloudParams.from_root(directory)
        status = detect(
            params, diagonal_distance, skip_shadow_detection, use_cache, config,
            inputs=inputs, device=device,
        )
        if status is not None:
            results[Date.from_string(directory.name)] = status
    db = DataBase(folder_path)
    db.write_detection_results(results)
    db.close()
    _logger.info("Finished computing")
    _logger.debug("Finished in %.2f s", sw.elapsed())
    return results


def get_detection_results(base_folder: Path | str) -> dict[Date, Status]:
    """Recompute Status rows by reading mask TIFFs from disk
    (cloud_shadow_detection/db.cpp:87-142)."""
    base_folder = Path(base_folder)
    results: dict[Date, Status] = {}
    for folder in multispectral_folders(base_folder):
        status = Status()
        cloud_values = shadow_values = None
        if (folder / "cloud_mask.tif").exists():
            try:
                cloud_values = GeoTIFF.open(folder / "cloud_mask.tif").read()
                status.clouds_computed = True
            except Exception as e:  # noqa: BLE001
                _logger.error("Failed to open cloud file: %s", e)
        if (folder / "shadow_mask.tif").exists():
            try:
                shadow_values = GeoTIFF.open(folder / "shadow_mask.tif").read()
                status.shadows_computed = True
            except Exception as e:  # noqa: BLE001
                _logger.warning("Failed to open shadow file: %s", e)
        if not (status.clouds_computed or status.shadows_computed):
            _logger.warning("Could not find mask data. Skipping dir: %s", folder)
            continue
        if shadow_values is None:
            shadow_values = np.zeros_like(cloud_values)
        if cloud_values is None:
            cloud_values = np.zeros_like(shadow_values)
        mask = cloud_values.astype(bool) | shadow_values.astype(bool)
        status.percent_clouds = percent_non_zero(cloud_values)
        if status.shadows_computed:
            status.percent_shadows = percent_non_zero(shadow_values)
        status.percent_invalid = percent_non_zero(mask)
        results[Date.from_string(folder.name)] = status
    return results
