"""The port's roofline module (``satellite_approximation_tpu_torch/utils/roofline.py``)
against the JAX package's (``satellite_approximation_tpu/utils/roofline.py``)
and against the counts that the kernel table of PERF.md rests on.

Contracts: hierarchy shapes equal the JAX model's and the port's
``multigrid.build_hierarchy``; the plain-path, restrict, prolong and
laplacian models equal the JAX ones (the same data flow); the kernels'
byte and flop counts at 13x2048^2 on bench.py's mask are the numbers that
``chip_smoke.py`` phase 3 reported before they moved here, exactly; the
tile model follows jacobi.cu's geometry; the row schema and the peak table.
"""

import pytest
import torch

import chip_smoke
from satellite_approximation_tpu.utils import roofline as j_roof
from satellite_approximation_tpu_torch.models import multigrid as t_mg
from satellite_approximation_tpu_torch.models.cg import neighbor_degree
from satellite_approximation_tpu_torch.utils import roofline as R
from torch_parity import make_mask

# chip_smoke.kernel_work(torch, bench mask, 13, 7) before the move, to the byte
KERNEL_WORK_2048x13 = {
    "jacobi_zero": (671088640, 467496992, 259607322),
    "jacobi_corr": (943718400, 689649728, 259607322),
    "jacobi": (889192448, 685600800, 259607322),
    "residual_entry": (671088640, 468025728, 133131960),
    "residual_pair": (889192448, 279474976, 133131960),
    "jacobi_zero_half": (562036736, 358445088, 259607322),
    "jacobi_v2": (893386752, 893386752, 4253024256),
    "stride2": (163577856, 163577856, 0),
}
# PERF.md's kernel table: bound ms at 3.35 TB/s, dense and this mask
BOUNDS_MS = {
    "jacobi_zero": (0.200, 0.140), "jacobi_corr": (0.282, 0.206), "jacobi": (0.265, 0.205),
    "residual_entry": (0.200, 0.140), "residual_pair": (0.265, 0.083),
    "jacobi_zero_half": (0.168, 0.107), "jacobi_v2": (0.267, 0.267), "stride2": (0.049, 0.049),
}


@pytest.fixture(scope="module")
def bench_mask():
    return torch.from_numpy(chip_smoke.make_mask(chip_smoke.H, chip_smoke.W))


def test_kernel_counts_at_the_bench_shape(bench_mask):
    work = R.kernel_work(bench_mask, chip_smoke.BANDS, t_mg._PRE_SMOOTH, chip_smoke.STRIDE2_TIMED)
    assert work == KERNEL_WORK_2048x13
    for name, (dense, need, flops) in work.items():
        want_dense, want_need = BOUNDS_MS[name]
        assert round(R.bound_ms(dense, flops)[0], 3) == want_dense, name
        assert round(R.bound_ms(need, flops)[0], 3) == want_need, name
        assert R.bound_ms(need, flops)[1] == "bytes"


def test_bench_mask_tiles(bench_mask):
    """85 % of jacobi.cu's tiles stream on the bench mask (csrc/jacobi.cu's
    header); kernel 7's windows, with their ring, stream less often."""
    share = R.streaming_share(bench_mask)
    assert 0.84 <= share <= 0.86
    assert R.known_windows(bench_mask) == pytest.approx(0.8161168098449707)
    assert R.known_windows(bench_mask) < share


def test_stride2_and_v2_counts():
    assert R.stride2_bytes("both", (128, 512)) == 4 * (64 * 512 + 64 * 256)
    assert R.stride2_bytes("interleave", (2, 3, 7)) == 4 * 2 * (3 * 3 + 3 * 7)
    assert R.v2_work(1, 4096, 4096, 6, True) == (352321536, 352321536, 1140850688)
    assert R.v2_work(1, 4096, 4096, 6, False) == (285212672, 285212672, 1006632960)
    assert R.bound_ms(0, 67e9) == (1.0, "operations")


@pytest.mark.parametrize("hw", [(2048, 2048), (1373, 1374), (10980, 10980), (130, 97), (24, 300)])
def test_hierarchy_shapes_equal(hw):
    assert R.hierarchy_shapes(*hw) == j_roof.hierarchy_shapes(*hw)


@pytest.mark.parametrize("hw", [(257, 190), (130, 97)])
def test_hierarchy_shapes_match_build_hierarchy(hw):
    h, w = hw
    umask = make_mask(h, w, seed=4, n=6, margin=10, div=8)
    hier = t_mg.build_hierarchy(umask, neighbor_degree((h, w)))
    assert [tuple(m.shape) for m, _ in hier] == R.hierarchy_shapes(h, w)


@pytest.mark.parametrize("c,dtype_bytes", [(1, 4), (13, 4), (3, 2)])
@pytest.mark.parametrize("hw", [(2048, 2048), (1373, 1374), (31, 17)])
def test_plain_models_equal_jax(hw, c, dtype_bytes):
    h, w = hw
    assert R.plain_smoother_bytes(h, w, c, dtype_bytes, 7) == j_roof.xla_smoother_bytes(
        h, w, c, dtype_bytes, 7)
    assert R.restrict_bytes(h, w, c, dtype_bytes) == j_roof.restrict_bytes(h, w, c, dtype_bytes)
    assert R.prolong_correct_bytes(h, w, c, dtype_bytes) == j_roof.prolong_correct_bytes(
        h, w, c, dtype_bytes)
    assert R.laplacian_bytes(h, w, c, dtype_bytes) == j_roof.laplacian_bytes(h, w, c, dtype_bytes)


def test_plain_vcycle_levels_equal_jax():
    """Where every level above the coarsest runs plain sweeps and the
    coarsest runs CG, the V-cycle's model is the JAX package's XLA path."""
    shapes = R.hierarchy_shapes(2048, 2048)[:5]  # coarsest 128^2: CG, no dense inverse
    want = j_roof.vcycle_bytes(shapes, 13, 4, 7, 7, 64, pallas_min_px=2**40)
    assert R.vcycle_bytes(shapes, 13, 4, 7, 7, 64, plain_levels=len(shapes)) == want


def test_tile_model():
    assert R.window_amplification() == pytest.approx((64 / 48) ** 2)
    assert R.padded_pixels(2048, 2048) == 2064 * 2064
    assert R.padded_pixels(48, 49) == 48 * 96
    h = w = 480  # 10 x 10 tiles exactly
    px, win = h * w, h * w * (64 / 48) ** 2
    zero = R.smoother_bytes(h, w, 4, 4, "zero", emit_residual=True)
    assert zero == int((win + 4 * win + 8 * px) * 4)
    # a fifth band needs a second read of invm; streaming tiles read no b
    assert R.smoother_bytes(h, w, 5, 4, "zero") == int((2 * win + 5 * win + 5 * px) * 4)
    assert R.smoother_bytes(h, w, 1, 4, "zero", streaming=1.0) == int((win + px) * 4)
    assert R.smoother_bytes(h, w, 1, 4, "u", streaming=1.0) == int((win + 2 * px) * 4)
    corr = R.smoother_bytes(h, w, 1, 4, "corr")
    assert corr == int((win + 2.25 * win + px) * 4)
    half = R.smoother_bytes(h, w, 1, 4, "zero", emit_residual=True, half=True)
    assert half == int((2 * win + 1.5 * px) * 4)


def test_vcycle_and_pcg_models():
    shapes = R.hierarchy_shapes(2048, 2048)
    assert shapes[-1] == (16, 16)
    dense = R.coarse_solve_bytes(16, 16, 13, 4)
    assert dense == 2 * 13 * 256 * 4 + 256 * 256 * 4
    assert R.coarse_solve_bytes(128, 128, 1, 4) == 64 * (R.laplacian_bytes(128, 128, 1, 4)
                                                         + 6 * 128 * 128 * 4)
    kern = R.vcycle_bytes(shapes, 13)
    assert R.vcycle_bytes(shapes, 13, streaming=0.85) < kern
    assert R.vcycle_bytes(shapes, 13, streaming=[0.85] * len(shapes)) == R.vcycle_bytes(
        shapes, 13, streaming=0.85)
    # the sharded solve: distributed levels plain, the tail on the kernels
    assert R.vcycle_bytes(shapes, 13, plain_levels=3) > kern
    px = 2048 * 2048
    assert R.pcg_iteration_bytes(shapes, 13) == kern + 10 * 13 * px * 4
    assert R.pcg_iteration_bytes(shapes, 13, az_from_vcycle=False) == (
        kern + 7 * 13 * px * 4 + R.laplacian_bytes(2048, 2048, 13, 4))


def test_row_and_to_json(monkeypatch):
    monkeypatch.setattr(R, "hbm_peak_gbps", lambda kind=None: 1000.0)
    r = R.row("jacobi_zero", 0.002, 1_000_000_000, note="13x2048^2")
    assert r.achieved_gbps == pytest.approx(500.0) and r.pct_of_roofline == pytest.approx(50.0)
    assert r.to_json() == {"name": "jacobi_zero", "seconds": 0.002, "bytes_moved": 1000000000,
                           "achieved_gbps": 500.0, "pct_of_roofline": 50.0, "note": "13x2048^2"}
    assert set(r.to_json()) == set(j_roof.RooflineRow("x", 1.0, 1, 1.0, 1.0).to_json())


def test_hbm_peak_reads_card_names(monkeypatch):
    assert R.hbm_peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert R.hbm_peak_gbps("NVIDIA H100 PCIe") == 2000.0
    assert R.hbm_peak_gbps("NVIDIA H100 NVL") == 3900.0
    assert R.hbm_peak_gbps("NVIDIA A100-SXM4-80GB") == 2039.0
    assert R.hbm_peak_gbps("NVIDIA A100-PCIE-40GB") == 1555.0
    assert R.hbm_peak_gbps("some other card") == 3350.0
    assert R.HBM_BYTES_PER_S == R.hbm_peak_gbps("NVIDIA H100 80GB HBM3") * 1e9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.hbm_peak_gbps() == 3350.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 PCIe")
    assert R.hbm_peak_gbps() == 2000.0


def test_measure_takes_the_median(monkeypatch):
    calls = []
    ticks = iter([0.0, 0.3, 1.0, 1.1, 2.0, 2.2])
    monkeypatch.setattr(R.time, "perf_counter", lambda: next(ticks))
    assert R.measure(lambda: calls.append(1), n=3, warmup=2) == pytest.approx(0.2)
    assert len(calls) == 5


def test_directional_pass_work():
    """Kernel 9 at a full tile: 12 B a cell, 1.447 GB, bound by bytes at
    0.432 ms."""
    nbytes, ops = R.directional_pass_work(10980, 10980)
    assert nbytes == 12 * 10980 * 10980 == 1_446_724_800 and ops == 6 * 10980 * 10980
    ms, by = R.bound_ms(nbytes, ops)
    assert by == "bytes" and abs(ms - 0.43186) < 1e-4
