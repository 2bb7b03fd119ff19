"""The port's CUDA kernels on the card: each held bit for bit against its
plain PyTorch version, and the fill on the card against the fill on the CPU.
Then the detection ops, which are plain torch ops: the same op on the card
and on the CPU must give equal bits wherever the CPU tests demand equal bits
of the two packages (that shows that no TF32, no FMA contraction and no
atomic float add leaked in), and ``detect`` in both routes at 512^2. Last,
``parallel/`` on the card: four shards on one card, and one card a shard
where the host has four, in one process and across two.

These tests import neither jax nor the JAX package, so they run on a CUDA
host without JAX; there the repository's conftest (which imports jax) is
skipped:

    SAT_GPU_TESTS=1 PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_gpu.py

Without ``SAT_GPU_TESTS=1`` and a CUDA device every test here skips.
"""

import contextlib

import numpy as np
import pytest
import torch

from satellite_approximation_tpu_torch.models import fill
from satellite_approximation_tpu_torch.models import multigrid as mg
from satellite_approximation_tpu_torch.models.cg import neighbor_degree
from satellite_approximation_tpu_torch.ops import stencil_kernels as K
from torch_parity import (  # noqa: F401 — cuda_device is a fixture
    COMPONENT_KINDS,
    COMPONENT_SHAPES,
    CPU,
    SWEEP_BUCKETS,
    SWEEP_KINDS,
    V2_EDGE_KINDS,
    assert_bitwise,
    bench_system,
    bucket_scene,
    component_mask,
    cuda_device,
    edge_mask,
    make_mask,
    random_mask,
    shifted,
    strip_scene,
    sweep_case,
    true_box_counts,
    v2_window_case,
)

PRE = mg._smoother_omegas(mg._PRE_SMOOTH)
POST = tuple(reversed(mg._smoother_omegas(mg._POST_SMOOTH)))
COMPONENT_IDS = ["x".join(map(str, s)) for s in COMPONENT_SHAPES]
# partial tiles in both directions, a single exact tile, a thin strip
SHAPES = [(2, 137, 201), (1, 48, 48), (1, 30, 1000)]


def _cases(device, dtype, shape, seed):
    rng = np.random.default_rng(seed)
    c, h, w = shape
    um = random_mask(h, w, seed)
    invm = K.invm_for_kernel(torch.from_numpy(um), torch.from_numpy(neighbor_degree((h, w))))
    b, u = (torch.from_numpy(rng.random(shape).astype(np.float32)) for _ in range(2))
    e_c = torch.from_numpy(rng.standard_normal((c, (h + 1) // 2, (w + 1) // 2)).astype(np.float32))
    return [t.to(device=device, dtype=dtype) for t in (b, u, e_c, invm)]


def _pairs(got, want):
    return zip(got, want) if isinstance(got, tuple) else [(got, want)]


@pytest.mark.gpu
class TestKernelsOnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("emit", [False, True])
    def test_jacobi_kernels_bitwise(self, cuda_device, dtype, shape, emit):
        b, u, e_c, invm = _cases(cuda_device, dtype, shape, 21)
        for g, w in _pairs(K.jacobi_zero(b, invm, PRE, emit), K.jacobi_zero_plain(b, invm, PRE, emit)):
            assert_bitwise(g, w)
        got = K.jacobi_corr(u, b, invm, e_c, POST, emit)
        for g, w in _pairs(got, K.jacobi_corr_plain(u, b, invm, e_c, POST, emit)):
            assert_bitwise(g, w)

    @pytest.mark.parametrize("invm_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_residual_kernels_bitwise(self, cuda_device, invm_dtype, shape):
        rng = np.random.default_rng(22)
        um = random_mask(*shape[1:], 22, p=0.45)
        invm = K.invm_for_kernel(
            torch.from_numpy(um), torch.from_numpy(neighbor_degree(shape[1:]))
        ).to(device=cuda_device, dtype=invm_dtype)
        m = torch.from_numpy(um).to(cuda_device)

        def t(x):
            return torch.from_numpy(x.astype(np.float32)).to(cuda_device)

        img = t(np.round(rng.random(shape) * 1e4))
        x_hi = t(rng.random(shape) * 9e3) * m
        x_lo = t(rng.standard_normal(shape) * 1e-4) * m
        for g, w in zip(K.residual_entry(img, invm), K.residual_entry_plain(img, invm)):
            assert_bitwise(g, w)
        assert_bitwise(
            K.residual_pair(img, x_hi, x_lo, invm), K.residual_pair_plain(img, x_hi, x_lo, invm)
        )

    def test_launches_are_counted_and_cpu_mix_raises(self, cuda_device):
        b, u, e_c, invm = _cases(cuda_device, torch.float32, (1, 64, 64), 23)
        K.reset_launch_counts()
        K.jacobi_zero(b, invm, PRE)
        K.jacobi_corr(u, b, invm, e_c, POST)
        assert K.launch_counts["jacobi_zero"] == 1 and K.launch_counts["jacobi_corr"] == 1
        with pytest.raises(ValueError):
            K.jacobi_zero(b, invm.cpu(), PRE)
        with pytest.raises(ValueError):
            K.jacobi_zero(b[:, :, :32], invm[:, :32], PRE)  # not contiguous


@pytest.mark.gpu
class TestSmootherFamilyOnCard:
    """Kernels 3, 6, 7 and 8: the smoother from a given iterate, the half
    residual, the separate-operand smoother and the stride-2 idioms."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", SHAPES + [(2, 97, 50)])
    @pytest.mark.parametrize("emit", [False, True])
    def test_general_and_v2_kernels_bitwise(self, cuda_device, dtype, shape, emit):
        b, u, _, invm = _cases(cuda_device, dtype, shape, 24)
        for g, w in _pairs(K.jacobi(u, b, invm, PRE, emit), K.jacobi_plain(u, b, invm, PRE, emit)):
            assert_bitwise(g, w)
        um = invm > 0
        deg = torch.from_numpy(neighbor_degree(shape[1:])).to(cuda_device)
        got = K.jacobi_v2(u, b, um, deg, 7, 0.8, emit)
        for g, w in _pairs(got, K.jacobi_v2_plain(u, b, um, deg, 7, 0.8, emit)):
            assert_bitwise(g, w)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", SHAPES + [(2, 97, 50), (1, 1, 7)])
    def test_half_residual_bitwise(self, cuda_device, dtype, shape):
        """Odd heights, a tile cut by the image's bottom edge, one row."""
        b, _, _, invm = _cases(cuda_device, dtype, shape, 25)
        u_half, half = K.jacobi_zero(b, invm, PRE, "half")
        want_u, want_half = K.jacobi_zero_plain(b, invm, PRE, "half")
        assert_bitwise(u_half, want_u)
        assert_bitwise(half, want_half)
        u_full, r_full = K.jacobi_zero(b, invm, PRE, True)
        assert_bitwise(u_half, u_full)
        assert_bitwise(half, K.restrict_rows(r_full))

    def test_general_from_zero_equals_zero_start(self, cuda_device):
        b, _, _, invm = _cases(cuda_device, torch.float32, SHAPES[0], 26)
        got = K.jacobi(torch.zeros_like(b), b, invm, PRE, True)
        for g, w in zip(got, K.jacobi_zero(b, invm, PRE, True)):
            assert torch.equal(g, w)  # up to the sign of zero

    def test_v2_equals_general_kernel_with_omega_repeated(self, cuda_device):
        b, u, _, invm = _cases(cuda_device, torch.float32, SHAPES[0], 27)
        deg = torch.from_numpy(neighbor_degree(SHAPES[0][1:])).to(cuda_device)
        got = K.jacobi_v2(u, b, invm > 0, deg, 6, 0.8, True)
        for g, w in zip(got, K.jacobi(u, b, invm, (0.8,) * 6, True)):
            assert torch.equal(g, w)  # up to the sign of zero

    @pytest.mark.parametrize("shape", [(128, 512), (2, 137, 201), (3, 1, 64), (2, 2, 33, 64)])
    def test_stride2_bitwise(self, cuda_device, shape):
        x = torch.from_numpy(np.random.default_rng(0).random(shape, np.float32)).to(cuda_device)
        modes = ["rows", "cols", "both"] + (["interleave"] if shape[-1] % 2 == 0 else [])
        for mode in modes:
            assert_bitwise(K.stride2(x, mode), K.stride2_plain(x, mode))

    def test_new_launches_are_counted(self, cuda_device):
        b, u, _, invm = _cases(cuda_device, torch.float32, (1, 64, 64), 28)
        K.reset_launch_counts()
        K.jacobi(u, b, invm, PRE)
        K.jacobi_zero(b, invm, PRE, "half")
        K.jacobi_v2(u, b, invm > 0, torch.full_like(invm, 4.0), 3, 0.8)
        K.stride2(b, "cols")
        assert K.launch_counts["jacobi"] == K.launch_counts["jacobi_zero_half"] == 1
        assert K.launch_counts["jacobi_v2"] == K.launch_counts["stride2"] == 1
        assert K.launch_counts["jacobi_zero"] == 0
        with pytest.raises(ValueError):
            K.jacobi(u, b, invm.cpu(), PRE)


@pytest.mark.gpu
class TestTileSkipAndVectorEdgesOnCard:
    """The edges the redesigned kernels rely on: jacobi.cu's tile skip (tiles
    entirely known beside tiles with one unknown cell, unknown cells only in
    a tile's ring, no unknown cell, a 60 % mask), the signs of zero on known
    cells, and stride.cu's vector and scalar paths."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("kind", ["corner", "ring48", "ring112", "none", "dense"])
    @pytest.mark.parametrize("shape", [(2, 250, 301), (1, 240, 240)])
    def test_every_start_and_emit_bitwise(self, cuda_device, dtype, kind, shape):
        c, h, w = shape
        rng = np.random.default_rng(29)
        um = edge_mask(h, w, kind, seed=29)
        invm = K.invm_for_kernel(torch.from_numpy(um), torch.from_numpy(neighbor_degree((h, w))))
        b, u = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
        u[0, :2] = -0.0  # known cells of either sign of zero
        u[-1, -1] = 0.0
        e_c = torch.from_numpy(rng.standard_normal((c, (h + 1) // 2, (w + 1) // 2))
                               .astype(np.float32))
        b, u, e_c, invm = (t.to(device=cuda_device, dtype=dtype) for t in (b, u, e_c, invm))
        for emit in (False, True, "half"):
            for g, w_ in _pairs(K.jacobi_zero(b, invm, PRE, emit),
                                K.jacobi_zero_plain(b, invm, PRE, emit)):
                assert_bitwise(g, w_)
        for emit in (False, True):
            for g, w_ in _pairs(K.jacobi(u, b, invm, PRE, emit),
                                K.jacobi_plain(u, b, invm, PRE, emit)):
                assert_bitwise(g, w_)
            for g, w_ in _pairs(K.jacobi_corr(u, b, invm, e_c, POST, emit),
                                K.jacobi_corr_plain(u, b, invm, e_c, POST, emit)):
                assert_bitwise(g, w_)

    @pytest.mark.parametrize("width", [1, 3, 7, 8, 9, 33, 64])
    def test_stride2_widths_bitwise(self, cuda_device, width):
        """Odd row counts, one row, several leading axes."""
        rng = np.random.default_rng(width)
        for shape in ((2, 5, width), (3, 1, width), (2, 2, 6, width)):
            x = torch.from_numpy(rng.random(shape, np.float32)).to(cuda_device)
            for mode in K.STRIDE2_MODES:
                if mode != "interleave" or width % 2 == 0:
                    assert_bitwise(K.stride2(x, mode), K.stride2_plain(x, mode))

    def test_stride2_unaligned_address_bitwise(self, cuda_device):
        x = shifted(torch.from_numpy(np.random.default_rng(30).random((3, 7, 64), np.float32))
                    .to(cuda_device))
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
        for mode in K.STRIDE2_MODES:
            assert_bitwise(K.stride2(x, mode), K.stride2_plain(x, mode))


@pytest.mark.gpu
class TestResidualGroupsAndStripsOnCard:
    """Kernels 4 and 5 (residual.cu): band groups of 1, 5 and 13 bands (5 is
    no multiple of 4, and the launcher splits C into uneven groups), its
    16-byte strips (W = 2048) and its per-cell path (W = 1373, 1374, and an
    operand at an address 4 mod 16), on masks with no unknown cell, lone
    unknown cells, unknown cells only in a tile's ring, and 60 %."""

    @staticmethod
    def _inputs(device, shape, um, invm_dtype, seed=32):
        rng = np.random.default_rng(seed)
        invm = K.invm_for_kernel(torch.from_numpy(um), torch.from_numpy(neighbor_degree(um.shape)))
        img = np.round(rng.random(shape) * 1e4).astype(np.float32)
        img[:, ::7, ::5] = -0.0
        x_hi = (rng.random(shape) * 9e3).astype(np.float32) * um
        x_lo = (rng.standard_normal(shape) * 1e-4).astype(np.float32) * um
        ts = [torch.from_numpy(a).to(device) for a in (img, x_hi, x_lo)]
        return [*ts, invm.to(device=device, dtype=invm_dtype)]

    @staticmethod
    def _both_bitwise(img, x_hi, x_lo, invm):
        for g, w in zip(K.residual_entry(img, invm), K.residual_entry_plain(img, invm)):
            assert_bitwise(g, w)
        assert_bitwise(K.residual_pair(img, x_hi, x_lo, invm),
                       K.residual_pair_plain(img, x_hi, x_lo, invm))

    @pytest.mark.parametrize("invm_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("width", [1373, 1374, 2048])
    @pytest.mark.parametrize("bands", [1, 5, 13])
    @pytest.mark.parametrize("kind", ["corner", "ring48", "ring112", "none", "dense"])
    def test_residual_kernels_bitwise(self, cuda_device, kind, bands, width, invm_dtype):
        um = edge_mask(241, width, kind, seed=33)
        self._both_bitwise(*self._inputs(cuda_device, (bands, 241, width), um, invm_dtype))

    @pytest.mark.parametrize("invm_dtype", [torch.float32, torch.bfloat16])
    def test_one_group_of_thirteen_bands_bitwise(self, cuda_device, invm_dtype):
        """13x2048^2 on bench.py's mask: one group holds all 13 bands."""
        um = make_mask(2048, 2048)
        self._both_bitwise(*self._inputs(cuda_device, (13, 2048, 2048), um, invm_dtype))

    @pytest.mark.parametrize("operand", [0, 1, 2, 3])
    def test_unaligned_operand_bitwise(self, cuda_device, operand):
        """img, x_hi, x_lo or invm at an address 4 mod 16 bytes: the per-cell
        path at a width that would take the 16-byte one."""
        ops = self._inputs(cuda_device, (5, 97, 2048), random_mask(97, 2048, 34), torch.float32)
        ops[operand] = shifted(ops[operand])
        assert ops[operand].is_contiguous() and ops[operand].data_ptr() % 16 == 4
        K.reset_launch_counts()
        self._both_bitwise(*ops)
        assert K.launch_counts["residual_entry"] == K.launch_counts["residual_pair"] == 1


V2_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16)]
V2_DTYPE_IDS = ["f32", "bf16-deg-f32", "bf16"]


@pytest.mark.gpu
class TestJacobiV2OnCard:
    """Kernel 7 (jacobi_v2.cu): band groups of every size (1, 5 and 13
    bands), widths 1373, 1374 and 2048, f32 and bf16 storage with deg in f32
    and in the storage dtype, each operand at an address 4 mod 16 bytes, and
    windows that are static or one condition short of it."""

    @staticmethod
    def _operands(device, case, dtype, deg_dtype):
        u, b, um, deg = case
        return [torch.from_numpy(u).to(device=device, dtype=dtype),
                torch.from_numpy(b).to(device=device, dtype=dtype),
                torch.from_numpy(um).to(device),
                torch.from_numpy(deg).to(device=device, dtype=deg_dtype)]

    @staticmethod
    def _both_bitwise(u, b, um, deg):
        for sweeps, emit in ((8, False), (7, True), (1, True)):
            got = K.jacobi_v2(u, b, um, deg, sweeps, 0.8, emit)
            for g, w in _pairs(got, K.jacobi_v2_plain(u, b, um, deg, sweeps, 0.8, emit)):
                assert_bitwise(g, w)

    @pytest.mark.parametrize("dtypes", V2_DTYPES, ids=V2_DTYPE_IDS)
    @pytest.mark.parametrize("width", [1373, 1374, 2048])
    @pytest.mark.parametrize("bands", [1, 5, 13])
    def test_bands_widths_dtypes_bitwise(self, cuda_device, bands, width, dtypes):
        case = v2_window_case(bands, width, seed=40)
        self._both_bitwise(*self._operands(cuda_device, case, *dtypes))

    @pytest.mark.parametrize("dtypes", [V2_DTYPES[0], V2_DTYPES[2]], ids=["f32", "bf16"])
    @pytest.mark.parametrize("operand", [0, 1, 2, 3])
    def test_unaligned_operand_bitwise(self, cuda_device, operand, dtypes):
        """u, b, the mask or deg at an address 4 mod 16 bytes."""
        ops = self._operands(cuda_device, v2_window_case(5, 2048, seed=41), *dtypes)
        ops[operand] = shifted(ops[operand])
        assert ops[operand].is_contiguous() and ops[operand].data_ptr() % 16 == 4
        K.reset_launch_counts()
        self._both_bitwise(*ops)
        assert K.launch_counts["jacobi_v2"] == 3

    @pytest.mark.parametrize("dtypes", V2_DTYPES[:2], ids=V2_DTYPE_IDS[:2])
    @pytest.mark.parametrize("width", [304, 1373])
    @pytest.mark.parametrize("kind", ("static",) + V2_EDGE_KINDS)
    def test_static_window_edges_bitwise(self, cuda_device, kind, width, dtypes):
        """Width 304 takes the 16-byte streaming path (and its fallback to
        the sweeps) in f32 and bf16, width 1373 the per-cell path."""
        case = v2_window_case(2, width, kind, seed=42)
        self._both_bitwise(*self._operands(cuda_device, case, *dtypes))


# 64x17000 and 17000x64: wider than the strips an H100 holds at once, so
# the passes along the long side run a launch a batch of rows
DIRECTIONAL_SHAPES = [(1, 1), (1, 33), (33, 1), (37, 53), (1373, 1374), (2048, 2048),
                      (64, 17000), (17000, 64)]


@contextlib.contextmanager
def _per_batch():
    """Kernel 9 as on a raster wider than the strips the card holds at once:
    a launch a batch of rows, whatever the width."""
    from satellite_approximation_tpu_torch.ops import pitfill_kernels as PK

    keep = PK._geometry
    PK._geometry = lambda index: (*keep(index)[:2], 0)
    try:
        yield
    finally:
        PK._geometry = keep


def _directional_case(device, shape, start, seed):
    """(orig, f) on the card: orig a correlated field in (0.1, 0.9), f the
    pyramid's seed (orig against the upsampled fixpoint of the level above,
    as ``pit_fill`` hands a level its start) or all ones; "nan" is the seed
    with a NaN in ~1 % of the cells of orig and of f."""
    from satellite_approximation_tpu_torch.ops import pitfill
    from torch_parity import smooth

    orig = torch.from_numpy((0.1 + 0.8 * smooth(*shape, seed=seed)).astype(np.float32)).to(device)
    if start == "ones":
        return orig, torch.ones_like(orig)
    coarse = pitfill.pit_fill(pitfill._maxpool2(orig), 0.45)
    up = coarse.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[: shape[0], : shape[1]]
    f = torch.maximum(orig, up)
    if start == "nan":
        r = np.random.default_rng(seed)
        for x in (orig, f):
            x[torch.from_numpy(r.random(shape) < 0.01).to(device)] = float("nan")
    return orig, f


@pytest.mark.gpu
class TestDirectionalPassOnCard:
    """Kernel 9 (``csrc/pitfill.cu``) against its plain version: every
    direction, the pyramid's seed, all ones and the seed with NaNs as
    starts, a border inside the data's range (0.45) and outside it (1.5
    above, -0.25 below), in one launch a pass and in a launch a batch of
    rows."""

    @pytest.mark.parametrize("per_batch", [False, True])
    @pytest.mark.parametrize("border", [0.45, 1.5, -0.25])
    @pytest.mark.parametrize("start", ["seed", "ones", "nan"])
    @pytest.mark.parametrize("shape", DIRECTIONAL_SHAPES)
    def test_each_direction_bitwise(self, cuda_device, shape, start, border, per_batch):
        from satellite_approximation_tpu_torch.ops import pitfill_kernels as PK

        orig, f = _directional_case(cuda_device, shape, start, 70)
        bv = torch.tensor(border, device=cuda_device)
        for direction in PK.DIRECTIONS:
            with _per_batch() if per_batch else contextlib.nullcontext():
                got, changed = PK.directional_pass(orig, f, bv, direction)
            want, want_changed = PK.directional_pass_plain(orig, f, bv, direction)
            assert got.device.type == "cuda"
            assert_bitwise(got, want)
            assert int(changed) == int(want_changed)
            f = want

    @pytest.mark.parametrize("per_batch", [False, True])
    @pytest.mark.parametrize("max_cycles", [1, 8])
    @pytest.mark.parametrize("shape", [(37, 53), (1373, 1374)])
    def test_budget_bitwise(self, cuda_device, shape, max_cycles, per_batch):
        """A budget on the card: the surface, the flag and the cycles run
        equal the plain budget's, cycles after an unchanged one included."""
        from satellite_approximation_tpu_torch.ops import pitfill
        from satellite_approximation_tpu_torch.ops import pitfill_kernels as PK

        orig, f = _directional_case(cuda_device, shape, "seed", 71)
        runs = [[], []]
        with _per_batch() if per_batch else contextlib.nullcontext():
            got, changed = PK.directional_budget(orig, 0.45, f, max_cycles, runs[0])
        want, want_changed = pitfill._directional_budget(orig, 0.45, f, max_cycles, runs[1])
        assert_bitwise(got, want)
        assert changed == want_changed and runs[0] == runs[1]

    def test_launches_counted_and_cpu_raises(self, cuda_device):
        from satellite_approximation_tpu_torch.ops import pitfill_kernels as PK

        orig, f = _directional_case(cuda_device, (64, 80), "ones", 72)
        K.reset_launch_counts()
        PK.directional_pass(orig, f, 0.45, "left")
        assert K.launch_counts["directional_pass"] == 1
        PK.directional_budget(orig, 0.45, f, 2)
        assert K.launch_counts["directional_pass"] == 1 + 2 * 4
        with pytest.raises(ValueError):
            PK.directional_pass(orig.cpu(), f, 0.45, "down")
        with pytest.raises(ValueError):
            PK.directional_budget(orig, torch.tensor(0.45), f.cpu(), 1)
        with pytest.raises(ValueError):
            PK.directional_pass(orig[:, :40], f[:, :40], 0.45, "down")  # not contiguous

    def test_pit_fill_with_cycles_equals_priority_flood(self, cuda_device, monkeypatch):
        from satellite_approximation_tpu_torch import native
        from satellite_approximation_tpu_torch.ops import pitfill
        from torch_parity import smooth

        monkeypatch.setattr(pitfill, "_DIRECTIONAL_MIN_SIZE", 0)  # every level
        x = (0.1 + 0.8 * smooth(1024, 1024, seed=73)).astype(np.float32)
        K.reset_launch_counts()
        levels = []
        got = pitfill.pit_fill(torch.from_numpy(x).to(cuda_device), 0.45,
                               on_level=lambda *a: levels.append(a))
        assert K.launch_counts["directional_pass"] > 0
        assert len(levels) == 5 and all(cycles > 0 for *_, cycles in levels)
        assert native.available(), "g++ is needed beside nvcc"
        assert np.array_equal(got.cpu().numpy(), native.pit_fill_flood(x, 0.45))

    @pytest.mark.parametrize("shape", [(130, 17000), (17000, 130)])
    def test_pit_fill_wider_than_the_card_holds(self, cuda_device, shape):
        """A level wider than the strips the card holds at once runs its
        passes along the long side a launch a batch of rows (3 launches a
        pass at 130 rows), and the pit fill gives the flood's surface."""
        from satellite_approximation_tpu_torch import native
        from satellite_approximation_tpu_torch.ops import pitfill
        from satellite_approximation_tpu_torch.ops import pitfill_kernels as PK
        from torch_parity import smooth

        assert PK._strips(17000, cuda_device) > PK._geometry(torch.cuda.current_device())[2]
        x = (0.1 + 0.8 * smooth(*shape, seed=74)).astype(np.float32)
        K.reset_launch_counts()
        levels = []
        got = pitfill.pit_fill(torch.from_numpy(x).to(cuda_device), 0.45,
                               on_level=lambda *a: levels.append(a))
        assert levels[-1][1] == shape and levels[-1][3] > 0
        assert K.launch_counts["directional_pass"] > 0
        assert native.available(), "g++ is needed beside nvcc"
        assert np.array_equal(got.cpu().numpy(), native.pit_fill_flood(x, 0.45))


@pytest.mark.gpu
def test_general_v_cycle_on_card_matches_cpu(cuda_device):
    """Stationary cycles u <- V(b, u) on the card (kernels 3, 1, 2) and on
    the CPU (plain versions): the coarse mat-vec sums in another order, so
    the iterates agree to 1e-5, not bit for bit."""
    _, m, _, b, x0 = bench_system(160, 224, 2)
    out = []
    for dev in (cuda_device, CPU):
        hier = mg._device_hierarchy(m, torch.from_numpy(neighbor_degree(m.shape)).to(dev), dev)
        pb = mg.prebuild(hier, torch.float32)
        bt = torch.from_numpy(b.astype(np.float32)).to(dev)
        u = torch.from_numpy(x0.astype(np.float32)).to(dev)
        for _ in range(3):
            u = mg._v_cycle(pb, bt, u)
        out.append(u.cpu())
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_fill_on_card_matches_cpu(cuda_device):
    """The whole fill on the card (kernels) against the CPU (plain
    versions): the same solution to the solve's own precision."""
    imgs, m, *_ = bench_system(160, 224, 2)
    kw = dict(tolerance=1e-9, refinement_steps=4, device_output=False)
    on_card = fill.laplace_fill(imgs, m, device=cuda_device, **kw)
    on_cpu = fill.laplace_fill(imgs, m, device=CPU, **kw)
    assert on_card.error <= 1e-9 and on_cpu.error <= 1e-9
    assert abs(on_card.iterations - on_cpu.iterations) <= 1
    np.testing.assert_allclose(on_card.x, on_cpu.x, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- detection


def _both(fn, *arrays, device):
    """``fn`` on CPU tensors and on card tensors of the same arrays; the
    results as numpy arrays."""
    def run(dev):
        out = fn(*[torch.from_numpy(np.array(a)).to(dev) for a in arrays])
        outs = out if isinstance(out, tuple) else (out,)
        return [o.cpu().numpy() for o in outs]

    return run(CPU), run(device)


def _assert_equal_bits(cpu, card):
    assert len(cpu) == len(card)
    for a, b in zip(cpu, card):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.gpu
class TestDetectionOpsOnCard:
    @pytest.mark.parametrize("dtype,max_value", [(np.uint8, 255), (np.uint8, 100), (np.uint16, 65535)])
    def test_normalization_every_value(self, cuda_device, dtype, max_value, tmp_path):
        from satellite_approximation_tpu_torch.models.detection.pipeline import _read_normalized_u8

        raw = np.arange(np.iinfo(dtype).max + 1, dtype=np.int64).astype(dtype).reshape(-1, 16)
        got = _read_normalized_u8(tmp_path / "X.tif", max_value, {"X": raw}, cuda_device)
        assert got.device.type == "cuda"
        assert np.array_equal(got.cpu().numpy(), raw.astype(np.float32) / np.float32(max_value))

    @pytest.mark.parametrize("sigma", [1.0, 4.0])
    def test_blurs(self, cuda_device, sigma):
        from satellite_approximation_tpu_torch.ops.blur import gaussian_blur, gaussian_blur_host
        from satellite_approximation_tpu_torch.ops.morphology import cv_gaussian_blur

        x = np.random.default_rng(60).random((300, 257)).astype(np.float32)
        cpu, card = _both(lambda t: gaussian_blur(t, sigma), x, device=cuda_device)
        _assert_equal_bits(cpu, card)
        assert np.array_equal(card[0], gaussian_blur_host(x, sigma))
        _assert_equal_bits(*_both(lambda t: cv_gaussian_blur(t, 11), x, device=cuda_device))

    @pytest.mark.parametrize("radius", [5, 15])
    def test_morphology_and_masks(self, cuda_device, radius):
        from satellite_approximation_tpu_torch.ops import masks, morphology

        rng = np.random.default_rng(61)
        m = rng.random((400, 333)) > 0.99
        for op in (morphology.dilate, morphology.erode, morphology.close):
            _assert_equal_bits(*_both(lambda t: op(t, radius), m, device=cuda_device))
        k = np.ones((3, 5), np.uint8)
        k[1, 2] = k[0, 0] = 0  # not chords: the convolution route, TF32 off
        _assert_equal_bits(*_both(lambda t: morphology._count_conv(t, k), m, device=cuda_device))
        scl = rng.integers(0, 12, (64, 70)).astype(np.uint8)
        _assert_equal_bits(*_both(lambda t: masks.scl_mask(t, (masks.SCL.CLOUD_HIGH, masks.SCL.WATER)),
                                  scl, device=cuda_device))
        _assert_equal_bits(*_both(masks.cover_percentage, m, device=cuda_device))

    @pytest.mark.parametrize("shape", [(300, 257), (1024, 1024)])
    def test_pit_fill(self, cuda_device, shape):
        from satellite_approximation_tpu_torch import native
        from satellite_approximation_tpu_torch.ops.pitfill import pit_fill
        from torch_parity import smooth

        x = (0.1 + 0.8 * smooth(*shape, seed=62)).astype(np.float32)
        got = pit_fill(torch.from_numpy(x).to(cuda_device), 0.45)
        assert got.device.type == "cuda"
        assert native.available(), "g++ is needed beside nvcc"
        assert np.array_equal(got.cpu().numpy(), native.pit_fill_flood(x, 0.45))

    def test_components_and_percentile(self, cuda_device):
        from satellite_approximation_tpu_torch.models.detection.shadow_mask import _dynamic_percentile
        from satellite_approximation_tpu_torch.ops import components

        rng = np.random.default_rng(63)
        m = rng.random((200, 240)) > 0.6
        _assert_equal_bits(*_both(components.connected_components, m, device=cuda_device))
        on_card = components.partition_regions(torch.from_numpy(m).to(cuda_device), 3)
        on_host = components.partition_regions(m, 3)
        assert np.array_equal(on_card[0], on_host[0]) and on_card[1] == on_host[1]
        v = rng.random((500, 400)).astype(np.float32)
        sel = rng.random((500, 400)) > 0.5
        for percent in (0.0, 0.3, 0.55, 1.0):
            _assert_equal_bits(*_both(
                lambda a, b: _dynamic_percentile(a, b, torch.tensor(percent, device=a.device)),
                v, sel, device=cuda_device))

    def test_host_mask_without_library_is_labelled_on_the_card(self, cuda_device, monkeypatch):
        """No ``device=`` given and no C++ flood: the label propagation runs
        on the CUDA device, not on the CPU."""
        from satellite_approximation_tpu_torch import native
        from satellite_approximation_tpu_torch.models import laplace
        from satellite_approximation_tpu_torch.ops import components

        m = np.random.default_rng(64).random((120, 150)) > 0.6
        want = components.partition_regions(m, 3)
        assert native.available(), "g++ is needed beside nvcc"
        monkeypatch.setattr(native, "get_lib", lambda: None)
        seen, real = [], components.label_components

        def recording(mask, connectivity=8):
            seen.append(mask.device.type)
            return real(mask, connectivity)

        monkeypatch.setattr(components, "label_components", recording)
        got = components.partition_regions(m, 3)
        id_map, region_map = laplace.find_connected_components(m, 3)
        assert seen == ["cuda", "cuda"]
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        assert np.array_equal(id_map, want[0]) and len(region_map) == len(want[1])

    @pytest.mark.parametrize("connectivity", [8, 4])
    @pytest.mark.parametrize("kind", COMPONENT_KINDS)
    @pytest.mark.parametrize("shape", COMPONENT_SHAPES, ids=COMPONENT_IDS)
    def test_label_components_kernel_bitwise(self, cuda_device, shape, kind, connectivity):
        """Kernel 10 against its plain version on the card, bit for bit."""
        from satellite_approximation_tpu_torch.ops import components

        mask = torch.from_numpy(component_mask(*shape, kind)).to(cuda_device)
        before = K.launch_counts["label_components"]
        got = components.label_components(mask, connectivity)
        assert K.launch_counts["label_components"] == before + 1
        assert_bitwise(got, components.connected_components(mask, connectivity))

    @pytest.mark.parametrize("min_area", [1, 3])
    @pytest.mark.parametrize("kind", COMPONENT_KINDS)
    @pytest.mark.parametrize("shape", COMPONENT_SHAPES, ids=COMPONENT_IDS)
    def test_partition_on_card_equals_flood(self, cuda_device, shape, kind, min_area):
        """Kernel 10 and the two region passes: the id map (left on the card)
        and the regions equal to the native flood's."""
        _assert_partition_equals_flood(component_mask(*shape, kind), min_area, cuda_device)

    def test_components_on_a_tile_scene_mask(self, cuda_device):
        """The raw cloud mask of the benchmark's 5490^2 scene at 25 % cover:
        kernel 10 bit-equal to the plain version, the partition on the card
        equal to the native flood."""
        from portbench.traffic import scenes
        from satellite_approximation_tpu_torch.config import DEFAULT_DETECTION as cfg
        from satellite_approximation_tpu_torch.models.detection import cloud_mask
        from satellite_approximation_tpu_torch.ops import components

        scene = scenes.detect_scene(5490, 5490, 0.25, scenes.generator(2147483659, cuda_device),
                                    cuda_device)
        clp, cld = (torch.from_numpy(scene[k]).to(cuda_device).float() / top
                    for k, top in (("CLP", 255.0), ("CLD", 100.0)))
        gen = cloud_mask.generate_cloud_mask_ignore_low_probability(
            clp, cld, torch.from_numpy(scene["SCL"]).to(cuda_device), cfg.cloud_mask,
            device_output=True)
        mask = gen.cloud_mask_no_processing.contiguous()
        assert 0.1 < float(mask.float().mean()) < 0.6
        assert_bitwise(components.label_components(mask), components.connected_components(mask))
        regions = _assert_partition_equals_flood(mask.cpu().numpy(), 3, cuda_device)
        assert len(regions) > 10

    def test_refinement_ops(self, cuda_device):
        from satellite_approximation_tpu_torch.models.detection import refinement, refinement_torch

        rng = np.random.default_rng(64)
        a = rng.random((600, 500)).astype(np.float32)
        a[:300] = 0.0  # most pixels in one cell: the contended adds
        b = rng.random((600, 500)).astype(np.float32)
        s = rng.random((600, 500)) > 0.9
        for divisions in ((8, 16, 32, 64, 128), (6, 10)):
            cpu, card = _both(lambda x, y, z: tuple(
                t for pair in refinement_torch._histograms(x, y, z, divisions) for t in pair),
                a, b, s, device=cuda_device)
            _assert_equal_bits(cpu, card)
        seeds = rng.random((3, 64, 80)) > 0.98
        _assert_equal_bits(*_both(lambda t: refinement_torch._edt_sq(t, 60, 77, band=16), seeds,
                                  device=cuda_device))
        surface = refinement.probability_map(s, a, b)
        ext = surface._extended()
        cloud = rng.random((600, 500)) > 0.8
        _assert_equal_bits(*_both(
            lambda e, x, y, o, c: refinement_torch._sample_final(e, x, y, o, c, 0.15),
            ext, a, b, s, cloud, device=cuda_device))
        want = refinement.improved_shadow_mask(s, cloud, a, b, surface, 0.15)
        got = refinement_torch.improved_shadow_mask(s, cloud, a, b, surface, 0.15, device=cuda_device)
        assert np.array_equal(got, want)

    def test_ls_point(self, cuda_device):
        from satellite_approximation_tpu_torch.ops import geometry

        gy, gx = np.ogrid[:700, :900]
        grad = (gy / 700 + gx / 900).astype(np.float32)
        zen, azi = 35.0 + 0.5 * grad, 145.0 + 0.5 * grad
        got = geometry.ls_point_equal_to_device(zen, azi, (700, 900), 15.0, 785.0, device=cuda_device)
        want = geometry.ls_point_equal_to_chunked(zen, azi, (700, 900), 15.0, 785.0)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _assert_partition_equals_flood(m, min_area, device):
    from satellite_approximation_tpu_torch import native
    from satellite_approximation_tpu_torch.ops import components

    labels = components.label_components(torch.from_numpy(m).to(device))
    id_map, regions = components.partition_labels(labels, min_area)
    assert native.available(), "g++ is needed beside nvcc"
    want_map, count = native.flood_partition(m, min_area)
    assert id_map.device.type == "cuda" and id_map.dtype == torch.int32
    assert np.array_equal(id_map.cpu().numpy(), want_map)
    assert regions == components._regions_from_labels(want_map, count)
    return regions


def _detect(scene, n, backends, device, work, mesh="auto"):
    from satellite_approximation_tpu_torch import config
    from satellite_approximation_tpu_torch.models.detection import pipeline
    from satellite_approximation_tpu_torch.utils.geotiff import GeoTIFF, write_geotiff
    from torch_parity import detection_config, mini_diagonal

    work.mkdir()
    write_geotiff(scene["B08"], work / "B08.tif")
    params = pipeline.CloudParams.from_root(work)
    status = pipeline.detect(params, mini_diagonal(n), use_cache=False, inputs=dict(scene),
                             config=detection_config(config, *backends), mesh=mesh,
                             device=device)
    names = ("cloud_mask", "potential_shadows", "object_based_shadows", "shadow_mask")
    return status, {k: GeoTIFF.open(work / f"{k}.tif").read().astype(bool) for k in names}


@pytest.mark.gpu
class TestDetectOnCard:
    @pytest.mark.parametrize("backends", [("host", "native"), ("torch", "torch")],
                             ids=["host-route", "all-device-route"])
    def test_route_on_card_against_cpu(self, cuda_device, tmp_path, backends):
        """The cloud and potential-shadow masks are equal bit for bit between
        the card and the CPU; the object and final masks pass through exp,
        sin and cos, which the two round differently: IoU >= 0.995, as the
        JAX package holds its own routes to each other."""
        from torch_parity import mini_scene

        n = 512
        scene = mini_scene(n)
        card_status, card = _detect(scene, n, backends, cuda_device, tmp_path / "card")
        cpu_status, cpu = _detect(scene, n, backends, "cpu", tmp_path / "cpu")
        assert card["cloud_mask"].any() and card["object_based_shadows"].any()
        assert card_status.percent_shadows > 0
        for name in ("cloud_mask", "potential_shadows"):
            assert np.array_equal(card[name], cpu[name]), name
        for name in ("object_based_shadows", "shadow_mask"):
            union = np.logical_or(card[name], cpu[name]).sum()
            assert np.logical_and(card[name], cpu[name]).sum() / union >= 0.995, name
        assert card_status.percent_clouds == cpu_status.percent_clouds
        assert card_status.percent_shadows == pytest.approx(cpu_status.percent_shadows, abs=1e-3)

    @pytest.mark.parametrize("backends", [("host", "native"), ("torch", "torch")],
                             ids=["host-route", "all-device-route"])
    def test_partition_launches_kernel_10_on_the_device_route(self, cuda_device, tmp_path,
                                                               backends):
        """The device route partitions its mask on the card (kernel 10 and
        both region passes launch); the host route takes the native flood
        and launches none."""
        from torch_parity import mini_scene

        n = 512
        K.reset_launch_counts()
        _detect(mini_scene(n), n, backends, cuda_device, tmp_path / "card")
        launched = [K.launch_counts[k] for k in ("label_components", "region_stats", "region_ids")]
        assert launched == ([1, 1, 1] if backends[0] == "torch" else [0, 0, 0])

    def test_sweep_on_card_equals_native_scan(self, cuda_device):
        """Matching from the same clouds, masks and positions: the sweep on
        the card and the C++ scan select the same heights and pixels."""
        from satellite_approximation_tpu_torch.config import MatchingConfig
        from satellite_approximation_tpu_torch.models.detection import cloud_mask, matching
        from torch_parity import match_scene

        mask, psm, sun, view, diag = match_scene(h=300, w=400, n_clouds=12, shift=(-3, -5), seed=11)
        cmap, clouds = cloud_mask.partition_cloud_mask(mask, diag, 3)
        args = (clouds, cmap, mask, psm, diag, sun, view)
        want = matching.match_clouds_shadows(*args, MatchingConfig(backend="native"))
        got = matching.match_clouds_shadows(*args, MatchingConfig(backend="torch"), device=cuda_device)
        assert np.array_equal(got.shadow_mask, want.shadow_mask) and got.shadow_mask.any()
        for k, w in want.solutions.items():
            assert (got.solutions[k].height, got.solutions[k].similarity) == (w.height, w.similarity)
            assert got.shadows[k].bounds == want.shadows[k].bounds


_PAIR_OPERANDS = ("min_x", "min_y", "max_x", "max_y", "a2", "delta")


def _bucket_scene_inputs(scale):
    """(clouds, cloud map, cloud mask, potential shadows, diagonal, sun,
    view) of ``bucket_scene(scale)``, partitioned on the host."""
    from satellite_approximation_tpu_torch.models.detection import cloud_mask

    mask, psm, sun, view, diag = bucket_scene(scale)
    cmap, clouds = cloud_mask.partition_cloud_mask(mask, diag, 3)
    return clouds, cmap, mask, psm, diag, sun, view


def _assert_identical_match(got, want):
    assert np.array_equal(got.shadow_mask, want.shadow_mask)
    assert got.trimmed_mean_height == want.trimmed_mean_height or (
        np.isnan(got.trimmed_mean_height) and np.isnan(want.trimmed_mean_height))
    assert got.solutions.keys() == want.solutions.keys()
    for k, w in want.solutions.items():
        g = got.solutions[k]
        assert (g.height, g.similarity, g.id) == (w.height, w.similarity, w.id)
        assert np.array_equal(g.M, w.M)
        gs, ws = got.shadows[k], want.shadows[k]
        assert (gs.bounds, gs.area, gs.anchor) == (ws.bounds, ws.area, ws.anchor)
        assert (gs.window is None) == (ws.window is None)
        if ws.window is not None:
            assert np.array_equal(gs.window, ws.window)


@pytest.mark.gpu
class TestSimilaritySweepOnCard:
    @pytest.mark.parametrize("kind", SWEEP_KINDS)
    @pytest.mark.parametrize("bucket", SWEEP_BUCKETS, ids=lambda b: f"{b[0]}x{b[1]}")
    def test_kernel_11_bitwise(self, cuda_device, bucket, kind):
        """Kernel 11's counts and similarities against the torch form on the
        card, bit for bit, from 8x8 buckets to 4096x2048 and 8192x64 (past
        the largest of the matching's buckets): separable and
        sheared casts, boxes clipped at each raster edge, casts that leave
        the raster, pairs under the minimum support, an id absent from its
        window, boxes the bucket clips. Up to 256x128, the torch form on the
        CPU and the algorithm written out in numpy too."""
        from satellite_approximation_tpu_torch.models.detection import matching
        from satellite_approximation_tpu_torch.ops import sweep_kernels

        rasters, ids, pairs, static = sweep_case(*bucket, kind, seed=sum(bucket))
        host = (*map(torch.from_numpy, rasters), torch.from_numpy(ids),
                *(torch.from_numpy(pairs[k]) for k in _PAIR_OPERANDS))
        card = tuple(a.to(cuda_device) for a in host)
        before = K.launch_counts["similarity_sweep"]
        t, c = sweep_kernels.pair_counts(*card, **static)
        got = matching._bucket_sweep(*card, **static, min_support=5)
        assert K.launch_counts["similarity_sweep"] == before + 2

        nh, nc = pairs["min_x"].shape
        rep = lambda a: a.reshape(nh * nc, *a.shape[2:])  # noqa: E731
        cand, hit = matching._pair_counts(
            *card[:3], card[3].repeat(nh), *map(rep, card[4:]), *static.values(), False)
        assert_bitwise(t, cand.sum(dim=(1, 2), dtype=torch.int32).reshape(nh, nc))
        assert_bitwise(c, hit.sum(dim=(1, 2), dtype=torch.int32).reshape(nh, nc))
        del cand, hit
        assert_bitwise(got, matching._sweep(*card, **static, min_support=5, separable=False))
        if bucket[0] <= 256:
            assert_bitwise(got.cpu(), matching._bucket_sweep(*host, **static, min_support=5))
            want_t, want_c = true_box_counts(rasters, ids, pairs, **static)
            assert np.array_equal(t.cpu().numpy(), want_t)
            assert np.array_equal(c.cpu().numpy(), want_c)
        assert int(t.max()) > 0 or kind in ("sparse", "absent")

    def test_match_on_card_equals_native_scan_in_six_buckets(self, cuda_device):
        """The matching on the card (one launch of kernel 11 a bucket, six
        buckets from 16x16 to 256x256) against the C++ scan: solutions,
        bounds, areas and the object-based shadow mask."""
        from satellite_approximation_tpu_torch.config import MatchingConfig
        from satellite_approximation_tpu_torch.models.detection import matching
        from satellite_approximation_tpu_torch.utils.profiling import StageTimer

        from satellite_approximation_tpu_torch.utils import profiling

        args = _bucket_scene_inputs(8)
        want = matching.match_clouds_shadows(*args, MatchingConfig(backend="native"))
        timer = StageTimer(cuda_device)
        before = K.launch_counts["similarity_sweep"]
        profiling.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            got = matching.match_clouds_shadows(*args, MatchingConfig(backend="torch"),
                                                timer=timer, device=cuda_device)
        spans = [r.counts for r in profiling.records() if r.name == "detect.matching/sweep"]
        profiling.clear()
        sweeps = [name for name, _ in timer.stages if name.startswith("matching/sweep ")]
        assert len(sweeps) >= 6 and len(spans) == len(sweeps)
        assert K.launch_counts["similarity_sweep"] == before + len(sweeps)
        assert all(c["kernel"] == 1 for c in spans)
        assert sum(c["pairs"] for c in spans) == len(matching.height_sweep(MatchingConfig())) * len(
            args[0])
        assert np.array_equal(got.shadow_mask, want.shadow_mask) and got.shadow_mask.any()
        assert got.trimmed_mean_height == want.trimmed_mean_height
        assert got.solutions.keys() == want.solutions.keys()
        for k, w in want.solutions.items():
            assert (got.solutions[k].height, got.solutions[k].similarity) == (w.height, w.similarity)
            gs, ws = got.shadows[k], want.shadows[k]
            assert (gs.bounds, gs.area, gs.anchor) == (ws.bounds, ws.area, ws.anchor)

    def test_kernel_route_equals_the_torch_forms_passes(self, cuda_device):
        """On the card, the kernel route (a bucket a pass through kernel 11)
        against the torch form's groups and passes, given as the sweep."""
        from satellite_approximation_tpu_torch.config import MatchingConfig
        from satellite_approximation_tpu_torch.models.detection import matching

        args = _bucket_scene_inputs(4)
        got = matching.match_clouds_shadows(*args, MatchingConfig(backend="torch"),
                                            device=cuda_device)

        def torch_form(*a, **kw):
            return matching._sweep(*a, **kw, separable=False)

        before = K.launch_counts["similarity_sweep"]
        want = matching.match_clouds_shadows(*args, MatchingConfig(backend="torch"),
                                             sweep_fn=torch_form, device=cuda_device)
        assert K.launch_counts["similarity_sweep"] == before
        _assert_identical_match(got, want)

    @pytest.mark.parametrize("length", [4200, 3000])
    def test_kernel_route_past_the_largest_bucket(self, cuda_device, length):
        """A strip cloud of 4200 px casts windows wider than the largest of
        ``_BUCKETS`` (4096): on the card its 8192 px bucket goes through
        kernel 11 and the detail pass, bit-equal to the torch form's passes
        on the card, and with the C++ scan's solutions and shadow mask. A
        strip of 3000 px stays in a 4096 px bucket."""
        from satellite_approximation_tpu_torch.config import MatchingConfig
        from satellite_approximation_tpu_torch.models.detection import cloud_mask, matching
        from satellite_approximation_tpu_torch.utils.profiling import StageTimer

        mask, psm, sun, view, diag = strip_scene(length)
        cmap, clouds = cloud_mask.partition_cloud_mask(mask, diag, 3)
        args = (clouds, cmap, mask, psm, diag, sun, view)
        timer = StageTimer(cuda_device)
        before = K.launch_counts["similarity_sweep"]
        got = matching.match_clouds_shadows(*args, MatchingConfig(backend="torch"),
                                            timer=timer, device=cuda_device)
        assert K.launch_counts["similarity_sweep"] == before + 1
        wb = 8192 if length > 4096 else 4096
        assert [n for n, _ in timer.stages if n.startswith("matching/sweep ")] == [
            f"matching/sweep {wb}x8 n=1"]

        def torch_form(*a, **kw):
            return matching._sweep(*a, **kw, separable=False)

        want = matching.match_clouds_shadows(*args, MatchingConfig(backend="torch"),
                                             sweep_fn=torch_form, device=cuda_device)
        _assert_identical_match(got, want)
        scan = matching.match_clouds_shadows(*args, MatchingConfig(backend="native"))
        assert np.array_equal(got.shadow_mask, scan.shadow_mask) and got.shadow_mask.any()
        for k, w in scan.solutions.items():
            assert (got.solutions[k].height, got.solutions[k].similarity) == (w.height, w.similarity)
            assert got.shadows[k].bounds == scan.shadows[k].bounds

    @pytest.mark.parametrize("backends", [("host", "native"), ("torch", "torch")],
                             ids=["host-route", "all-device-route"])
    def test_detect_launches_kernel_11_on_the_device_route(self, cuda_device, tmp_path,
                                                           backends):
        """``detect``'s device route sweeps with kernel 11 (a launch a
        bucket); the host route takes the native scan and launches none."""
        from torch_parity import mini_scene

        n = 512
        K.reset_launch_counts()
        _detect(mini_scene(n), n, backends, cuda_device, tmp_path / "card")
        launched = K.launch_counts["similarity_sweep"]
        assert launched > 0 if backends[1] == "torch" else launched == 0


# ------------------------------------------------------------ multi-device


def _shard_devices(cuda_device, n: int, separate: bool):
    """``n`` shards on one card, or on ``n`` separate cards (a skip on a
    host with fewer)."""
    from satellite_approximation_tpu_torch.parallel.mesh import spread_devices

    if not separate:
        return [cuda_device] * n
    if torch.cuda.device_count() < n:
        pytest.skip(f"one card a shard needs {n} CUDA devices, the host has "
                    f"{torch.cuda.device_count()}")
    return spread_devices(n, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("separate", [False, True], ids=["four-shards-one-card", "one-card-a-shard"])
class TestShardedOnCard:
    def test_sharded_fill_matches_one_device(self, cuda_device, separate):
        """sharded_fill on three meshes against the single-device fill on the
        card. The replicated tail runs kernels 1 and 2 where it has a level
        above the coarsest: on (1,4) here, whose tail is 40x56; the other
        two tails are 20x28, the dense coarse solve alone."""
        from satellite_approximation_tpu_torch.parallel import sharded_fill
        from satellite_approximation_tpu_torch.parallel.mesh import (
            spatial_band_mesh,
            spatial_mesh_2d,
        )
        from satellite_approximation_tpu_torch.parallel.mg import build_sharded_hierarchy

        devices = _shard_devices(cuda_device, 4, separate)
        imgs, m, *_ = bench_system(160, 224, 3)
        want = fill.laplace_fill(imgs, m, tolerance=1e-9, refinement_steps=4, device_output=False,
                                 device=cuda_device)
        for mesh in (spatial_band_mesh(4, shape=(1, 4), devices=devices),
                     spatial_band_mesh(4, shape=(2, 2), devices=devices),
                     spatial_mesh_2d(4, shape=(1, 2, 2), devices=devices)):
            K.reset_launch_counts()
            got, iters, rel = sharded_fill(imgs, m, mesh, tolerance=1e-9)
            if mesh.shape == {"b": 1, "x": 4}:
                assert len(build_sharded_hierarchy(m, neighbor_degree(m.shape), 4)[2]) == 2
                assert K.launch_counts["jacobi_zero"] > 0 and K.launch_counts["jacobi_corr"] > 0
            assert rel <= 1e-9 and iters > 0 and got.device == mesh.first_device
            np.testing.assert_allclose(got.cpu().numpy(), want.x, rtol=0, atol=1e-5)

    def test_sharded_stencils_bit_equal(self, cuda_device, separate):
        from satellite_approximation_tpu_torch.ops.blur import gaussian_blur
        from satellite_approximation_tpu_torch.ops.pitfill import pit_fill
        from satellite_approximation_tpu_torch.parallel.mesh import make_mesh
        from satellite_approximation_tpu_torch.parallel.stencils import (
            sharded_gaussian_blur,
            sharded_pit_fill,
        )

        mesh = make_mesh((4,), ("x",), _shard_devices(cuda_device, 4, separate))
        rng = np.random.default_rng(23)
        x = torch.from_numpy(rng.random((2, 256, 192)).astype(np.float32)).to(cuda_device)
        for sigma in (1.0, 4.0):
            assert torch.equal(sharded_gaussian_blur(x, sigma, mesh).to(cuda_device),
                               gaussian_blur(x, sigma))
        p = torch.from_numpy(rng.random((128, 96)).astype(np.float32)).to(cuda_device)
        p[40:90, 30:60] -= 0.5  # a deep pit across shard boundaries
        assert torch.equal(sharded_pit_fill(p, 0.3, mesh).to(cuda_device), pit_fill(p, 0.3))

    def test_sharded_detect_bit_equal(self, cuda_device, tmp_path, separate):
        """``detect`` with the device stages sharded over a flat mesh writes
        the four masks of the unsharded run, bit for bit."""
        from satellite_approximation_tpu_torch.parallel.mesh import make_mesh
        from torch_parity import mini_scene

        mesh = make_mesh((4,), ("d",), _shard_devices(cuda_device, 4, separate))
        n = 512
        scene = mini_scene(n)
        backends = ("torch", "torch")
        status, masks = _detect(scene, n, backends, cuda_device, tmp_path / "sharded", mesh=mesh)
        want_status, want = _detect(scene, n, backends, cuda_device, tmp_path / "one", mesh=None)
        assert masks["object_based_shadows"].any() and status == want_status
        for name, m in want.items():
            assert np.array_equal(masks[name], m), name

    def test_sharded_sweep_equals_one_device(self, cuda_device, separate):
        """The matching with ``sharded_sweep`` (kernel 11 on every shard, the
        torch form's passes) against one device's one pass a bucket: every
        result equal."""
        from satellite_approximation_tpu_torch.config import MatchingConfig
        from satellite_approximation_tpu_torch.models.detection import matching
        from satellite_approximation_tpu_torch.parallel.detect import sharded_sweep
        from satellite_approximation_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh((4,), ("d",), _shard_devices(cuda_device, 4, separate))
        args = _bucket_scene_inputs(4)
        want = matching.match_clouds_shadows(*args, MatchingConfig(backend="torch"),
                                             device=cuda_device)
        before = K.launch_counts["similarity_sweep"]
        got = matching.match_clouds_shadows(*args, MatchingConfig(backend="torch"),
                                            sweep_fn=sharded_sweep(mesh), device=cuda_device)
        assert K.launch_counts["similarity_sweep"] >= before + 4
        _assert_identical_match(got, want)

    def test_two_processes_bit_equal_to_one(self, cuda_device, tmp_path, separate):
        """The sharded MG-PCG on a (1,4) mesh of two processes of two shards,
        fresh interpreters on the card, against the same mesh in one
        process: x, iterations and residuals bit-equal. Four shards on one
        card go over gloo (pinned host buffers); one card a shard over
        NCCL (skipped on a host with fewer than four cards)."""
        from satellite_approximation_tpu_torch.parallel.mesh import ShardMesh
        from satellite_approximation_tpu_torch.parallel.multihost import free_port, run_processes

        import multihost_workers as W

        devices = _shard_devices(cuda_device, 4, separate)
        shape = (1, 4)
        coordinator = f"127.0.0.1:{free_port()}"
        run_processes([[W.__file__, "solve", "--coordinator", coordinator,
                        "--num-processes", "2", "--process-id", str(p), "--shape", "1", "4",
                        "--out", str(tmp_path), "--device", "cuda"] for p in range(2)],
                      timeout_s=300.0, env={} if separate else {"CUDA_VISIBLE_DEVICES": "0"})
        outs = [dict(np.load(tmp_path / f"solve_{p}.npz")) for p in range(2)]
        want = W.solve(ShardMesh(shape, ("b", "x"), devices), shape)
        assert str(outs[0]["backend"]) == ("nccl" if separate else "gloo")
        for out in outs:
            assert int(out["iterations"]) == int(want["iterations"]) > 0
            np.testing.assert_array_equal(out["rel"], want["rel"])
        np.testing.assert_array_equal(outs[0]["x"], want["x"])
        assert np.all(want["rel"] <= 1e-6)
