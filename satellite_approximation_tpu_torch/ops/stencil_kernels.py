"""The stencil kernels of the multigrid fill and its smoother family:
hand-written CUDA for Hopper (``csrc/*.cu``), each with its plain PyTorch
version beside it.

Counterpart of ``satellite_approximation_tpu/ops/pallas_kernels.py`` and of
the two Pallas kernels under ``benchmarks/``:

=====================  ==============================================  =============
wrapper                TPU kernel it replaces                           CUDA source
=====================  ==============================================  =============
``jacobi_zero``        ``fused_jacobi_zero_tpu(_padded)``                jacobi.cu
``jacobi_zero`` with   ``_zero_call(emit_residual="half")``              jacobi.cu
``"half"``
``jacobi``             ``fused_jacobi_tpu(_padded)``                     jacobi.cu
``jacobi_corr``        ``fused_jacobi_corr_tpu_padded``                  jacobi.cu
``residual_entry``     ``residual_entry_tpu_padded``                     residual.cu
``residual_pair``      ``residual_pair_tpu_padded``                      residual.cu
``jacobi_v2``          ``benchmarks/x_kernel_v2.py::fused_jacobi_v2``    jacobi_v2.cu
``stride2``            ``benchmarks/x_stride_probe.py::probe``           stride.cu
=====================  ==============================================  =============

Kernel 9, the pit fill's directional pass (``csrc/pitfill.cu``), kernel
10, the connected-component labelling with its two passes over the labels
(``csrc/components.cu``), and kernel 11, the matching's similarity sweep
(``csrc/sweep.cu``), replace no TPU kernel; their wrappers are in
``ops/pitfill_kernels.py``, ``ops/components.py`` and
``ops/sweep_kernels.py`` and build into the same library.

Shared contract of the package's kernels (as the TPU kernels'): one (H, W)
``invm`` operand, 1/deg on unknowns and 0 elsewhere (:func:`invm_for_kernel`),
serves every band; the stencil degree is recovered as round(1/invm), exact
for bf16 storage too; masking is by selects, never multiplies; arithmetic is
f32, storage f32 or bf16. ``jacobi_v2`` keeps its benchmark's own contract:
separate mask and degree operands, masking by multiplies; its kernel reads
the bool mask and the degree as the caller gives them.

Each wrapper checks its operands, then runs the plain version when they lie
on the CPU and launches the CUDA kernel when they lie on a CUDA device. There
is no fallback: a CUDA tensor goes through the kernel or the wrapper raises.
Each kernel launch adds one to :data:`launch_counts`.

The kernels are compiled by ``nvcc`` at first use into ``csrc/build/`` (one
compiler process per source, all started together, linked into a shared
library with a plain C interface that ``ctypes`` loads), keyed by a hash of
the sources.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
_SOURCES = ("jacobi.cu", "jacobi_v2.cu", "residual.cu", "stride.cu", "pitfill.cu",
            "components.cu", "sweep.cu")
_HEADERS = ("stencil.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

HALO = 8  # window ring of jacobi.cu: general sweeps (+1 with residual) <= HALO
MAX_SWEEPS = 8

launch_counts = {
    "jacobi_zero": 0, "jacobi_zero_half": 0, "jacobi": 0, "jacobi_corr": 0,
    "residual_entry": 0, "residual_pair": 0, "jacobi_v2": 0, "stride2": 0,
    "directional_pass": 0,  # kernel 9, ops/pitfill_kernels.py
    "label_components": 0, "region_stats": 0, "region_ids": 0,  # kernel 10, ops/components.py
    "similarity_sweep": 0,  # kernel 11, ops/sweep_kernels.py
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def build() -> Path:
    """Compile the CUDA sources into ``csrc/build/libsatstencil_<hash>.so``
    unless that file exists; returns its path. Each source compiles in its
    own ``nvcc`` process, all started together. The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) goes to
    ``csrc/build/nvcc_<hash>.log``."""
    sources = [CSRC / s for s in _SOURCES]
    digest = hashlib.sha256()
    for s in sources + [CSRC / h for h in _HEADERS]:
        digest.update(s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"libsatstencil_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir)
        objs = [tmp / f"{s.stem}.o" for s in sources]
        logs = [tmp / f"{s.stem}.log" for s in sources]
        procs = []
        try:
            for src, obj, log in zip(sources, objs, logs):
                with open(log, "w") as fh:
                    procs.append(subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                        stdout=fh, stderr=subprocess.STDOUT,
                    ))
        finally:
            codes = [p.wait() for p in procs]
        report = "".join(f"== {s.name}\n{log.read_text()}" for s, log in zip(sources, logs))
        failed = [s.name for s, rc in zip(sources, codes) if rc != 0]
        if not failed:
            proc = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp / lib.name), *map(str, objs)],
                capture_output=True, text=True, check=False,
            )
            report += f"== link\n{proc.stdout}{proc.stderr}"
            if proc.returncode != 0:
                failed = ["link"]
        (BUILD_DIR / f"nvcc_{tag}.log").write_text(report)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{report[-4000:]}")
        os.replace(tmp / lib.name, lib)  # atomic: a concurrent build never loads a partial file
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.sat_jacobi.argtypes = [i, i, i, p, p, p, p, p, p, i, i, i, i, i, i, p, p]
    lib.sat_jacobi.restype = i
    lib.sat_jacobi_v2.argtypes = [i, i, i, p, p, p, p, p, p, i, i, i, i, f, p]
    lib.sat_jacobi_v2.restype = i
    lib.sat_residual.argtypes = [i, i, p, p, p, p, p, p, i, i, i, p]
    lib.sat_residual.restype = i
    lib.sat_stride2.argtypes = [i, p, p, ll, i, i, p]
    lib.sat_stride2.restype = i
    lib.sat_directional_pass.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.sat_directional_pass.restype = i
    lib.sat_directional_geometry.argtypes = [p, p, p]
    lib.sat_directional_geometry.restype = i
    lib.sat_label_components.argtypes = [p, p, i, i, i, p]
    lib.sat_label_components.restype = i
    lib.sat_region_stats.argtypes = [p, i, i, p, p, p, p, p, p, p]
    lib.sat_region_stats.restype = i
    lib.sat_region_ids.argtypes = [p, i, i, p, p, p]
    lib.sat_region_ids.restype = i
    lib.sat_similarity_sweep.argtypes = [p, p, p, ll, i, i, i, p, p, p, p, p, p, p, i, i, i, i, p,
                                         p]
    lib.sat_similarity_sweep.restype = i
    return lib


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _on_cuda(name: str, tensors) -> bool:
    """True when every operand lies on one CUDA device, False when all lie
    on the CPU; raises for a mix or another device type. A CUDA operand must
    be contiguous (the kernels index dense rasters)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: CUDA operands must be contiguous")
    return True


def _check(name: str, t, dtypes: tuple, shape: tuple) -> None:
    """Raise unless ``t`` is a tensor of one of ``dtypes`` whose shape
    matches ``shape`` (None matches any extent)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != len(shape) or any(s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not match {shape}")


def _check_omegas(name: str, omegas, general: int, emit_residual) -> None:
    if not 1 <= len(omegas) <= MAX_SWEEPS:
        raise ValueError(f"{name}: {len(omegas)} sweeps, expected 1..{MAX_SWEEPS}")
    if general + int(bool(emit_residual)) > HALO:
        raise ValueError(
            f"{name}: {general} sweeps (+residual ring: {emit_residual}) exceed the halo {HALO}"
        )


def invm_for_kernel(umask: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """The merged mask+degree operand, f32: 1/deg on unknowns, 0 elsewhere
    (pallas_kernels.invm_for_kernel)."""
    degf = deg.to(torch.float32)
    inv0 = torch.where(degf > 0, 1.0 / degf, 0.0)
    return torch.where(umask, inv0, 0.0)


def _unknown_deg(invm: torch.Tensor):
    """(unknown, deg): the select mask and the exact stencil degree rounded
    back from invm (1.0 on knowns, where it only has to stay finite)."""
    invm = invm.to(torch.float32)
    unknown = invm > 0
    deg = torch.where(unknown, torch.round(1.0 / torch.where(unknown, invm, 1.0)), 1.0)
    return unknown, deg


def _shift_taps(x: torch.Tensor):
    """(up, down, left, right) 4-neighbour taps of the last two axes, zero
    outside — the operand order of ``shift_sum``."""
    h, w = x.shape[-2], x.shape[-1]
    p = F.pad(x, (1, 1, 1, 1))
    return (
        p[..., 0:h, 1 : w + 1],
        p[..., 2 : h + 2, 1 : w + 1],
        p[..., 1 : h + 1, 0:w],
        p[..., 1 : h + 1, 2 : w + 2],
    )


def _tap_sum(x: torch.Tensor) -> torch.Tensor:
    up, down, left, right = _shift_taps(x)
    return ((up + down) + left) + right


def _neighbor_sum(u, unknown):
    return _tap_sum(torch.where(unknown, u, 0.0))


def _sweeps(u, b, invm, unknown, deg, omegas):
    """Weighted-Jacobi sweeps on unknowns, in f32."""
    for om in omegas:
        au = deg * u - _neighbor_sum(u, unknown)
        u = torch.where(unknown, u + (om * (b - au)) * invm, u)
    return u


def _residual(u, b, unknown, deg):
    return torch.where(unknown, b - (deg * u - _neighbor_sum(u, unknown)), 0.0)


def _finish(u, b, unknown, deg, dtype, emit_residual):
    """The smoothers' outputs in the storage dtype: u, or (u, r), or with
    ``"half"`` (u, the row pass of the stored r)."""
    if not emit_residual:
        return u.to(dtype)
    r = _residual(u, b, unknown, deg).to(dtype)
    return u.to(dtype), restrict_rows(r) if emit_residual == "half" else r


def restrict_rows(r: torch.Tensor) -> torch.Tensor:
    """Row pass of the 2x2 block restrict: r[2i] + r[2i + 1], even row
    first, an odd height padded with a zero row."""
    if r.shape[-2] % 2:
        r = F.pad(r, (0, 0, 0, 1))
    return r[..., 0::2, :] + r[..., 1::2, :]


_START_ZERO, _START_U, _START_CORR = 0, 1, 2


def _launch_jacobi(name, start, u, b, invm, e_c, omegas, emit_residual):
    """Launch jacobi.cu on CUDA operands, from zero, from ``u``, or from
    u + prolong(e_c) (``start``)."""
    c, h, w = b.shape
    hc, wc = (1, 1) if e_c is None else e_c.shape[-2:]
    u_out = torch.empty_like(b)
    if emit_residual == "half":
        r = b.new_empty((c, (h + 1) // 2, w))
    else:
        r = torch.empty_like(b) if emit_residual else None
    emit = 2 if emit_residual == "half" else int(bool(emit_residual))
    om = (ctypes.c_float * len(omegas))(*omegas)
    rc = _library().sat_jacobi(
        _DTYPE_CODE[b.dtype], start, emit, _ptr(u), _ptr(b), _ptr(invm), _ptr(e_c),
        _ptr(u_out), _ptr(r), c, h, w, hc, wc, len(omegas), ctypes.cast(om, ctypes.c_void_p),
        _stream(),
    )
    _check_rc(rc, name)
    launch_counts[name] += 1
    return u_out if r is None else (u_out, r)


# ------------------------------------------------------------ kernels 1 and 6


def jacobi_zero_plain(b, invm, omegas, emit_residual):
    """K weighted-Jacobi sweeps of A u = b on unknowns from u = 0; the first
    sweep is u = omega_0 * b * invm. Computes in f32, returns the storage
    dtype of ``b``: u, or (u, r = (b - A u) * m), or with ``"half"`` (u, the
    row pass of that stored r, (C, ceil(H/2), W))."""
    bf = b.to(torch.float32)
    inv = invm.to(torch.float32)
    unknown, deg = _unknown_deg(inv)
    u = torch.where(unknown, (omegas[0] * bf) * inv, 0.0)
    u = _sweeps(u, bf, inv, unknown, deg, omegas[1:])
    return _finish(u, bf, unknown, deg, b.dtype, emit_residual)


def jacobi_zero(b: torch.Tensor, invm: torch.Tensor, omegas, emit_residual=True):
    """Pre-smooth from zero: the V-cycle's first smoother on every level
    above the coarsest. ``b`` (C, H, W) f32 or bf16, ``invm`` (H, W) in the
    same dtype. ``emit_residual``: False, True, or ``"half"`` for the
    residual with its row pairs summed (the row pass of the restrict fused
    in; counted as ``jacobi_zero_half``)."""
    if emit_residual not in (False, True, "half"):
        raise ValueError(f"jacobi_zero: emit_residual={emit_residual!r}")
    name = "jacobi_zero_half" if emit_residual == "half" else "jacobi_zero"
    _check(name, b, tuple(_DTYPE_CODE), (None, None, None))
    _check(name, invm, (b.dtype,), b.shape[-2:])
    omegas = tuple(float(o) for o in omegas)
    _check_omegas(name, omegas, len(omegas) - 1, emit_residual)
    if not _on_cuda(name, (b, invm)):
        return jacobi_zero_plain(b, invm, omegas, emit_residual)
    return _launch_jacobi(name, _START_ZERO, None, b, invm, None, omegas, emit_residual)


# ---------------------------------------------------------------- kernel 3


def jacobi_plain(u, b, invm, omegas, emit_residual: bool):
    """K weighted-Jacobi sweeps of A u = b on unknowns from the given ``u``.
    Computes in f32, returns the storage dtype of ``u``: u, or (u, r)."""
    bf = b.to(torch.float32)
    inv = invm.to(torch.float32)
    unknown, deg = _unknown_deg(inv)
    uf = _sweeps(u.to(torch.float32), bf, inv, unknown, deg, omegas)
    return _finish(uf, bf, unknown, deg, u.dtype, emit_residual)


def jacobi(u, b, invm, omegas, emit_residual: bool = False):
    """Smoother from a given iterate: ``u``, ``b`` (C, H, W), ``invm``
    (H, W), all f32 or all bf16; ``omegas`` one weight per sweep, sweeps
    (+1 with the residual) <= 8."""
    name = "jacobi"
    _check(name, u, tuple(_DTYPE_CODE), (None, None, None))
    _check(name, b, (u.dtype,), tuple(u.shape))
    _check(name, invm, (u.dtype,), u.shape[-2:])
    omegas = tuple(float(o) for o in omegas)
    emit_residual = bool(emit_residual)
    _check_omegas(name, omegas, len(omegas), emit_residual)
    if not _on_cuda(name, (u, b, invm)):
        return jacobi_plain(u, b, invm, omegas, emit_residual)
    return _launch_jacobi(name, _START_U, u, b, invm, None, omegas, emit_residual)


# ---------------------------------------------------------------- kernel 2


def prolong(e: torch.Tensor, fine_shape) -> torch.Tensor:
    """Piecewise-constant 2x2 block broadcast to the fine grid (P = R^T)."""
    up = e.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return up[..., : fine_shape[-2], : fine_shape[-1]]


def jacobi_corr_plain(u, b, invm, e_c, omegas, emit_residual: bool):
    """u + prolong(e_c) on unknowns, then K weighted-Jacobi sweeps. Computes
    in f32, returns the storage dtype of ``u``: u, or (u, r)."""
    bf = b.to(torch.float32)
    inv = invm.to(torch.float32)
    unknown, deg = _unknown_deg(inv)
    corr = prolong(e_c.to(torch.float32), u.shape)
    uf = u.to(torch.float32) + torch.where(unknown, corr, 0.0)
    uf = _sweeps(uf, bf, inv, unknown, deg, omegas)
    return _finish(uf, bf, unknown, deg, u.dtype, emit_residual)


def jacobi_corr(u, b, invm, e_c, omegas, emit_residual: bool = False):
    """Post-smooth with the coarse correction fused in: ``u``, ``b``
    (C, H, W), ``invm`` (H, W), ``e_c`` (C, ceil(H/2), ceil(W/2)), all f32
    or all bf16. ``omegas`` in the order applied (the V-cycle passes the
    pre-smooth weights reversed)."""
    name = "jacobi_corr"
    _check(name, u, tuple(_DTYPE_CODE), (None, None, None))
    c, h, w = u.shape
    hc, wc = (h + 1) // 2, (w + 1) // 2
    _check(name, b, (u.dtype,), (c, h, w))
    _check(name, invm, (u.dtype,), (h, w))
    _check(name, e_c, (u.dtype,), (c, hc, wc))
    omegas = tuple(float(o) for o in omegas)
    emit_residual = bool(emit_residual)
    _check_omegas(name, omegas, len(omegas), emit_residual)
    if not _on_cuda(name, (u, b, invm, e_c)):
        return jacobi_corr_plain(u, b, invm, e_c, omegas, emit_residual)
    return _launch_jacobi(name, _START_CORR, u, b, invm, e_c, omegas, emit_residual)


# ---------------------------------------------------------- kernels 4 and 5


def two_sum(a, b):
    """Knuth TwoSum: (s, e) with s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def cascade(terms):
    """Neumaier compensated sum: (s, c), every rounding error of the running
    sum recovered by TwoSum and accumulated in c."""
    s, c = two_sum(terms[0], terms[1])
    for t in terms[2:]:
        s, e = two_sum(s, t)
        c = c + e
    return s, c


def residual_entry_plain(img, invm):
    """Entry state x_hi = img * m, x_lo = 0: (r, b) with
    r = (b - A x_hi) * m by the TwoSum cascade and b = sum of the known
    neighbours on unknowns."""
    unknown, deg = _unknown_deg(invm)
    kf = torch.where(unknown, 4.0 - deg, 0.0)
    xh = torch.where(unknown, img, 0.0)
    s, c = cascade(list(_shift_taps(img)) + [-4.0 * xh, kf * xh])
    r = torch.where(unknown, s + c, 0.0)
    k1, k2, k3, k4 = _shift_taps(torch.where(unknown, 0.0, img))
    b = torch.where(unknown, ((k1 + k2) + k3) + k4, 0.0)
    return r, b


def residual_pair_plain(img, x_hi, x_lo, invm):
    """r = (b - A (x_hi + x_lo)) * m: TwoSum cascade over the hi terms of
    y = known + x_hi (a select: the supports are disjoint), lo terms in f32."""
    unknown, deg = _unknown_deg(invm)
    kf = torch.where(unknown, 4.0 - deg, 0.0)
    y = torch.where(unknown, x_hi, img)
    s, c = cascade(list(_shift_taps(y)) + [-4.0 * x_hi, kf * x_hi])
    l1, l2, l3, l4 = _shift_taps(x_lo)
    lo = l1 + l2 + l3 + l4 - 4.0 * x_lo + kf * x_lo
    return torch.where(unknown, s + (c + lo), 0.0)


def _check_residual(name, img, others, invm):
    _check(name, img, (torch.float32,), (None, None, None))
    c, h, w = img.shape
    for t in others:
        _check(name, t, (torch.float32,), (c, h, w))
    _check(name, invm, tuple(_DTYPE_CODE), (h, w))
    return _on_cuda(name, (img, *others, invm))


def residual_entry(img: torch.Tensor, invm: torch.Tensor):
    """(r, b) of the laplace entry state; ``img`` (C, H, W) f32, ``invm``
    (H, W) f32 or bf16."""
    name = "residual_entry"
    if not _check_residual(name, img, (), invm):
        return residual_entry_plain(img, invm)
    c, h, w = img.shape
    r = torch.empty_like(img)
    b = torch.empty_like(img)
    rc = _library().sat_residual(
        _DTYPE_CODE[invm.dtype], 0, _ptr(img), None, None, _ptr(invm), _ptr(r), _ptr(b),
        c, h, w, _stream(),
    )
    _check_rc(rc, name)
    launch_counts[name] += 1
    return r, b


def residual_pair(img, x_hi, x_lo, invm):
    """r of the double-float iterate (x_hi, x_lo); ``img``, ``x_hi``,
    ``x_lo`` (C, H, W) f32 (x_hi, x_lo zero on knowns), ``invm`` (H, W) f32
    or bf16."""
    name = "residual_pair"
    if not _check_residual(name, img, (x_hi, x_lo), invm):
        return residual_pair_plain(img, x_hi, x_lo, invm)
    c, h, w = img.shape
    r = torch.empty_like(img)
    rc = _library().sat_residual(
        _DTYPE_CODE[invm.dtype], 1, _ptr(img), _ptr(x_hi), _ptr(x_lo), _ptr(invm), _ptr(r),
        None, c, h, w, _stream(),
    )
    _check_rc(rc, name)
    launch_counts[name] += 1
    return r


# ---------------------------------------------------------------- kernel 7


def jacobi_v2_plain(u, b, umask, deg, sweeps: int, omega: float, emit_residual: bool):
    """``sweeps`` damped-Jacobi sweeps with one ``omega`` from ``u``, masking
    by multiplies: m = umask and deg in the storage dtype of ``u``,
    inv = where(deg > 0, 1/deg, 0) * m, u + (omega * (b - A u)) * inv on
    every cell. Computes in f32, returns the storage dtype: u, or
    (u, r = (b - A u) * m)."""
    dtype = u.dtype
    bf = b.to(torch.float32)
    m = umask.to(dtype).to(torch.float32)
    d = deg.to(dtype).to(torch.float32)
    inv = torch.where(d > 0, 1.0 / d, 0.0) * m
    uf = u.to(torch.float32)
    for _ in range(sweeps):
        au = d * uf - _tap_sum(uf * m)
        uf = uf + (omega * (bf - au)) * inv
    if not emit_residual:
        return uf.to(dtype)
    r = (bf - (d * uf - _tap_sum(uf * m))) * m
    return uf.to(dtype), r.to(dtype)


def jacobi_v2(u, b, umask, deg, sweeps: int = 8, omega: float = 0.8,
              emit_residual: bool = False):
    """The smoother with separate mask and degree operands: ``u``, ``b``
    (C, H, W) f32 or bf16, ``umask`` (H, W) bool, ``deg`` (H, W) f32 or the
    storage dtype; sweeps (+1 with the residual) <= 8."""
    name = "jacobi_v2"
    _check(name, u, tuple(_DTYPE_CODE), (None, None, None))
    c, h, w = u.shape
    _check(name, b, (u.dtype,), (c, h, w))
    _check(name, umask, (torch.bool,), (h, w))
    _check(name, deg, (torch.float32, u.dtype), (h, w))
    emit_residual = bool(emit_residual)
    _check_omegas(name, (float(omega),) * sweeps, sweeps, emit_residual)
    if not _on_cuda(name, (u, b, umask, deg)):
        return jacobi_v2_plain(u, b, umask, deg, sweeps, omega, emit_residual)
    # the kernel reads the bool mask as bytes and rounds deg to u's dtype itself
    u_out = torch.empty_like(u)
    r = torch.empty_like(u) if emit_residual else None
    rc = _library().sat_jacobi_v2(
        _DTYPE_CODE[u.dtype], _DTYPE_CODE[deg.dtype], int(emit_residual), _ptr(u), _ptr(b),
        _ptr(umask), _ptr(deg), _ptr(u_out), _ptr(r), c, h, w, sweeps, float(omega), _stream(),
    )
    _check_rc(rc, name)
    launch_counts[name] += 1
    return u_out if r is None else (u_out, r)


# ---------------------------------------------------------------- kernel 8

STRIDE2_MODES = {"rows": 0, "cols": 1, "both": 2, "interleave": 3}


def stride2_plain(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The stride-2 idioms of the last two axes: ``rows`` x[..., 0::2, :],
    ``cols`` x[..., :, 0::2], ``both`` x[..., 0::2, 0::2], ``interleave``
    y[..., 0::2] = x[..., :C/2] and y[..., 1::2] = x[..., :C/2] + 1."""
    if mode == "rows":
        return x[..., 0::2, :].contiguous()
    if mode == "cols":
        return x[..., :, 0::2].contiguous()
    if mode == "both":
        return x[..., 0::2, 0::2].contiguous()
    half = x[..., : x.shape[-1] // 2]
    return torch.stack([half, half + 1.0], dim=-1).reshape(x.shape)


def stride2(x: torch.Tensor, mode: str) -> torch.Tensor:
    """:func:`stride2_plain` of an f32 ``x`` (..., R, C); ``interleave``
    needs an even C."""
    name = "stride2"
    if mode not in STRIDE2_MODES:
        raise ValueError(f"{name}: mode {mode!r} not in {sorted(STRIDE2_MODES)}")
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.dim() < 2:
        raise TypeError(f"{name}: expected an f32 tensor of at least two axes")
    rows, cols = x.shape[-2:]
    if mode == "interleave" and cols % 2:
        raise ValueError(f"{name}: interleave needs an even last axis, got {cols}")
    if not _on_cuda(name, (x,)):
        return stride2_plain(x, mode)
    out_rows = rows if mode in ("cols", "interleave") else (rows + 1) // 2
    out_cols = cols if mode in ("rows", "interleave") else (cols + 1) // 2
    y = x.new_empty((*x.shape[:-2], out_rows, out_cols))
    planes = x.numel() // max(rows * cols, 1)
    rc = _library().sat_stride2(
        STRIDE2_MODES[mode], _ptr(x), _ptr(y), planes, rows, cols, _stream()
    )
    _check_rc(rc, name)
    launch_counts[name] += 1
    return y
