"""The four stencil kernels of the multigrid fill: hand-written CUDA for
Hopper (``csrc/jacobi.cu``, ``csrc/residual.cu``), each with its plain
PyTorch version beside it.

Counterpart of ``satellite_approximation_tpu/ops/pallas_kernels.py``:

=====================  ==========================================  ==============
wrapper                TPU kernel it replaces                       CUDA source
=====================  ==========================================  ==============
``jacobi_zero``        ``fused_jacobi_zero_tpu(_padded)``            jacobi.cu
``jacobi_corr``        ``fused_jacobi_corr_tpu_padded``              jacobi.cu
``residual_entry``     ``residual_entry_tpu_padded``                 residual.cu
``residual_pair``      ``residual_pair_tpu_padded``                  residual.cu
=====================  ==========================================  ==============

Shared contract (as the TPU kernels'): one (H, W) ``invm`` operand, 1/deg on
unknowns and 0 elsewhere (:func:`invm_for_kernel`), serves every band; the
stencil degree is recovered as round(1/invm), exact for bf16 storage too;
masking is by selects, never multiplies; arithmetic is f32, storage f32 or
bf16.

Each wrapper checks its operands, then runs the plain version when they lie
on the CPU and launches the CUDA kernel when they lie on a CUDA device. There
is no fallback: a CUDA tensor goes through the kernel or the wrapper raises.
Each kernel launch adds one to :data:`launch_counts`.

The kernels are compiled by ``nvcc`` at first use into ``csrc/build/`` (a
shared library with a plain C interface, loaded through ``ctypes``), keyed by
a hash of the sources.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
_SOURCES = ("jacobi.cu", "residual.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

HALO = 8  # window ring of jacobi.cu: general sweeps (+1 with residual) <= HALO
MAX_SWEEPS = 8

launch_counts = {"jacobi_zero": 0, "jacobi_corr": 0, "residual_entry": 0, "residual_pair": 0}

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
    unless that file exists; returns its path. The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) goes to
    ``csrc/build/nvcc_<hash>.log``."""
    sources = [CSRC / s for s in _SOURCES]
    digest = hashlib.sha256()
    for s in sources:
        digest.update(s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"libsatstencil_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libsatstencil_{tag}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (BUILD_DIR / f"nvcc_{tag}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sat_jacobi.argtypes = [i, i, i, p, p, p, p, p, p, i, i, i, i, i, i, p, p]
    lib.sat_jacobi.restype = i
    lib.sat_residual.argtypes = [i, i, p, p, p, p, p, p, i, i, i, p]
    lib.sat_residual.restype = i
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


def _check_omegas(name: str, omegas, general: int, emit_residual: bool) -> None:
    if not 1 <= len(omegas) <= MAX_SWEEPS:
        raise ValueError(f"{name}: {len(omegas)} sweeps, expected 1..{MAX_SWEEPS}")
    if general + int(emit_residual) > HALO:
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


def _neighbor_sum(u, unknown):
    up, down, left, right = _shift_taps(torch.where(unknown, u, 0.0))
    return ((up + down) + left) + right


def _sweeps(u, b, invm, unknown, deg, omegas):
    """Weighted-Jacobi sweeps on unknowns, in f32."""
    for om in omegas:
        au = deg * u - _neighbor_sum(u, unknown)
        u = torch.where(unknown, u + (om * (b - au)) * invm, u)
    return u


def _residual(u, b, unknown, deg):
    return torch.where(unknown, b - (deg * u - _neighbor_sum(u, unknown)), 0.0)


def _launch_jacobi(name, u, b, invm, e_c, omegas, emit_residual):
    """Launch jacobi.cu on CUDA operands: from zero when ``u`` is None, else
    from u + prolong(e_c)."""
    c, h, w = b.shape
    hc, wc = (1, 1) if e_c is None else e_c.shape[-2:]
    u_out = torch.empty_like(b)
    r = torch.empty_like(b) if emit_residual else None
    om = (ctypes.c_float * len(omegas))(*omegas)
    rc = _library().sat_jacobi(
        _DTYPE_CODE[b.dtype], int(u is None), int(emit_residual), _ptr(u), _ptr(b), _ptr(invm),
        _ptr(e_c), _ptr(u_out), _ptr(r), c, h, w, hc, wc, len(omegas),
        ctypes.cast(om, ctypes.c_void_p), _stream(),
    )
    _check_rc(rc, name)
    launch_counts[name] += 1
    return (u_out, r) if emit_residual else u_out


# ---------------------------------------------------------------- kernel 1


def jacobi_zero_plain(b, invm, omegas, emit_residual: bool):
    """K weighted-Jacobi sweeps of A u = b on unknowns from u = 0; the first
    sweep is u = omega_0 * b * invm. Computes in f32, returns the storage
    dtype of ``b``: u, or (u, r = (b - A u) * m)."""
    dtype = b.dtype
    bf = b.to(torch.float32)
    inv = invm.to(torch.float32)
    unknown, deg = _unknown_deg(inv)
    u = torch.where(unknown, (omegas[0] * bf) * inv, 0.0)
    u = _sweeps(u, bf, inv, unknown, deg, omegas[1:])
    if not emit_residual:
        return u.to(dtype)
    return u.to(dtype), _residual(u, bf, unknown, deg).to(dtype)


def jacobi_zero(b: torch.Tensor, invm: torch.Tensor, omegas, emit_residual: bool = True):
    """Pre-smooth from zero: the V-cycle's first smoother on every level
    above the coarsest. ``b`` (C, H, W) f32 or bf16, ``invm`` (H, W) in the
    same dtype."""
    name = "jacobi_zero"
    _check(name, b, tuple(_DTYPE_CODE), (None, None, None))
    _check(name, invm, (b.dtype,), b.shape[-2:])
    omegas = tuple(float(o) for o in omegas)
    _check_omegas(name, omegas, len(omegas) - 1, emit_residual)
    if not _on_cuda(name, (b, invm)):
        return jacobi_zero_plain(b, invm, omegas, emit_residual)
    return _launch_jacobi(name, None, b, invm, None, omegas, emit_residual)


# ---------------------------------------------------------------- kernel 2


def prolong(e: torch.Tensor, fine_shape) -> torch.Tensor:
    """Piecewise-constant 2x2 block broadcast to the fine grid (P = R^T)."""
    up = e.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return up[..., : fine_shape[-2], : fine_shape[-1]]


def jacobi_corr_plain(u, b, invm, e_c, omegas, emit_residual: bool):
    """u + prolong(e_c) on unknowns, then K weighted-Jacobi sweeps. Computes
    in f32, returns the storage dtype of ``u``: u, or (u, r)."""
    dtype = u.dtype
    bf = b.to(torch.float32)
    inv = invm.to(torch.float32)
    unknown, deg = _unknown_deg(inv)
    corr = prolong(e_c.to(torch.float32), u.shape)
    u = u.to(torch.float32) + torch.where(unknown, corr, 0.0)
    u = _sweeps(u, bf, inv, unknown, deg, omegas)
    if not emit_residual:
        return u.to(dtype)
    return u.to(dtype), _residual(u, bf, unknown, deg).to(dtype)


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
    _check_omegas(name, omegas, len(omegas), emit_residual)
    if not _on_cuda(name, (u, b, invm, e_c)):
        return jacobi_corr_plain(u, b, invm, e_c, omegas, emit_residual)
    return _launch_jacobi(name, u, b, invm, e_c, omegas, emit_residual)


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
