// Fused Chebyshev-weighted Jacobi smoother of the masked 5-point operator
//
//     A u = deg * u - sum of the unknown 4-neighbours of u
//
// for the multigrid V-cycle (models/multigrid.py::_v_cycle, _smooth).
//
// Replaces, in satellite_approximation_tpu/ops/pallas_kernels.py
// (_kernel_factory, called through _zero_call and the jitted wrappers):
//   * fused_jacobi_zero_tpu / fused_jacobi_zero_tpu_padded (zero_start=True):
//     the pre-smooth from u = 0, emitting (u, r = (b - A u) * m)
//                                           -> jacobi_kernel<T, FROM_ZERO, *>
//   * the same with emit_residual="half": r comes out with its row pairs
//     already summed, r[2i] + r[2i + 1] (the row pass of _restrict), into a
//     (C, ceil(H/2), W) raster          -> jacobi_kernel<T, FROM_ZERO, EMIT_HALF>
//   * fused_jacobi_tpu / fused_jacobi_tpu_padded: K sweeps from a given u,
//     r on request                      -> jacobi_kernel<T, FROM_U, *>
//   * fused_jacobi_corr_tpu_padded (fuse_corr=True): the post-smooth,
//     u += prolong(e_c) on unknowns and then K sweeps, r on request
//                                           -> jacobi_kernel<T, FROM_U_CORR, *>
//
// What bounds it on an H100: as torch ops the smoother is bound by device
// memory, about 6 rasters moved per sweep (K = 7 sweeps, ~40 rasters a call).
// Here the sweeps run out of shared memory and device memory sees one read of
// b and invm (plus u, and the quarter-size e_c for the post-smooth) and one
// write of u and r: 4-5 rasters a call (the half residual writes half a
// raster). That leaves the kernel bound by its shared-memory sweeps (~12 word
// accesses per window cell per sweep) and the halo recompute: on an H100
// 80GB HBM3 at 700 W the zero-start call at 13x2048x2048 f32 took 1.45 ms for
// ~1.2 GB of device traffic, about a quarter of the memory's peak rate.
//
// Design (window geometry in stencil.cuh): one block per (band, 48x48 tile)
// with an 8-cell ring, a 64x64 window in shared memory; cells outside the
// image load as b = 0, invm = 0, u = 0, i.e. known. All sweeps run in shared
// memory with two u buffers (a Jacobi sweep reads only the previous sweep's
// values); sweep t is computed only where the ring index is >= t, and only
// the interior is written back, exact while sweeps (+1 with a residual) <= 8.
// The zero-start first sweep is purely local (A 0 = 0), so it does not
// count. The half residual pairs rows inside the tile: TILE is even and
// tiles start on even rows, so a pair never straddles two blocks, and for
// odd H the last row pairs with the known cell below the image (+0), as
// _restrict pads it with a zero row.
//
// Arithmetic is f32 in the operand order of the plain version
// (ops/stencil_kernels.py): neighbour sum ((up + down) + left) + right,
// au = deg*u - nsum, u + (omega*(b - au))*invm, masking by selects. Built with
// -fmad=false and without fast math, so it is bit-equal to the plain version.
// Storage is f32 or bf16 (rounded to nearest even on store; the half
// residual rounds each row's r and then their sum, as the plain row pass of
// the stored residual does).

#include "stencil.cuh"

namespace {

using namespace stencil;

constexpr size_t SMEM_BYTES = 5 * CELLS * sizeof(float);  // u0, u1, b, invm, deg

// where the sweeps start
enum Start { FROM_ZERO = 0, FROM_U = 1, FROM_U_CORR = 2 };
// what is written besides u
enum Emit { EMIT_NONE = 0, EMIT_FULL = 1, EMIT_HALF = 2 };

struct Args {
  const void* u;     // (C, H, W), unused FROM_ZERO
  const void* b;     // (C, H, W)
  const void* invm;  // (H, W)
  const void* ec;    // (C, Hc, Wc), read only FROM_U_CORR
  void* u_out;       // (C, H, W)
  void* r_out;       // (C, H, W), or (C, ceil(H/2), W) for EMIT_HALF
  int C, H, W, Hc, Wc, sweeps;
  float w[MAX_SWEEPS];
};

// sum of the unknown 4-neighbours of window cell idx
__device__ __forceinline__ float neighbour_sum(const float* u, const float* sinv, int idx) {
  const float nu = sinv[idx - WIN] > 0.f ? u[idx - WIN] : 0.f;
  const float nd = sinv[idx + WIN] > 0.f ? u[idx + WIN] : 0.f;
  const float nl = sinv[idx - 1] > 0.f ? u[idx - 1] : 0.f;
  const float nr = sinv[idx + 1] > 0.f ? u[idx + 1] : 0.f;
  return ((nu + nd) + nl) + nr;
}

// (b - A u) on an unknown window cell, 0 on a known one
__device__ __forceinline__ float residual_at(const float* u, const float* sb, const float* sinv,
                                             const float* sdeg, int idx) {
  if (!(sinv[idx] > 0.f)) return 0.f;
  const float au = sdeg[idx] * u[idx] - neighbour_sum(u, sinv, idx);
  return sb[idx] - au;
}

template <typename T, int START, int EMIT>
__global__ void __launch_bounds__(THREADS) jacobi_kernel(const Args a) {
  extern __shared__ float smem[];
  float* su0 = smem;
  float* su1 = su0 + CELLS;
  float* sb = su1 + CELLS;
  float* sinv = sb + CELLS;
  float* sdeg = sinv + CELLS;
  const T* __restrict__ u_in = static_cast<const T*>(a.u);
  const T* __restrict__ b = static_cast<const T*>(a.b);
  const T* __restrict__ invm = static_cast<const T*>(a.invm);
  const T* __restrict__ ec = static_cast<const T*>(a.ec);
  T* __restrict__ u_out = static_cast<T*>(a.u_out);
  T* __restrict__ r_out = static_cast<T*>(a.r_out);
  const int H = a.H, W = a.W;

  const int c = blockIdx.z;
  const int i0 = blockIdx.y * TILE - R;
  const int j0 = blockIdx.x * TILE - R;
  const size_t band = (size_t)c * H * W;

  for (int idx = threadIdx.x; idx < CELLS; idx += THREADS) {
    const int gi = i0 + idx / WIN;
    const int gj = j0 + idx % WIN;
    float bv = 0.f, iv = 0.f, uv = 0.f;
    const bool inside = gi >= 0 && gi < H && gj >= 0 && gj < W;
    if (inside) {
      const size_t p = (size_t)gi * W + gj;
      bv = to_f32(b[band + p]);
      iv = to_f32(invm[p]);
      if (START != FROM_ZERO) uv = to_f32(u_in[band + p]);
    }
    const bool unk = iv > 0.f;
    if (START == FROM_ZERO) {
      uv = unk ? (a.w[0] * bv) * iv : 0.f;
    } else if (START == FROM_U_CORR) {
      const float e =
          unk ? to_f32(ec[(size_t)c * a.Hc * a.Wc + (size_t)(gi >> 1) * a.Wc + (gj >> 1)]) : 0.f;
      uv = uv + e;
    }
    su0[idx] = uv;
    sb[idx] = bv;
    sinv[idx] = iv;
    // exact stencil degree: 1/(1/d) round trips in f32, and the rounding
    // restores it from a bf16-stored invm
    sdeg[idx] = unk ? rintf(1.f / iv) : 1.f;
  }
  __syncthreads();

  float* cur = su0;
  float* nxt = su1;
  int t = 0;  // general sweeps done
  for (int s = START == FROM_ZERO ? 1 : 0; s < a.sweeps; ++s) {
    ++t;
    const float w = a.w[s];
    for (int idx = threadIdx.x; idx < CELLS; idx += THREADS) {
      const float uc = cur[idx];
      float un = uc;
      if (sinv[idx] > 0.f && ring_of(idx / WIN, idx % WIN) >= t) {
        const float au = sdeg[idx] * uc - neighbour_sum(cur, sinv, idx);
        un = uc + (w * (sb[idx] - au)) * sinv[idx];
      }
      nxt[idx] = un;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int k = threadIdx.x; k < TILE * TILE; k += THREADS) {
    const int wi = R + k / TILE;
    const int wj = R + k % TILE;
    const int gi = i0 + wi;
    const int gj = j0 + wj;
    if (gi >= H || gj >= W) continue;
    const int idx = wi * WIN + wj;
    const size_t o = band + (size_t)gi * W + gj;
    u_out[o] = from_f32<T>(cur[idx]);
    if (EMIT == EMIT_FULL) r_out[o] = from_f32<T>(residual_at(cur, sb, sinv, sdeg, idx));
  }
  if (EMIT == EMIT_HALF) {
    const int Hh = (H + 1) / 2;
    for (int k = threadIdx.x; k < (TILE / 2) * TILE; k += THREADS) {
      const int wi = R + 2 * (k / TILE);
      const int wj = R + k % TILE;
      const int gi = i0 + wi;  // even
      const int gj = j0 + wj;
      if (gi >= H || gj >= W) continue;
      const int idx = wi * WIN + wj;
      // row gi + 1 == H lies outside the image: a known cell, r = +0
      const float even = round_to<T>(residual_at(cur, sb, sinv, sdeg, idx));
      const float odd = round_to<T>(residual_at(cur, sb, sinv, sdeg, idx + WIN));
      r_out[(size_t)c * Hh * W + (size_t)(gi >> 1) * W + gj] = from_f32<T>(even + odd);
    }
  }
}

template <typename T, int START, int EMIT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = jacobi_kernel<T, START, EMIT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.W + TILE - 1) / TILE, (a.H + TILE - 1) / TILE, a.C);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int start, int emit, const Args& a, cudaStream_t s) {
  switch (start * 3 + emit) {
    case FROM_ZERO * 3 + EMIT_NONE: return launch<T, FROM_ZERO, EMIT_NONE>(a, s);
    case FROM_ZERO * 3 + EMIT_FULL: return launch<T, FROM_ZERO, EMIT_FULL>(a, s);
    case FROM_ZERO * 3 + EMIT_HALF: return launch<T, FROM_ZERO, EMIT_HALF>(a, s);
    case FROM_U * 3 + EMIT_NONE: return launch<T, FROM_U, EMIT_NONE>(a, s);
    case FROM_U * 3 + EMIT_FULL: return launch<T, FROM_U, EMIT_FULL>(a, s);
    case FROM_U_CORR * 3 + EMIT_NONE: return launch<T, FROM_U_CORR, EMIT_NONE>(a, s);
    case FROM_U_CORR * 3 + EMIT_FULL: return launch<T, FROM_U_CORR, EMIT_FULL>(a, s);
    default: return cudaErrorInvalidValue;  // the half residual exists only from zero
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every operand in the same type).
// start: 0 = from u = 0 (u and ec unused), 1 = from u (ec unused), 2 = from
// u with the coarse correction ec (C, Hc, Wc) added on unknowns first.
// emit: 0 = u only, 1 = also r (C, H, W), 2 = also the row-paired r
// (C, ceil(H/2), W), start 0 only.
// omegas: host array of `sweeps` f32 weights, applied in order.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_jacobi(int dtype, int start, int emit, const void* u, const void* b,
                          const void* invm, const void* ec, void* u_out, void* r_out, int C,
                          int H, int W, int Hc, int Wc, int sweeps, const void* omegas,
                          void* stream) {
  const int general = start == FROM_ZERO ? sweeps - 1 : sweeps;
  if (sweeps < 1 || sweeps > MAX_SWEEPS || general + (emit ? 1 : 0) > R || !grid_fits(C, H, W)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {u, b, invm, ec, u_out, r_out, C, H, W, Hc, Wc, sweeps, {}};
  const float* w = static_cast<const float*>(omegas);
  for (int k = 0; k < sweeps; ++k) a.w[k] = w[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(start, emit, a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(start, emit, a, s);
  return (int)cudaErrorInvalidValue;
}
