// Fused Chebyshev-weighted Jacobi smoother of the masked 5-point operator
//
//     A u = deg * u - sum of the unknown 4-neighbours of u
//
// for the multigrid V-cycle (models/multigrid.py::_v_cycle).
//
// Replaces, in satellite_approximation_tpu/ops/pallas_kernels.py:
//   * fused_jacobi_zero_tpu / fused_jacobi_zero_tpu_padded (_zero_call, body
//     _kernel_factory(zero_start=True)): the pre-smooth from u = 0, emitting
//     (u, r = (b - A u) * m)                      -> jacobi_kernel<T, true, *>
//   * fused_jacobi_corr_tpu_padded (_kernel_factory(fuse_corr=True)): the
//     post-smooth, u += prolong(e_c) on unknowns and then K sweeps, emitting
//     r on request                                -> jacobi_kernel<T, false, *>
//
// What bounds it on an H100: as torch ops the smoother is bound by device
// memory, about 6 rasters moved per sweep (K = 7 sweeps, ~40 rasters a call).
// Here the sweeps run out of shared memory and device memory sees one read of
// b and invm (plus u and the quarter-size e_c for the post-smooth) and one
// write of u and r: 4-5 rasters a call. That leaves the kernel bound by its
// shared-memory sweeps (~12 word accesses per window cell per sweep) and the
// halo recompute: on an H100 80GB HBM3 at 700 W the zero-start call at
// 13x2048x2048 f32 took 1.45 ms for ~1.2 GB of device traffic, about a
// quarter of the memory's peak rate.
//
// Design: one block per (band, 48x48 tile). The tile and a ring of R = 8
// cells around it (a 64x64 window) are loaded into shared memory; cells
// outside the image load as b = 0, invm = 0, i.e. known. All sweeps run in
// shared memory with two u buffers (a Jacobi sweep reads only the previous
// sweep's values). Values in the window's outer ring are wrong (their
// neighbours lie outside the window), and the error moves inwards one cell
// per sweep, so sweep t is computed only where the ring index is >= t and the
// interior (ring >= R) stays exact as long as sweeps (+1 when the residual is
// emitted) <= R. The zero-start first sweep is purely local (A 0 = 0), so it
// does not count. Only the interior is written back.
//
// Arithmetic is f32 in the operand order of the plain version
// (ops/stencil_kernels.py): neighbour sum ((up + down) + left) + right,
// au = deg*u - nsum, u + (omega*(b - au))*invm, masking by selects. Built with
// -fmad=false and without fast math, so it is bit-equal to the plain version.
// Storage is f32 or bf16 (rounded to nearest even on store).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int R = 8;                   // halo ring
constexpr int TILE = 48;               // interior tile edge
constexpr int WIN = TILE + 2 * R;      // window edge (64)
constexpr int CELLS = WIN * WIN;       // window cells
constexpr int THREADS = 256;
constexpr int MAX_SWEEPS = 8;
constexpr size_t SMEM_BYTES = 5 * CELLS * sizeof(float);  // u0, u1, b, invm, deg

struct Omegas {
  float w[MAX_SWEEPS];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int ring_of(int wi, int wj) {
  return min(min(wi, wj), min(WIN - 1 - wi, WIN - 1 - wj));
}

// ZERO: start from u = 0 (no u operand, no correction); else start from
// u_in + (unknown ? e_c[i/2, j/2] : 0). EMIT: also write r = (b - A u) * m.
template <typename T, bool ZERO, bool EMIT>
__global__ void __launch_bounds__(THREADS) jacobi_kernel(
    const T* __restrict__ u_in, const T* __restrict__ b, const T* __restrict__ invm,
    const T* __restrict__ ec, T* __restrict__ u_out, T* __restrict__ r_out, int H, int W,
    int Hc, int Wc, int sweeps, Omegas om) {
  extern __shared__ float smem[];
  float* su0 = smem;
  float* su1 = su0 + CELLS;
  float* sb = su1 + CELLS;
  float* sinv = sb + CELLS;
  float* sdeg = sinv + CELLS;

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
      if (!ZERO) uv = to_f32(u_in[band + p]);
    }
    const bool unk = iv > 0.f;
    if (ZERO) {
      uv = unk ? (om.w[0] * bv) * iv : 0.f;
    } else {
      const float e =
          unk ? to_f32(ec[(size_t)c * Hc * Wc + (size_t)(gi >> 1) * Wc + (gj >> 1)]) : 0.f;
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
  for (int s = ZERO ? 1 : 0; s < sweeps; ++s) {
    ++t;
    const float w = om.w[s];
    for (int idx = threadIdx.x; idx < CELLS; idx += THREADS) {
      const float uc = cur[idx];
      float un = uc;
      if (sinv[idx] > 0.f && ring_of(idx / WIN, idx % WIN) >= t) {
        const float nu = sinv[idx - WIN] > 0.f ? cur[idx - WIN] : 0.f;
        const float nd = sinv[idx + WIN] > 0.f ? cur[idx + WIN] : 0.f;
        const float nl = sinv[idx - 1] > 0.f ? cur[idx - 1] : 0.f;
        const float nr = sinv[idx + 1] > 0.f ? cur[idx + 1] : 0.f;
        const float nsum = ((nu + nd) + nl) + nr;
        const float au = sdeg[idx] * uc - nsum;
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
    const float uc = cur[idx];
    u_out[o] = from_f32<T>(uc);
    if (EMIT) {
      float r = 0.f;
      if (sinv[idx] > 0.f) {
        const float nu = sinv[idx - WIN] > 0.f ? cur[idx - WIN] : 0.f;
        const float nd = sinv[idx + WIN] > 0.f ? cur[idx + WIN] : 0.f;
        const float nl = sinv[idx - 1] > 0.f ? cur[idx - 1] : 0.f;
        const float nr = sinv[idx + 1] > 0.f ? cur[idx + 1] : 0.f;
        const float nsum = ((nu + nd) + nl) + nr;
        const float au = sdeg[idx] * uc - nsum;
        r = sb[idx] - au;
      }
      r_out[o] = from_f32<T>(r);
    }
  }
}

template <typename T, bool ZERO, bool EMIT>
cudaError_t launch(const void* u, const void* b, const void* invm, const void* ec, void* u_out,
                   void* r_out, int C, int H, int W, int Hc, int Wc, int sweeps,
                   const Omegas& om, cudaStream_t stream) {
  auto kernel = jacobi_kernel<T, ZERO, EMIT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, C);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(b), static_cast<const T*>(invm),
      static_cast<const T*>(ec), static_cast<T*>(u_out), static_cast<T*>(r_out), H, W, Hc, Wc,
      sweeps, om);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int zero, int emit, const void* u, const void* b, const void* invm,
                     const void* ec, void* u_out, void* r_out, int C, int H, int W, int Hc,
                     int Wc, int sweeps, const Omegas& om, cudaStream_t s) {
  if (zero) {
    return emit ? launch<T, true, true>(u, b, invm, ec, u_out, r_out, C, H, W, Hc, Wc, sweeps, om, s)
                : launch<T, true, false>(u, b, invm, ec, u_out, r_out, C, H, W, Hc, Wc, sweeps, om, s);
  }
  return emit ? launch<T, false, true>(u, b, invm, ec, u_out, r_out, C, H, W, Hc, Wc, sweeps, om, s)
              : launch<T, false, false>(u, b, invm, ec, u_out, r_out, C, H, W, Hc, Wc, sweeps, om, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every operand in the same type).
// zero: 1 = pre-smooth from u = 0 (u and ec unused), 0 = post-smooth with the
// coarse correction ec (C, Hc, Wc) added on unknowns first.
// omegas: host array of `sweeps` f32 weights, applied in order.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_jacobi(int dtype, int zero, int emit, const void* u, const void* b,
                          const void* invm, const void* ec, void* u_out, void* r_out, int C,
                          int H, int W, int Hc, int Wc, int sweeps, const void* omegas,
                          void* stream) {
  const int general = zero ? sweeps - 1 : sweeps;
  if (sweeps < 1 || sweeps > MAX_SWEEPS || general + (emit ? 1 : 0) > R || C < 1 || H < 1 ||
      W < 1 || C > 65535 || (H + TILE - 1) / TILE > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Omegas om = {};
  const float* w = static_cast<const float*>(omegas);
  for (int k = 0; k < sweeps; ++k) om.w[k] = w[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(zero, emit, u, b, invm, ec, u_out, r_out, C, H, W, Hc, Wc, sweeps, om, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(zero, emit, u, b, invm, ec, u_out, r_out, C, H, W, Hc, Wc,
                                        sweeps, om, s);
  return (int)cudaErrorInvalidValue;
}
