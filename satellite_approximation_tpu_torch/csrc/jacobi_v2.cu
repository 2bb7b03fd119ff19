// Damped Jacobi smoother with separate mask and degree operands and masking
// by multiplies: the earlier form of the fused smoother (jacobi.cu, FROM_U).
//
// Replaces benchmarks/x_kernel_v2.py::fused_jacobi_v2 (body
// _kernel_factory_v2): K sweeps with one scalar omega from a given u,
//
//     inv = where(deg > 0, 1/deg, 0) * m
//     u   = u + (omega * (b - (deg*u - nsum(u*m)))) * inv    on every cell
//     r   = (b - A u) * m                                    on request
//
// where nsum is ((up + down) + left) + right. Unlike jacobi.cu the mask is
// applied by multiplies, so a non-finite u on a known cell reaches its
// neighbours (NaN * 0 = NaN) and zeros can differ in sign from jacobi.cu's
// selects; on finite inputs with the same operands the values agree.
//
// What bounds it on an H100: the same as jacobi.cu (shared-memory sweeps and
// the halo recompute), with one more (H, W) operand read per block (mask and
// degree instead of the merged invm) and a sixth shared-memory plane.
//
// Design: jacobi.cu's window (stencil.cuh): one block per (band, 48x48 tile)
// with an 8-cell ring; cells outside the image load u = 0, b = 0, m = 0 and
// deg = 1, as fused_jacobi_v2 pads them. Sweeps + residual <= 8.
//
// Arithmetic is f32 in the plain version's operand order
// (ops/stencil_kernels.py::jacobi_v2_plain), built with -fmad=false and
// without fast math: bit-equal to it. Storage is f32 or bf16 for every
// operand, rounded once at the store.

#include "stencil.cuh"

namespace {

using namespace stencil;

constexpr size_t SMEM_BYTES = 6 * CELLS * sizeof(float);  // u0, u1, b, m, deg, inv

__device__ __forceinline__ float masked_neighbour_sum(const float* u, const float* sm, int idx) {
  const float nu = u[idx - WIN] * sm[idx - WIN];
  const float nd = u[idx + WIN] * sm[idx + WIN];
  const float nl = u[idx - 1] * sm[idx - 1];
  const float nr = u[idx + 1] * sm[idx + 1];
  return ((nu + nd) + nl) + nr;
}

template <typename T, bool EMIT>
__global__ void __launch_bounds__(THREADS) jacobi_v2_kernel(
    const T* __restrict__ u_in, const T* __restrict__ b, const T* __restrict__ mask,
    const T* __restrict__ deg, T* __restrict__ u_out, T* __restrict__ r_out, int H, int W,
    int sweeps, float omega) {
  extern __shared__ float smem[];
  float* su0 = smem;
  float* su1 = su0 + CELLS;
  float* sb = su1 + CELLS;
  float* sm = sb + CELLS;
  float* sdeg = sm + CELLS;
  float* sinv = sdeg + CELLS;

  const int c = blockIdx.z;
  const int i0 = blockIdx.y * TILE - R;
  const int j0 = blockIdx.x * TILE - R;
  const size_t band = (size_t)c * H * W;

  for (int idx = threadIdx.x; idx < CELLS; idx += THREADS) {
    const int gi = i0 + idx / WIN;
    const int gj = j0 + idx % WIN;
    float uv = 0.f, bv = 0.f, mv = 0.f, dv = 1.f;
    if (gi >= 0 && gi < H && gj >= 0 && gj < W) {
      const size_t p = (size_t)gi * W + gj;
      uv = to_f32(u_in[band + p]);
      bv = to_f32(b[band + p]);
      mv = to_f32(mask[p]);
      dv = to_f32(deg[p]);
    }
    su0[idx] = uv;
    sb[idx] = bv;
    sm[idx] = mv;
    sdeg[idx] = dv;
    sinv[idx] = (dv > 0.f ? 1.f / dv : 0.f) * mv;
  }
  __syncthreads();

  float* cur = su0;
  float* nxt = su1;
  for (int t = 1; t <= sweeps; ++t) {
    for (int idx = threadIdx.x; idx < CELLS; idx += THREADS) {
      const float uc = cur[idx];
      float un = uc;
      if (ring_of(idx / WIN, idx % WIN) >= t) {
        const float au = sdeg[idx] * uc - masked_neighbour_sum(cur, sm, idx);
        un = uc + (omega * (sb[idx] - au)) * sinv[idx];
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
      const float au = sdeg[idx] * uc - masked_neighbour_sum(cur, sm, idx);
      r_out[o] = from_f32<T>((sb[idx] - au) * sm[idx]);
    }
  }
}

template <typename T, bool EMIT>
cudaError_t launch(const void* u, const void* b, const void* mask, const void* deg, void* u_out,
                   void* r_out, int C, int H, int W, int sweeps, float omega,
                   cudaStream_t stream) {
  auto kernel = jacobi_v2_kernel<T, EMIT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, C);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(b), static_cast<const T*>(mask),
      static_cast<const T*>(deg), static_cast<T*>(u_out), static_cast<T*>(r_out), H, W, sweeps,
      omega);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int emit, const void* u, const void* b, const void* mask, const void* deg,
                     void* u_out, void* r_out, int C, int H, int W, int sweeps, float omega,
                     cudaStream_t s) {
  return emit ? launch<T, true>(u, b, mask, deg, u_out, r_out, C, H, W, sweeps, omega, s)
              : launch<T, false>(u, b, mask, deg, u_out, r_out, C, H, W, sweeps, omega, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every operand in the same type).
// u, b, u_out, r_out: (C, H, W); mask (0/1) and deg: (H, W).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_jacobi_v2(int dtype, int emit, const void* u, const void* b, const void* mask,
                             const void* deg, void* u_out, void* r_out, int C, int H, int W,
                             int sweeps, float omega, void* stream) {
  if (sweeps < 1 || sweeps + (emit ? 1 : 0) > R || !grid_fits(C, H, W)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(emit, u, b, mask, deg, u_out, r_out, C, H, W, sweeps, omega, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(emit, u, b, mask, deg, u_out, r_out, C, H, W, sweeps,
                                        omega, s);
  return (int)cudaErrorInvalidValue;
}
