// Residual cascade of the double-float refinement loop, laplace mode
// (models/fill.py::_fused_refine_solve):
//
//     r = (b - A (x_hi + x_lo)) * m,   b = sum of the known 4-neighbours
//
// computed as an error-free TwoSum cascade over the hi terms plus the lo
// terms in plain f32.
//
// Replaces, in satellite_approximation_tpu/ops/pallas_kernels.py:
//   * residual_entry_tpu_padded (_residual_factory(with_xlo=False,
//     emit_b=True)): the entry state x_hi = img * m, x_lo = 0, which also
//     emits b                                       -> residual_kernel<TI, false>
//   * residual_pair_tpu_padded (_residual_factory(with_xlo=True)): every
//     refinement pass                               -> residual_kernel<TI, true>
//
// What bounds it on an H100: device-memory bytes. As torch ops the cascade
// materialises every shifted tap and every TwoSum temporary as its own
// raster (~60 raster passes); here each output cell reads its 5-point
// neighbourhood of img, x_hi, x_lo and invm once and writes r (and b), and a
// known cell reads only invm and writes zeros.
// Design: one thread per output cell, one block per (band, 8x32 tile); the
// neighbour reads of adjacent threads hit the same cache lines, so L1/L2
// serve the reuse and no shared-memory staging is needed for a one-cell halo.
//
// Bit-parity contract with the plain version (ops/stencil_kernels.py): the
// TwoSum chain folds the terms in the order (up, down, left, right,
// -4*x_hi, k*x_hi), then the lo sum ((((lu + ld) + ll) + lr) - 4*x_lo) +
// k*x_lo, with k = 4 - deg on unknowns. TwoSum is error-free only if no add
// is reassociated or contracted: built with -fmad=false and without fast
// math. img, x_hi and x_lo are f32; invm is f32 or bf16 (the degree is
// rounded back to an integer either way).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// PAIR = false: entry residual from img alone, also writes b_out.
// PAIR = true: residual of the pair (x_hi, x_lo), with y = known + x_hi.
template <typename TI, bool PAIR>
__global__ void __launch_bounds__(BX * BY) residual_kernel(
    const float* __restrict__ img, const float* __restrict__ xhi, const float* __restrict__ xlo,
    const TI* __restrict__ invm, float* __restrict__ r_out, float* __restrict__ b_out, int H,
    int W) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= H || j >= W) return;
  const size_t band = (size_t)blockIdx.z * H * W;
  const size_t p = (size_t)i * W + j;
  const float iv = to_f32(invm[p]);
  if (!(iv > 0.f)) {
    r_out[band + p] = 0.f;
    if (!PAIR) b_out[band + p] = 0.f;
    return;
  }
  const float kf = 4.f - rintf(1.f / iv);

  // y at a neighbour q (zero outside the image): PAIR selects x_hi on
  // unknowns and img on knowns; the entry state has y = img.
  auto in_image = [&](int a, int c) { return a >= 0 && a < H && c >= 0 && c < W; };
  auto unknown_at = [&](size_t q) { return to_f32(invm[q]) > 0.f; };
  auto y_at = [&](int a, int c) -> float {
    if (!in_image(a, c)) return 0.f;
    const size_t q = (size_t)a * W + c;
    if (PAIR) return unknown_at(q) ? xhi[band + q] : img[band + q];
    return img[band + q];
  };

  const float t1 = y_at(i - 1, j);
  const float t2 = y_at(i + 1, j);
  const float t3 = y_at(i, j - 1);
  const float t4 = y_at(i, j + 1);
  const float xh = PAIR ? xhi[band + p] : img[band + p];

  float s, c, e;
  two_sum(t1, t2, s, c);
  two_sum(s, t3, s, e);
  c = c + e;
  two_sum(s, t4, s, e);
  c = c + e;
  two_sum(s, -4.f * xh, s, e);
  c = c + e;
  two_sum(s, kf * xh, s, e);
  c = c + e;

  if (PAIR) {
    auto lo_at = [&](int a, int cc) -> float {
      return in_image(a, cc) ? xlo[band + (size_t)a * W + cc] : 0.f;
    };
    const float xl = xlo[band + p];
    const float lo = ((((lo_at(i - 1, j) + lo_at(i + 1, j)) + lo_at(i, j - 1)) + lo_at(i, j + 1)) -
                      4.f * xl) +
                     kf * xl;
    r_out[band + p] = s + (c + lo);
  } else {
    r_out[band + p] = s + c;
    // b = sum of the known neighbours' values (unknown or outside: 0)
    auto known_at = [&](int a, int cc) -> float {
      if (!in_image(a, cc)) return 0.f;
      const size_t q = (size_t)a * W + cc;
      return unknown_at(q) ? 0.f : img[band + q];
    };
    b_out[band + p] = ((known_at(i - 1, j) + known_at(i + 1, j)) + known_at(i, j - 1)) +
                      known_at(i, j + 1);
  }
}

template <typename TI>
cudaError_t launch(int pair, const void* img, const void* xhi, const void* xlo, const void* invm,
                   void* r_out, void* b_out, int C, int H, int W, cudaStream_t stream) {
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, C);
  const dim3 block(BX, BY);
  const float* im = static_cast<const float*>(img);
  const float* xh = static_cast<const float*>(xhi);
  const float* xl = static_cast<const float*>(xlo);
  const TI* iv = static_cast<const TI*>(invm);
  float* r = static_cast<float*>(r_out);
  float* bo = static_cast<float*>(b_out);
  if (pair)
    residual_kernel<TI, true><<<grid, block, 0, stream>>>(im, xh, xl, iv, r, bo, H, W);
  else
    residual_kernel<TI, false><<<grid, block, 0, stream>>>(im, xh, xl, iv, r, bo, H, W);
  return cudaGetLastError();
}

}  // namespace

// invm_dtype: 0 = float32, 1 = bfloat16. pair: 1 = residual of (x_hi, x_lo)
// (b_out unused), 0 = entry residual plus b (x_hi, x_lo unused).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_residual(int invm_dtype, int pair, const void* img, const void* xhi,
                            const void* xlo, const void* invm, void* r_out, void* b_out, int C,
                            int H, int W, void* stream) {
  if (C < 1 || H < 1 || W < 1 || C > 65535 || (H + BY - 1) / BY > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (invm_dtype == 0)
    return (int)launch<float>(pair, img, xhi, xlo, invm, r_out, b_out, C, H, W, s);
  if (invm_dtype == 1)
    return (int)launch<__nv_bfloat16>(pair, img, xhi, xlo, invm, r_out, b_out, C, H, W, s);
  return (int)cudaErrorInvalidValue;
}
