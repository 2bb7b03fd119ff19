// Shared pieces of the windowed smoother kernels (jacobi.cu, jacobi_v2.cu):
// storage conversions, the halo ring and the shared-memory window geometry.
//
// A block owns one (band, tile) and stages it with a ring of R cells around
// it. Values in the window's outer ring are wrong (their neighbours lie
// outside the window), and the error moves inwards one cell per sweep, so
// the interior (ring >= R) stays exact as long as the general sweeps (+1
// when a residual is emitted) are at most R.
//
// jacobi.cu uses R, MAX_SWEEPS, the conversions and grid_fits, and has its
// own geometry (a 64x64 window held as register strips). TILE, WIN, CELLS,
// THREADS and ring_of below are the geometry of jacobi_v2.cu alone: one
// block of 256 threads per 48x48 tile, the whole 64x64 window in shared
// memory, sweep t computed only where ring_of() >= t.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace stencil {

constexpr int R = 8;                   // halo ring
constexpr int MAX_SWEEPS = 8;

// jacobi_v2.cu's window
constexpr int TILE = 48;               // interior tile edge
constexpr int WIN = TILE + 2 * R;      // window edge (64)
constexpr int CELLS = WIN * WIN;       // window cells
constexpr int THREADS = 256;

// a row pair (2i, 2i + 1) of the image never straddles two tiles
static_assert(TILE % 2 == 0, "TILE must be even");

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

// x rounded to the storage type T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ int ring_of(int wi, int wj) {
  return min(min(wi, wj), min(WIN - 1 - wi, WIN - 1 - wj));
}

// the launch grid (tiles across, tiles down, bands) fits CUDA's limits
inline bool grid_fits(int C, int H, int W, int tile = TILE) {
  return C >= 1 && H >= 1 && W >= 1 && C <= 65535 && (H + tile - 1) / tile <= 65535;
}

}  // namespace stencil
