// Shared pieces of the windowed smoother kernels (jacobi.cu, jacobi_v2.cu):
// storage conversions, the halo ring, the launch grid's limits and the
// choice of bands per block.
//
// A block owns one tile and stages it with a ring of R cells around it.
// Values in the window's outer ring are wrong (their neighbours lie outside
// the window), and the error moves inwards one cell per sweep, so the
// interior (ring >= R) stays exact as long as the general sweeps (+1 when a
// residual is emitted) are at most R. Each kernel has its own window
// geometry.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace stencil {

constexpr int R = 8;                   // halo ring
constexpr int MAX_SWEEPS = 8;

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

// the launch grid (tiles across, tiles down, bands) fits CUDA's limits
inline bool grid_fits(int C, int H, int W, int tile) {
  return C >= 1 && H >= 1 && W >= 1 && C <= 65535 && (H + tile - 1) / tile <= 65535;
}

// bands per block: as many (up to max_per) as still leave 16 blocks for each
// SM, so the card stays full on small grids
inline cudaError_t bands_per_block(int C, int tiles, int max_per, int* per) {
  static int sms = 0;  // the same for every card of a host
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  for (*per = max_per; *per > 1; --*per) {
    if ((long long)tiles * ((C + *per - 1) / *per) >= 16LL * sms) break;
  }
  return cudaSuccess;
}

}  // namespace stencil
