// Stride-2 subsample and interleave of the last two axes, f32: the index
// idioms of the multigrid transfers (the strided half of _restrict, the
// interleave of _prolong).
//
// Replaces benchmarks/x_stride_probe.py::probe, the Pallas lowering probe of
// five idioms on a (128, 512) f32 array:
//   A  y = x[..., 0::2, :]                      mode 0 "rows"
//   B  y = x[..., :, 0::2]  (and C, its reshape-pair spelling)   mode 1 "cols"
//   D  y = x[..., 0::2, 0::2]                   mode 2 "both"
//   E  y[..., 0::2] = x[..., :C/2], y[..., 1::2] = x[..., :C/2] + 1
//                                               mode 3 "interleave"
//
// What bounds it on an H100: device-memory bytes; no arithmetic beyond the
// interleave's + 1. Design: a grid of (column block, output row, plane), one
// thread per output element of the subsamples, so no thread divides an
// index; neighbouring threads read addresses one or two words apart, so a
// warp touches whole 32-byte sectors and a strided read costs what reading
// those rows of x costs. The interleave takes one input element per thread
// and writes its (x, x + 1) pair as one 8-byte store. Plane offsets are
// 64-bit, so no raster that fits the card overflows them.
//
// Bit-equal to the plain torch slicing and torch.stack(...).reshape
// (ops/stencil_kernels.py::stride2_plain): the subsamples copy, and x + 1 is
// one f32 add.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) subsample_kernel(const float* __restrict__ x,
                                                           float* __restrict__ y, int rows,
                                                           int cols, int out_rows, int out_cols,
                                                           int si, int sj) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= out_cols) return;
  const long long p = blockIdx.z;
  const int i = blockIdx.y;
  y[(p * out_rows + i) * out_cols + j] =
      x[(p * rows + (long long)i * si) * cols + (long long)j * sj];
}

__global__ void __launch_bounds__(THREADS) interleave_kernel(const float* __restrict__ x,
                                                            float2* __restrict__ y, int rows,
                                                            int half) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= half) return;
  const long long row = (long long)blockIdx.z * rows + blockIdx.y;
  const float v = x[row * 2 * half + j];
  y[row * half + j] = make_float2(v, v + 1.f);  // y[row, 2j], y[row, 2j + 1]
}

}  // namespace

// x: (planes, rows, cols) f32, contiguous; y: the mode's output shape
// (rows and cols halved up for the subsamples, (planes, rows, cols) for the
// interleave, which needs even cols). Returns the cudaError_t of the launch.
extern "C" int sat_stride2(int mode, const void* x, void* y, long long planes, int rows, int cols,
                           void* stream) {
  if (planes < 1 || planes > 65535 || rows < 1 || rows > 65535 || cols < 1 || mode < 0 ||
      mode > 3) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  if (mode == 3) {
    if (cols % 2) return (int)cudaErrorInvalidValue;
    const dim3 grid((cols / 2 + THREADS - 1) / THREADS, rows, (unsigned)planes);
    interleave_kernel<<<grid, THREADS, 0, s>>>(xf, static_cast<float2*>(y), rows, cols / 2);
    return (int)cudaGetLastError();
  }
  const int si = mode == 1 ? 1 : 2;
  const int sj = mode == 0 ? 1 : 2;
  const int out_rows = (rows + si - 1) / si;
  const int out_cols = (cols + sj - 1) / sj;
  const dim3 grid((out_cols + THREADS - 1) / THREADS, out_rows, (unsigned)planes);
  subsample_kernel<<<grid, THREADS, 0, s>>>(xf, static_cast<float*>(y), rows, cols, out_rows,
                                            out_cols, si, sj);
  return (int)cudaGetLastError();
}
