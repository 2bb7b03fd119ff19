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
// interleave's + 1. At 13x2048x2048 f32 "both" must read the even rows
// (109 MB; every 32-byte sector of them holds an even column) and write
// 54.5 MB, 0.049 ms at 3.35 TB/s; "rows" 218 MB (0.065 ms), "cols" and
// "interleave" 327 MB (0.098 ms). The earlier design moved one 4-byte word
// per thread and trailed torch's strided copy in the subsamples.
//
// Design: a thread moves 16 bytes of input per row ("interleave": 8 bytes in,
// 16 out), and thread v of a row takes the v-th such unit, so each warp
// instruction reads and writes one contiguous span:
//   rows        one float4 of an even row, copied;
//   cols, both  one float4 in, its two even elements out as one float2;
//   interleave  one float2 in, its (v, v + 1) pairs out as one float4.
// A block covers ROWS_PER_BLOCK output rows, issues all of their loads
// before any store, and the blocks stride over the rows. It needs 16-byte
// aligned x and y and cols a multiple of 4; the launcher takes it when the
// pointers and the width allow, and the scalar kernels (one thread per
// output element) otherwise, so every width, an odd number of rows, one row
// and an unaligned x give the same result. Row and plane offsets are
// 64-bit. On an H100 80GB HBM3 at 700 W it takes 0.059 / 0.078 / 0.111 /
// 0.118 ms for both / rows / cols / interleave (83-88 % of the byte bound),
// torch's own call 0.061 / 0.091 / 0.118 / 0.425 ms (chip_smoke.py); two
// 16-byte loads for one 16-byte store per thread, more rows a block, fewer
// threads a block and streaming cache hints all measured the same or slower.
//
// Bit-equal to the plain torch slicing and torch.stack(...).reshape
// (ops/stencil_kernels.py::stride2_plain): the subsamples copy, and x + 1 is
// one f32 add.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 4;

enum Mode { ROWS = 0, COLS = 1, BOTH = 2, INTERLEAVE = 3 };

// x: (planes, rows, cols) with cols % 4 == 0; out_rows output rows per
// plane, n_out of them in all. Thread v of a row takes the v-th 16 bytes of
// the input ("interleave": 8 bytes) and writes what they give, so each warp
// instruction reads and writes one contiguous span.
template <int MODE>
__global__ void __launch_bounds__(THREADS) stride2_vec_kernel(const float* __restrict__ x,
                                                             float* __restrict__ y, int rows,
                                                             int cols, int out_rows,
                                                             long long n_out) {
  const int v = blockIdx.x * THREADS + threadIdx.x;
  const int units = cols / 4;
  if (v >= units) return;
  const int out_cols = MODE == COLS || MODE == BOTH ? cols / 2 : cols;
  for (long long g0 = (long long)blockIdx.y * ROWS_PER_BLOCK; g0 < n_out;
       g0 += (long long)gridDim.y * ROWS_PER_BLOCK) {
    float4 in[ROWS_PER_BLOCK];
#pragma unroll
    for (int k = 0; k < ROWS_PER_BLOCK; ++k) {
      const long long g = g0 + k;
      if (g >= n_out) break;
      long long row = g;  // input row of output row g
      if (MODE == ROWS || MODE == BOTH) {
        // even rows: row 2g when every plane has an even number of rows
        row = rows % 2 ? g / out_rows * rows + 2 * (g % out_rows) : 2 * g;
      }
      if (MODE == INTERLEAVE) {
        const float2 h = reinterpret_cast<const float2*>(x + row * cols)[v];
        in[k] = make_float4(h.x, h.y, 0.f, 0.f);
      } else {
        in[k] = reinterpret_cast<const float4*>(x + row * cols)[v];
      }
    }
#pragma unroll
    for (int k = 0; k < ROWS_PER_BLOCK; ++k) {
      const long long g = g0 + k;
      if (g >= n_out) break;
      float* dst = y + g * out_cols;
      const float4 a = in[k];
      if (MODE == ROWS) {
        reinterpret_cast<float4*>(dst)[v] = a;
      } else if (MODE == COLS || MODE == BOTH) {
        reinterpret_cast<float2*>(dst)[v] = make_float2(a.x, a.z);
      } else {
        reinterpret_cast<float4*>(dst)[v] = make_float4(a.x, a.x + 1.f, a.y, a.y + 1.f);
      }
    }
  }
}

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
                                                            float* __restrict__ y, int rows,
                                                            int half) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= half) return;
  const long long row = (long long)blockIdx.z * rows + blockIdx.y;
  const float v = x[row * 2 * half + j];
  y[row * 2 * half + 2 * j] = v;
  y[row * 2 * half + 2 * j + 1] = v + 1.f;
}

template <int MODE>
cudaError_t launch_vec(const float* x, float* y, long long planes, int rows, int cols,
                       int out_rows, cudaStream_t s) {
  const int units = cols / 4;
  const long long n_out = planes * out_rows;
  const long long blocks_y = (n_out + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const dim3 grid((units + THREADS - 1) / THREADS, (unsigned)(blocks_y < 65535 ? blocks_y : 65535));
  stride2_vec_kernel<MODE><<<grid, THREADS, 0, s>>>(x, y, rows, cols, out_rows, n_out);
  return cudaGetLastError();
}

}  // namespace

// x: (planes, rows, cols) f32, contiguous; y: the mode's output shape
// (rows and cols halved up for the subsamples, (planes, rows, cols) for the
// interleave, which needs even cols). Returns the cudaError_t of the launch.
extern "C" int sat_stride2(int mode, const void* x, void* y, long long planes, int rows, int cols,
                           void* stream) {
  if (planes < 1 || planes > 65535 || rows < 1 || rows > 65535 || cols < 1 || mode < ROWS ||
      mode > INTERLEAVE || (mode == INTERLEAVE && cols % 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const int si = mode == COLS || mode == INTERLEAVE ? 1 : 2;
  const int out_rows = (rows + si - 1) / si;
  if (aligned && cols % 4 == 0) {
    switch (mode) {
      case ROWS: return (int)launch_vec<ROWS>(xf, yf, planes, rows, cols, out_rows, s);
      case COLS: return (int)launch_vec<COLS>(xf, yf, planes, rows, cols, out_rows, s);
      case BOTH: return (int)launch_vec<BOTH>(xf, yf, planes, rows, cols, out_rows, s);
      default: return (int)launch_vec<INTERLEAVE>(xf, yf, planes, rows, cols, out_rows, s);
    }
  }
  if (mode == INTERLEAVE) {
    const dim3 grid((cols / 2 + THREADS - 1) / THREADS, rows, (unsigned)planes);
    interleave_kernel<<<grid, THREADS, 0, s>>>(xf, yf, rows, cols / 2);
    return (int)cudaGetLastError();
  }
  const int sj = mode == ROWS ? 1 : 2;
  const int out_cols = (cols + sj - 1) / sj;
  const dim3 grid((out_cols + THREADS - 1) / THREADS, out_rows, (unsigned)planes);
  subsample_kernel<<<grid, THREADS, 0, s>>>(xf, yf, rows, cols, out_rows, out_cols, si, sj);
  return (int)cudaGetLastError();
}
