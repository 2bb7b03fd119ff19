// Kernel 9: one directional pass of the pit fill's scan cycles
// (ops/pitfill.py, the counterpart of _pass_down in
// satellite_approximation_tpu/ops/pitfill.py). Row by row in scan order,
// every cell absorbs the minimum of its three neighbours in the row before,
// which the pass has just updated:
//
//     vert = min(prev[c], min(prev[c - 1], prev[c + 1]))
//     out[r][c] = max(orig[r][c], min(f[r][c], vert))
//
// with prev of the first row and every neighbour outside the image equal to
// border_value. "down" scans rows top to bottom, "up" bottom to top; the
// left and right passes are the same on the transposes (the wrapper keeps
// orig's transpose for a budget and transposes f around the two).
//
// Replaces no TPU kernel: in the JAX package the pass is a lax.scan that XLA
// compiles (pit_fill_host's _directional_budget). A plain torch form needs
// ~6 launches a row, ~260,000 a cycle at 10980^2.
//
// What bounds it on an H100: the chain of rows, not bytes. A pass reads orig
// and f and writes the result, 12 B a cell (1.447 GB at 10980^2, 0.432 ms at
// 3.35 TB/s), but row r cannot start before row r - 1 is done, so H steps
// follow one another, each at least a shared-memory exchange and a barrier.
// On an H100 80GB HBM3 at 700 W a pass takes 1.72-1.76 ms at 10980^2 (25 %
// of the byte bound), 0.81-0.84 ms at 5490^2, 0.59-0.60 ms at 4096^2 and
// 0.41-0.43 ms at 2745^2, in every direction; one strip (128 columns) of
// the same height takes 76-83 % of it, ~120 ns a row: the row chain
// (chip_smoke.py, 8a).
//
// Design: a wavefront over column strips, every strip resident at once.
//   * A block owns a strip of SW = THREADS - 2K columns and computes a
//     window of THREADS columns, its strip with K ghost columns on each
//     side, one column a thread. It walks its rows in batches of K: the
//     cell (r, c) of a batch depends on the row before the batch at columns
//     c - K .. c + K only, so with the row before the batch known over the
//     whole window, K rows of the strip follow without a look at another
//     block. A ghost cell's error moves inward one column a row, so after K
//     rows it has not reached the strip. The ghost cells are computed like
//     the others and never written.
//   * Between batches the strips hand off through global memory: a block
//     writes its rows, then publishes the number of rows it has done
//     (__threadfence and a release store). Before a batch it waits, with
//     acquire loads, until its left and right neighbours have done the row
//     before the batch, and reads their cells of that row (L2, not L1). One
//     handoff every K rows instead of every row.
//   * A thread loads orig and f of its column for the batch's K rows into
//     registers at the batch's start (2K loads in flight), so the row steps
//     wait on shared memory and one barrier only. The row before is double
//     buffered in shared memory, padded by a cell on each side so that no
//     thread tests its position: one __syncthreads a row.
//   * The row step is the chain every pass waits on, so its arithmetic is
//     kept short: fminf/fmaxf in the plain version's order, and beside them,
//     off the chain, the NaN that torch's min and max would return (see
//     step). The first design applied torch's NaN rule at each min, a
//     select after a compare inside the chain, and handed off every 32
//     rows: 3.42-3.55 ms a pass at 10980^2, one strip 281 ns a row
//     (chip_smoke.py, 8a, same card).
//   * A strip spins on its neighbours, so every strip must be resident: the
//     launch is cooperative, which fails rather than queue a block.
//     THREADS = 256 and K = 64 give 128 columns a strip, 86 strips at 10980
//     columns, one block an SM at most (the 2K registers of a thread's
//     batch): one launch a pass for rasters up to 132 x 128 = 16,896 columns
//     wide on an H100.
//   * A wider raster runs the same kernel one batch of K rows a launch,
//     without progress counters (progress null): the handoff between batches
//     is the launch boundary, any number of strips may queue, and a batch
//     reads the row before it over its whole window from the output of the
//     launch before. ceil(h / K) launches a pass instead of one.
//   * The output is a separate buffer: a neighbour reads the old f of its
//     ghost columns while this strip writes them.
//   * changed (int, device) is set with atomicOr where out != f in the
//     strip's own cells; skip (int, device, or null) is the previous cycle's
//     flag: when it is 0 that cycle changed nothing, so neither does this
//     one, and the pass copies f to the output.
//
// The result is bit-equal to ops/pitfill.py::_pass_down run by torch on the
// card, NaNs included.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int K = 64;  // rows between handoffs = ghost columns a side
constexpr int SW = THREADS - 2 * K;

// torch's max(o, min(f, min(p, min(pl, pr)))) on CUDA. torch's min and max
// return their first NaN operand (else fminf / fmaxf), so the whole returns
// the first NaN of o, f, p, pl, pr, and without one the fminf/fmaxf chain.
// The NaN is picked beside the chain, not inside it.
__device__ __forceinline__ float step(float o, float f, float p, float pl, float pr) {
  const float fast = fmaxf(o, fminf(f, fminf(p, fminf(pl, pr))));
  float n = pr;
  n = pl != pl ? pl : n;
  n = p != p ? p : n;
  n = f != f ? f : n;
  n = o != o ? o : n;
  return n != n ? n : fast;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

struct Args {
  const float* orig;
  const float* f;
  float* out;
  const float* border;
  int* changed;
  const int* skip;
  int* progress;  // one counter a strip, zero at the launch; null: one batch
  int h, w, reverse;
  int r_first, r_last;  // the rows of this launch, in scan order
};

__global__ void __launch_bounds__(THREADS) directional_pass_kernel(const __grid_constant__ Args a) {
  if (a.skip != nullptr && *a.skip == 0) {
    // the previous cycle changed nothing: the pass is the identity on this
    // launch's rows
    const int lo = a.reverse ? a.h - a.r_last : a.r_first;
    const long long end = (long long)(lo + a.r_last - a.r_first) * a.w;
    for (long long i = (long long)lo * a.w + (long long)blockIdx.x * THREADS + threadIdx.x;
         i < end; i += (long long)gridDim.x * THREADS) {
      a.out[i] = a.f[i];
    }
    return;
  }
  __shared__ float buf[2][THREADS + 2];  // column t at t + 1, a pad cell each side
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  const int c = s * SW - K + t;  // this thread's column
  const bool in_img = c >= 0 && c < a.w;
  const bool own = in_img && t >= K && t < K + SW;
  const float bv = *a.border;
  const long long step_rows = a.reverse ? -(long long)a.w : a.w;
  int cur = 0;
  buf[0][t + 1] = bv;  // the row before the first: border_value (else read below)
  if (t < 2) {         // the pads: read only by the window's edge cells, never valid
    buf[0][t * (THREADS + 1)] = bv;
    buf[1][t * (THREADS + 1)] = bv;
  }
  bool changed = false;

  for (int r0 = a.r_first; r0 < a.r_last; r0 += K) {
    const int rows = min(K, a.r_last - r0);
    const long long first = (a.reverse ? a.h - 1 - r0 : r0) * (long long)a.w + c;
    float o[K], fv[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i < rows && in_img) {
        o[i] = a.orig[first + i * step_rows];
        fv[i] = a.f[first + i * step_rows];
      }
    }
    if (r0 > 0) {
      // the ghost columns' row before the batch is the neighbours' output;
      // the first batch of a launch reads its own columns' too
      if (a.progress != nullptr && r0 > a.r_first) {
        if (t == 0 && s > 0) {
          while (load_acquire(a.progress + s - 1) < r0) {
          }
        }
        if (t == THREADS - 1 && s + 1 < gridDim.x) {
          while (load_acquire(a.progress + s + 1) < r0) {
          }
        }
        __syncthreads();
      }
      if (!own || r0 == a.r_first) {
        // the row before the batch: border_value outside the image
        buf[cur][t + 1] = in_img ? __ldcg(a.out + first - step_rows) : bv;
      }
    }
    __syncthreads();
    float* dst = a.out + first;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i < rows) {
        const float nf = in_img ? step(o[i], fv[i], buf[cur][t + 1], buf[cur][t], buf[cur][t + 2])
                                : bv;
        if (own) {
          *dst = nf;
          changed |= nf != fv[i];
        }
        dst += step_rows;
        cur ^= 1;
        buf[cur][t + 1] = nf;
        __syncthreads();
      }
    }
    // publish the rows done: every thread's stores, then the counter
    if (a.progress != nullptr && t == 0) {
      __threadfence();
      store_release(a.progress + s, r0 + rows);
    }
  }
  if (__syncthreads_or(changed) && t == 0) atomicOr(a.changed, 1);
}

}  // namespace

// The layout of a pass: the columns of a strip, the rows of a batch, and
// the strips the current card holds at once (a pass whose strips all fit
// runs in one launch). Returns the cudaError_t of the query.
extern "C" int sat_directional_geometry(int* strip_cols, int* batch_rows, int* resident) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, directional_pass_kernel, THREADS, 0);
  }
  *strip_cols = SW;
  *batch_rows = K;
  *resident = sms * per_sm;
  return (int)e;
}

// orig, f, out: (h, w) f32 contiguous, out distinct from f; border: one f32
// on the device; changed: one int on the device (atomicOr 1 where a cell
// changed); skip: one int on the device or null; reverse: 0 scans rows top
// to bottom, 1 bottom to top. The launch runs the rows r_first..r_last - 1
// of the scan, whose row before (if any) out already holds. progress: one
// int a strip, zero, for a cooperative launch over all the rows
// (r_first = 0, r_last = h; every strip resident), or null for a plain
// launch of one batch (r_last - r_first <= batch_rows). Returns the
// cudaError_t of the launch.
extern "C" int sat_directional_pass(const void* orig, const void* f, void* out, const void* border,
                                    void* changed, const void* skip, void* progress, int h, int w,
                                    int reverse, int r_first, int r_last, void* stream) {
  const bool wave = progress != nullptr;
  if (h < 1 || w < 1 || f == out || r_first < 0 || r_first >= r_last || r_last > h ||
      (wave ? r_first != 0 || r_last != h : r_last - r_first > K)) {
    return (int)cudaErrorInvalidValue;
  }
  const int strips = (w + SW - 1) / SW;
  Args a = {static_cast<const float*>(orig), static_cast<const float*>(f),
            static_cast<float*>(out), static_cast<const float*>(border),
            static_cast<int*>(changed), static_cast<const int*>(skip),
            static_cast<int*>(progress), h, w, reverse, r_first, r_last};
  if (!wave) {
    directional_pass_kernel<<<strips, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
  }
  // fails (cudaErrorCooperativeLaunchTooLarge) rather than queue a strip
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)directional_pass_kernel, dim3(strips),
                                          dim3(THREADS), params, 0,
                                          static_cast<cudaStream_t>(stream));
}
