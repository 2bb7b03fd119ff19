// Kernel 11: the similarity sweep of the cloud-shadow matching
// (models/detection/matching.py, _bucket_sweep on CUDA operands;
// ops/sweep_kernels.py, pair_counts).
//
// Contract, that of the torch form (matching._pair_counts, summed): for every
// (height, cloud) pair k of a bucket, over the pixels (x, y) of its box
// [min_x, min(max_x, min_x + wb - 1)] x [min_y, min(max_y, min_y + hb - 1)],
//   qx = (a00 * x + a01 * y) + d0,  qy = (a10 * x + a11 * y) + d1,
// each product and sum rounded once in f32 (no FMA contraction: the
// intrinsics below, and the library builds with -fmad=false), qi and qj
// truncated toward zero as torch's float -> int32 cast does on the card;
//   cand = !cloud[y, x] && 0 <= qi < width && 0 <= qj < height
//          && id_map[qj, qi] == id,   hit = cand && shadow[y, x];
// t = the count of cand, c = the count of hit, int32. The rasters are the
// flipped, padded ones of match_clouds_shadows: logical (y, x) sits at
// (y + pf) * stride + x + pf. The counts are bit-equal to the torch form's
// whatever order the atomics land in (integer sums).
//
// Replaces no TPU kernel: the JAX package's sweep is XLA gathers. The torch
// form materialises about 20 bytes of intermediates a window cell, walks the
// whole bucket window (15.57 G cells a 5490^2 tile call, of which 6.81 G lie
// in the true boxes) and runs in 262 host-driven passes; here a pair keeps
// its two counts in registers and walks its true box only, one launch a
// bucket.
//
// What bounds it on an H100: the cloud mask (1 B), the potential shadow
// (1 B) and the id map at the cast position (4 B): 6 B a true cell at most,
// 41 GB a tile call, 12 ms at 3.35 TB/s. Consecutive heights of one cloud
// read nearly the same windows, so most of it comes from L2.
//
// Design: a work item is one row strip of one pair's box; items run
// pair-major with the heights of a cloud adjacent (pair = cloud * nh +
// height), so a cloud's windows are reread while they sit in L2. A block of
// 256 threads takes an item at a time (grid stride over the items, one wave
// of resident blocks): its threads lie TX across the columns of a row (TX a
// power of two up to 256, the bucket width where it is narrower) and 256 / TX
// down the rows, so the mask reads of a warp are consecutive bytes. The id
// map is read only where the pixel is off the cloud mask and the cast lands
// on the raster, the shadow only for a candidate. Counts go up by a warp
// reduce and one atomicAdd a warp and count, skipped where the count is 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEM_CELLS = 8192;  // cells of a bucket-wide item: 32 a thread
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
    similarity_sweep_kernel(const uint8_t* __restrict__ cloud, const uint8_t* __restrict__ shadow,
                            const int* __restrict__ id_map, long long stride, int pf, int width,
                            int height, const int* __restrict__ ids,
                            const int* __restrict__ min_x, const int* __restrict__ min_y,
                            const int* __restrict__ max_x, const int* __restrict__ max_y,
                            const float* __restrict__ a2, const float* __restrict__ delta, int nh,
                            int nc, int wb, int hb, int tx, int rows, unsigned chunks,
                            unsigned items, int* __restrict__ counts) {
  const int lx = threadIdx.x % tx;
  const int ly = threadIdx.x / tx;
  const int ty = THREADS / tx;
  for (unsigned item = blockIdx.x; item < items; item += gridDim.x) {
    const unsigned pair = item / chunks;
    const int chunk = (int)(item - pair * chunks);
    const int h = (int)(pair % (unsigned)nh);
    const int c = (int)(pair / (unsigned)nh);
    const int k = h * nc + c;  // the operands are height-major
    const int x0 = __ldg(min_x + k), y0 = __ldg(min_y + k);
    const int x1 = min(__ldg(max_x + k), x0 + wb - 1);
    const int y1 = min(__ldg(max_y + k), y0 + hb - 1);
    const int ys = y0 + chunk * rows;
    const int ye = min(y1, ys + rows - 1);
    if (ys > ye) continue;  // the same for every thread of the block
    const float a00 = __ldg(a2 + 4 * k), a01 = __ldg(a2 + 4 * k + 1);
    const float a10 = __ldg(a2 + 4 * k + 2), a11 = __ldg(a2 + 4 * k + 3);
    const float d0 = __ldg(delta + 2 * k), d1 = __ldg(delta + 2 * k + 1);
    const int id = __ldg(ids + c);
    int t = 0, hit = 0;
    for (int y = ys + ly; y <= ye; y += ty) {
      const float fy = __int2float_rn(y);
      const float by0 = __fmul_rn(a01, fy), by1 = __fmul_rn(a11, fy);
      const long long row = (long long)(y + pf) * stride + pf;
      for (int x = x0 + lx; x <= x1; x += tx) {
        const long long win = row + x;
        if (__ldg(cloud + win)) continue;
        const float fx = __int2float_rn(x);
        const float qx = __fadd_rn(__fadd_rn(__fmul_rn(a00, fx), by0), d0);
        const float qy = __fadd_rn(__fadd_rn(__fmul_rn(a10, fx), by1), d1);
        const int qi = __float2int_rz(qx), qj = __float2int_rz(qy);
        if (qi < 0 || qi >= width || qj < 0 || qj >= height) continue;
        if (__ldg(id_map + ((long long)(qj + pf) * stride + qi + pf)) != id) continue;
        ++t;
        hit += __ldg(shadow + win) != 0;
      }
    }
    t = (int)__reduce_add_sync(FULL, (unsigned)t);
    hit = (int)__reduce_add_sync(FULL, (unsigned)hit);
    if ((threadIdx.x & 31) == 0) {
      if (t) atomicAdd(counts + 2 * k, t);
      if (hit) atomicAdd(counts + 2 * k + 1, hit);
    }
  }
}

}  // namespace

// cloud, shadow: uint8 (0 or 1) and id_map: int32, each (rows, stride)
// contiguous, logical (y, x) at (y + pf) * stride + x + pf, the pair boxes
// inside them; ids: (nc,) int32; min_x .. max_y: (nh, nc) int32; a2: (nh,
// nc, 2, 2) f32; delta: (nh, nc, 2) f32; counts: (nh, nc, 2) int32, zeroed
// before the launch, gets (t, c) of each pair. One launch on stream; returns
// its cudaError_t, or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int sat_similarity_sweep(const void* cloud, const void* shadow, const void* id_map,
                                    long long stride, int pf, int width, int height,
                                    const void* ids, const void* min_x, const void* min_y,
                                    const void* max_x, const void* max_y, const void* a2,
                                    const void* delta, int nh, int nc, int wb, int hb,
                                    void* counts, void* stream) {
  if (nh < 1 || nc < 1 || wb < 1 || hb < 1 || width < 1 || height < 1 || pf < 0 || stride < 1)
    return (int)cudaErrorInvalidValue;
  int tx = 1;
  while (tx < wb && tx < THREADS) tx *= 2;
  const int ty = THREADS / tx;
  // rows an item: a multiple of ty holding about ITEM_CELLS bucket-wide cells
  int rows = ty * (int)(((long long)ITEM_CELLS + (long long)wb * ty - 1) / ((long long)wb * ty));
  const int rows_hb = ((hb + ty - 1) / ty) * ty;
  if (rows > rows_hb) rows = rows_hb;
  const long long chunks = (hb + rows - 1) / rows;
  const long long items = chunks * nh * nc;
  if (items >= 0x80000000LL) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, similarity_sweep_kernel, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const long long wave = (long long)sms * per_sm;
  const long long grid = items < wave ? items : wave;
  similarity_sweep_kernel<<<(unsigned)grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cloud), static_cast<const uint8_t*>(shadow),
      static_cast<const int*>(id_map), stride, pf, width, height, static_cast<const int*>(ids),
      static_cast<const int*>(min_x), static_cast<const int*>(min_y),
      static_cast<const int*>(max_x), static_cast<const int*>(max_y),
      static_cast<const float*>(a2), static_cast<const float*>(delta), nh, nc, wb, hb, tx, rows,
      (unsigned)chunks, (unsigned)items, static_cast<int*>(counts));
  return (int)cudaGetLastError();
}
