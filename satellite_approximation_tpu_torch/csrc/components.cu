// Kernel 10: connected-component labelling of a bool mask (ops/components.py,
// label_components), and the two passes over its labels that partition_labels
// takes on the card (region_stats, region_ids).
//
// Contract, that of the plain version connected_components: an int32 label
// per pixel, the least flat index r * w + c of the pixel's component (8- or
// 4-connected), and h * w on the background. The result is bit-equal to the
// plain version whatever order the atomics land in: every link points from a
// larger index to a smaller one, so the one pixel of a component that links
// to itself is its least index.
//
// Replaces no TPU kernel: the JAX package labels with plain lax propagation
// (satellite_approximation_tpu/ops/components.py::connected_components),
// and its detect route partitions the cloud mask with the host flood
// (native/src/satnative.cpp::flood_partition). The port added the kernel so
// that detect's device route partitions the mask where it lies instead of
// fetching it and waiting for a host BFS (1.1 s a call at 5490^2).
//
// What bounds it on an H100: bytes. A call reads the mask once (1 B a pixel),
// writes a label (4 B), and the compression rereads and rewrites it (8 B):
// 13 B a pixel, 0.39 GB at 5490^2, 0.12 ms at 3.35 TB/s.
//
// Design: block-based union-find in three launches.
//   * local: a block labels a TILE x TILE tile in shared memory, a warp a
//     row. A row's runs of set pixels come from one ballot: each pixel
//     points at its run's first pixel. Then each pixel unites with the row
//     above (N where it is set, else NW and NE under 8-connectivity) by
//     atomicMin on shared parents, and writes the flat index of its tile
//     root. A tile's row-major order is the global order, so the tile root
//     is the tile component's least flat index. The first design united
//     every pixel with W, NW, N and NE: long chains of parents in the
//     shared tile and 3.90 ms of a 4.17 ms call at 5490^2.
//   * merge: a block takes one tile's top row and left column and unites
//     each with its neighbours across the tile border, by atomicMin on the
//     labels in global memory (read through L2: __ldcg). Only 2 / TILE of the
//     pixels take part.
//   * compress: every foreground pixel writes its root.
// The union retries until its link holds (Playne and Hawick, 2018), so a link
// that another thread overwrote is merged again: no union is lost.
//
// region_stats and region_ids read labels whose roots hold -1 - their rank
// (partition_labels writes the ranks). A warp takes 32 columns of one row;
// its lanes of one region (__match_any_sync) count once: the lowest lane
// gives the least column, the highest the largest, __popc the area. Six
// atomics a warp and region instead of six a pixel, so a large cloud does not
// queue millions of atomics on one address.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;  // the local tile: one thread a pixel, 1024 a block
constexpr int STATS_ROWS = 8;  // rows a block of region_stats / region_ids
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int find_shared(volatile int* s, int x) {
  int p = s[x];
  while (p != x) {
    x = p;
    p = s[x];
  }
  return x;
}

__device__ void unite_shared(volatile int* s, int a, int b) {
  while (true) {
    a = find_shared(s, a);
    b = find_shared(s, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin((int*)&s[b], a);
    if (old == b) return;
    b = old;  // b was linked meanwhile: unite its new parent
  }
}

__device__ __forceinline__ int find_global(const int* labels, int x) {
  int p = __ldcg(labels + x);
  while (p != x) {
    x = p;
    p = __ldcg(labels + x);
  }
  return x;
}

__device__ void unite_global(int* labels, int a, int b) {
  while (true) {
    a = find_global(labels, a);
    b = find_global(labels, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(labels + b, a);
    if (old == b) return;
    b = old;
  }
}

__global__ void __launch_bounds__(TILE* TILE)
    cc_local_kernel(const uint8_t* __restrict__ mask, int* __restrict__ labels, int h, int w,
                    int conn8) {
  __shared__ int s[TILE * TILE];
  const int lr = threadIdx.y, lc = threadIdx.x;  // a warp is a row of the tile
  const int r = blockIdx.y * TILE + lr, c = blockIdx.x * TILE + lc;
  const int li = lr * TILE + lc;
  const bool fg = r < h && c < w && mask[r * w + c];
  // a run of set pixels in the row is one component from the start: every
  // pixel points at the run's first, past the last clear bit below its lane
  const unsigned bits = __ballot_sync(FULL, fg);
  const unsigned clear_below = ~bits & ((1u << lc) - 1u);
  const int start = clear_below ? 32 - __clz((int)clear_below) : 0;
  s[li] = fg ? lr * TILE + start : -1;  // background stays -1, foreground stays >= 0
  __syncthreads();
  if (fg && lr > 0) {
    // the row above: N alone where it is set (NW and NE, if set, lie in its
    // run), else NW and NE under 8-connectivity
    const int up = li - TILE;
    if (s[up] >= 0) {
      unite_shared(s, li, up);
    } else if (conn8) {
      if (lc > 0 && s[up - 1] >= 0) unite_shared(s, li, up - 1);
      if (lc < TILE - 1 && s[up + 1] >= 0) unite_shared(s, li, up + 1);
    }
  }
  __syncthreads();
  if (r < h && c < w) {
    int out = h * w;
    if (fg) {
      const int root = find_shared(s, li);
      out = (blockIdx.y * TILE + root / TILE) * w + blockIdx.x * TILE + root % TILE;
    }
    labels[r * w + c] = out;
  }
}

__global__ void cc_merge_kernel(const uint8_t* __restrict__ mask, int* labels, int h, int w,
                                int conn8) {
  const int t = threadIdx.x;
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const int lo = conn8 ? -1 : 0, hi = conn8 ? 1 : 0;
  // the tile's top row against the row above
  int r = r0, c = c0 + t;
  if (r0 > 0 && c < w && mask[r * w + c]) {
    for (int d = lo; d <= hi; ++d) {
      const int cc = c + d;
      if (cc >= 0 && cc < w && mask[(r - 1) * w + cc]) unite_global(labels, r * w + c, (r - 1) * w + cc);
    }
  }
  // the tile's left column against the column on its left
  r = r0 + t;
  c = c0;
  if (c0 > 0 && r < h && mask[r * w + c]) {
    for (int d = lo; d <= hi; ++d) {
      const int rr = r + d;
      if (rr >= 0 && rr < h && mask[rr * w + c - 1]) unite_global(labels, r * w + c, rr * w + c - 1);
    }
  }
}

__global__ void cc_compress_kernel(int* labels, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int l = labels[p];
  if (l != n) labels[p] = find_global(labels, l);
}

// The rank of the pixel's region, -1 on the background or outside the image;
// roots hold -1 - rank, every other foreground pixel its root's flat index.
__device__ __forceinline__ int region_rank(const int* __restrict__ labels, int r, int c, int h,
                                           int w) {
  if (r >= h || c >= w) return -1;
  const int l = labels[r * w + c];
  if (l >= h * w) return -1;
  return l < 0 ? -1 - l : -1 - __ldg(labels + l);
}

__global__ void __launch_bounds__(32 * STATS_ROWS)
    region_stats_kernel(const int* __restrict__ labels, int h, int w, int* area, int* row_min,
                        int* row_max, int* col_min, int* col_max, int* key_min) {
  const int c0 = blockIdx.x * 32;
  const int r = blockIdx.y * STATS_ROWS + threadIdx.y;
  const int rank = region_rank(labels, r, c0 + threadIdx.x, h, w);
  const unsigned peers = __match_any_sync(FULL, rank);
  const int first = __ffs(peers) - 1;
  if (rank < 0 || threadIdx.x != first) return;
  const int lo = c0 + first, hi = c0 + 31 - __clz(peers);
  atomicAdd(area + rank, __popc(peers));
  atomicMin(row_min + rank, r);
  atomicMax(row_max + rank, r);
  atomicMin(col_min + rank, lo);
  atomicMax(col_max + rank, hi);
  // the reference's scan order: columns outer, rows from the bottom inner
  atomicMin(key_min + rank, lo * h + (h - 1 - r));
}

__global__ void __launch_bounds__(32 * STATS_ROWS)
    region_ids_kernel(const int* __restrict__ labels, int h, int w, const int* __restrict__ remap,
                      int* __restrict__ ids) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int r = blockIdx.y * STATS_ROWS + threadIdx.y;
  if (r >= h || c >= w) return;
  const int rank = region_rank(labels, r, c, h, w);
  ids[r * w + c] = rank < 0 ? -1 : remap[rank];
}

bool shape_ok(int h, int w) {
  return h >= 1 && w >= 1 && (long long)h * w < 0x7fffffffLL &&
         (h + TILE - 1) / TILE <= 65535;
}

}  // namespace

// mask: (h, w) uint8 (0 or 1) contiguous; labels: (h, w) int32 out; conn8: 1
// for 8-connectivity, 0 for 4. h * w < 2^31 - 1 (the background label h * w
// fits an int). Three launches on stream; returns the cudaError_t of the
// last failing one, 0 when all were taken.
extern "C" int sat_label_components(const void* mask, void* labels, int h, int w, int conn8,
                                    void* stream) {
  if (!shape_ok(h, w)) return (int)cudaErrorInvalidValue;
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* l = static_cast<int*>(labels);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 tiles((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  cc_local_kernel<<<tiles, dim3(TILE, TILE), 0, st>>>(m, l, h, w, conn8);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cc_merge_kernel<<<tiles, TILE, 0, st>>>(m, l, h, w, conn8);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = h * w;
  cc_compress_kernel<<<(n + 255) / 256, 256, 0, st>>>(l, n);
  return (int)cudaGetLastError();
}

// labels: (h, w) int32 with ranked roots (see region_rank); each of the six
// outputs one int32 a region, area zeroed, the minima at INT_MAX and the
// maxima at -1 before the launch.
extern "C" int sat_region_stats(const void* labels, int h, int w, void* area, void* row_min,
                                void* row_max, void* col_min, void* col_max, void* key_min,
                                void* stream) {
  if (!shape_ok(h, w) || (h + STATS_ROWS - 1) / STATS_ROWS > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + 31) / 32, (h + STATS_ROWS - 1) / STATS_ROWS);
  region_stats_kernel<<<grid, dim3(32, STATS_ROWS), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(labels), h, w, static_cast<int*>(area), static_cast<int*>(row_min),
      static_cast<int*>(row_max), static_cast<int*>(col_min), static_cast<int*>(col_max),
      static_cast<int*>(key_min));
  return (int)cudaGetLastError();
}

// labels as for sat_region_stats; remap: one int32 a region, its compact id
// or -1; ids: (h, w) int32 out, -1 off the kept regions.
extern "C" int sat_region_ids(const void* labels, int h, int w, const void* remap, void* ids,
                              void* stream) {
  if (!shape_ok(h, w) || (h + STATS_ROWS - 1) / STATS_ROWS > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + 31) / 32, (h + STATS_ROWS - 1) / STATS_ROWS);
  region_ids_kernel<<<grid, dim3(32, STATS_ROWS), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(labels), h, w, static_cast<const int*>(remap),
      static_cast<int*>(ids));
  return (int)cudaGetLastError();
}
