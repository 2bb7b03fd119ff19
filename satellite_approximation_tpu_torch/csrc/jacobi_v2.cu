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
// where nsum is ((up + down) + left) + right, m is the bool mask as 0 or 1
// and deg is rounded to the storage type. Unlike jacobi.cu the mask is
// applied by multiplies, so every cell computes: a non-finite u on a known
// cell reaches its neighbours (NaN * 0 = NaN), and the sign of each output
// zero depends on b and u.
//
// What bounds it on an H100: device memory. With the residual at
// 13x2048x2048 f32 it must move 0.89 GB (u and b in, the bool mask and the
// f32 degree once, u and r out), 0.267 ms at 3.35 TB/s; every output depends
// on its cell's b and u, so no mask needs less. The arithmetic (~10 flops a
// cell and sweep) is far below the f32 peak. The earlier design swept every
// cell of every window from six shared-memory planes (~12 shared-memory
// words per cell and sweep), re-read the mask and degree for every band and
// took 2.32 ms there; this one takes 0.47 ms (57 % of the bound) on
// bench.py's cloud mask, 1.03 ms on a 60 % mask and 0.37 ms on
// benchmarks/x_kernel_v2.py's 4096^2 system (against 2.29-2.30 and
// 0.68-0.71 ms), on an H100 80GB HBM3 at 700 W (chip_smoke.py --against).
//
// Design. One block of 512 threads per 48x48 tile with an 8-cell ring (a
// 64x64 window) and a group of up to 4 bands; the mask and degree are read
// once for all of them. Cells outside the image are u = 0, b = 0, m = 0,
// deg = 1, as fused_jacobi_v2 pads them, and never update, so their masked
// u stays +0, the plain version's zero padding (an update there would turn
// it NaN beside a non-finite cell). A window is static when the first sweep
// leaves u unchanged, bit for bit, on every cell off the window's outer
// ring: then every later sweep repeats the first, because one omega serves
// every sweep and b, m, deg and inv are fixed (sweep t + 1 of a cell at
// ring >= t + 1 reads cells at ring >= t, unchanged after sweep t by
// induction). The interior (ring 8) is thus unchanged after K <= 8 sweeps,
// its residual's neighbours (ring 7) after K <= 7, and its outputs are the
// given u and one evaluation of r. Two paths, chosen block-uniformly:
//   * Streaming, for a window without an unknown cell whose rows are 16-byte
//     aligned (VEC): every tap reads u * 0 = +-0 while u is finite, so
//     A u = deg * u wherever deg * u != 0, and the update
//     (omega * (b - deg * u)) * inv is (finite) * (+0), a zero that leaves
//     u != 0 unchanged. Each thread tests its cells of two 16-byte chunks of
//     the window's rows for deg * u != 0, a finite update and inv = +0 (1/deg
//     can overflow), __syncthreads_and decides the band, and the interior's
//     chunks store u as read and r = (b - deg * u) * 0. The next band's
//     chunks load while the block tests and stores this one. On bench.py's
//     cloud mask 82 % of the windows take it. A band that fails the test
//     goes to the sweeps.
//   * Sweeps, for every other band: thread (j, g) owns the window column j,
//     rows 8g .. 8g + 7, and keeps inv, the degree, b and u of those cells
//     in registers for all sweeps, the mask as bits. Shared memory holds
//     only p = u * m, the value every neighbour tap reads, in two ping-pong
//     buffers with a +0 guard ring: per cell and sweep two loads (left,
//     right) and one store, plus two loads per strip for the rows above and
//     below it. After the first sweep __syncthreads_and tests the window for
//     the fixed point above and skips the remaining sweeps if it holds; this
//     also catches windows the streaming test leaves out (a -0 whose update
//     is -0, an unknown cell in the outer ring, ragged widths). There is no
//     finer (per-thread) skip: a known cell's u still changes when a
//     neighbour's turns non-finite, or when it is -0 and its update +0, so
//     it is fixed only if its whole neighbourhood is.
//   * 64 registers a thread (two blocks an SM), as jacobi.cu, with 16-48
//     bytes of spill stores; sweeps + residual <= 8. Staging the next band's
//     window in shared memory with cp.async instead, a cell-local test on the
//     strips, one block an SM without spills, and a first sweep peeled off
//     the loop each measured slower.
//
// Arithmetic is f32 in the plain version's operand order
// (ops/stencil_kernels.py::jacobi_v2_plain), built with -fmad=false and
// without fast math: bit-equal to it. Storage is f32 or bf16 for u, b and
// the outputs (rounded once at the store), bool for the mask, f32 or the
// storage type for the degree, which is rounded to the storage type as the
// plain version's deg.to(dtype).

#include <cstdint>
#include <cstring>

#include "stencil.cuh"

namespace {

using stencil::from_f32;
using stencil::R;
using stencil::round_to;
using stencil::to_f32;

constexpr int WIN = 64;                // window edge
constexpr int TILE = WIN - 2 * R;      // interior tile edge (48)
constexpr int ROWS = 8;                // window rows per thread (one strip)
constexpr int THREADS = WIN * WIN / ROWS;
constexpr int PITCH = WIN + 2;         // shared row with a guard cell each side
constexpr int PLANE = PITCH * PITCH;   // one p buffer with its guard ring
constexpr int MAX_BANDS_PER_BLOCK = 4;

static_assert(R % ROWS == 0 && TILE % ROWS == 0, "a strip lies in the ring or the interior");
static_assert(WIN % 32 == 0, "a warp covers 32 window columns of one row");
static_assert(2 * (PITCH + WIN) <= THREADS, "one thread per guard cell");

struct Args {
  const void* u;              // (C, H, W), T
  const void* b;              // (C, H, W), T
  const unsigned char* mask;  // (H, W), bool
  const void* deg;            // (H, W), D
  void* u_out;                // (C, H, W), T
  void* r_out;                // (C, H, W), T, written when EMIT
  int C, H, W, sweeps;
  float omega;
};

// shared-memory index of window cell (wi, wj)
__device__ __forceinline__ int at(int wi, int wj) { return (wi + 1) * PITCH + wj + 1; }

// 16 bytes of T values
template <typename T>
struct alignas(16) Chunk {
  T e[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ Chunk<T> load16(const T* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  Chunk<T> v;
  memcpy(&v, &raw, sizeof v);
  return v;
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const Chunk<T>& v) {
  uint4 raw;
  memcpy(&raw, &v, sizeof raw);
  *reinterpret_cast<uint4*>(p) = raw;
}

// VEC: the launcher found every row of u, b and the outputs 16-byte
// aligned, so a window without an unknown cell streams in 16-byte chunks
template <typename T, typename D, bool EMIT, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) jacobi_v2_kernel(const __grid_constant__ Args a) {
  __shared__ float buf[2 * PLANE];  // two p = u * m buffers
  const T* __restrict__ u_in = static_cast<const T*>(a.u);
  const T* __restrict__ b_in = static_cast<const T*>(a.b);
  const unsigned char* __restrict__ mask = a.mask;
  const D* __restrict__ deg = static_cast<const D*>(a.deg);
  T* __restrict__ u_out = static_cast<T*>(a.u_out);
  T* __restrict__ r_out = static_cast<T*>(a.r_out);
  const int H = a.H, W = a.W;
  const float omega = a.omega;
  const int i0 = blockIdx.y * TILE - R;  // image row of window row 0
  const int j0 = blockIdx.x * TILE - R;  // image column of window column 0
  // this block's bands: an even split of the C bands over gridDim.z blocks
  const int c0 = blockIdx.z * a.C / gridDim.z;
  const int c1 = (blockIdx.z + 1) * a.C / gridDim.z;

  // the +0 guard ring of both buffers
  {
    const int t = threadIdx.x;
    if (t < 2 * PITCH) {
      const int e = t < PITCH ? t : (PITCH - 1) * PITCH + t - PITCH;  // top, bottom row
      buf[e] = 0.f;
      buf[PLANE + e] = 0.f;
    } else if (t < 2 * (PITCH + WIN)) {
      const int s = t - 2 * PITCH;
      const int e = (s % WIN + 1) * PITCH + (s < WIN ? 0 : PITCH - 1);  // left, right column
      buf[e] = 0.f;
      buf[PLANE + e] = 0.f;
    }
  }

  // ---- the sweeps, on the strips of the window
  const int j = threadIdx.x % WIN;          // window column
  const int r0 = threadIdx.x / WIN * ROWS;  // first window row of the strip
  const int gj = j0 + j;                    // image column
  const bool col_in = gj >= 0 && gj < W;
  // the strip's rows are all interior or all ring (ROWS divides R and TILE)
  const bool writes = j >= R && j < R + TILE && gj < W && r0 >= R && r0 < R + TILE;
  // the strip's cells on the window's outer ring, left out of the sweep test
  const unsigned edge = j == 0 || j == WIN - 1
                            ? 0xFFu
                            : (r0 == 0 ? 1u : 0u) | (r0 == WIN - ROWS ? 1u << (ROWS - 1) : 0u);
  // the strip's degree and inv (shared by every band); bits of its cells
  // that are unknown (m = 1) and that lie in the image
  float dg[ROWS], iv[ROWS];
  unsigned mbits = 0, ibits = 0;
  auto load_strip = [&]() {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int gi = i0 + r0 + k;
      const bool in = col_in && gi >= 0 && gi < H;
      float d = 1.f, m = 0.f;
      if (in) {
        const size_t q = (size_t)gi * W + gj;
        m = mask[q] ? 1.f : 0.f;
        d = round_to<T>(to_f32(deg[q]));
      }
      dg[k] = d;
      iv[k] = (d > 0.f ? 1.f / d : 0.f) * m;
      mbits |= (m != 0.f ? 1u : 0u) << k;
      ibits |= (in ? 1u : 0u) << k;
    }
  };
  auto mf = [&](int k) -> float { return (mbits >> k & 1u) ? 1.f : 0.f; };

  // band c through the sweeps (the strip state loaded). Written out after
  // the streaming path instead, the sweeps compiled slower.
  auto sweep_band = [&](int c) {
    // u and b of the strip (0 outside the image), all loads issued before
    // any use
    float u[ROWS], bv[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const size_t q = ((size_t)c * H + (i0 + r0 + k)) * W + gj;
      u[k] = bv[k] = 0.f;
      if (ibits >> k & 1u) {
        u[k] = to_f32(u_in[q]);
        bv[k] = to_f32(b_in[q]);
      }
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) buf[at(r0 + k, j)] = u[k] * mf(k);
    __syncthreads();

    int p = 0;  // buffer holding the current p
    for (int s = 0; s < a.sweeps; ++s) {
      const float* cur = buf + p * PLANE;
      float* nxt = buf + (p ^ 1) * PLANE;
      bool same = true;  // the sweep leaves the strip's u unchanged
      float up = cur[at(r0 - 1, j)];
      float pc = u[0] * mf(0);
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int idx = at(r0 + k, j);
        const float down = k + 1 < ROWS ? u[k + 1] * mf(k + 1) : cur[idx + PITCH];
        const float nsum = ((up + down) + cur[idx - 1]) + cur[idx + 1];
        const float uc = u[k];
        const float au = dg[k] * uc - nsum;
        const float un = (ibits >> k & 1u) ? uc + (omega * (bv[k] - au)) * iv[k] : uc;
        same = same && (__float_as_uint(un) == __float_as_uint(uc) || (edge >> k & 1u));
        up = pc;
        pc = down;
        u[k] = un;
        nxt[idx] = un * mf(k);
      }
      p ^= 1;
      if (s > 0) {
        __syncthreads();
      } else if (__syncthreads_and(same)) {
        break;  // a static window: every later sweep repeats this one
      }
    }

    if (writes) {
      const float* cur = buf + p * PLANE;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int gi = i0 + r0 + k;
        if (gi >= H) break;
        const size_t q = ((size_t)c * H + gi) * W + gj;
        u_out[q] = from_f32<T>(u[k]);
        if (EMIT) {
          const int idx = at(r0 + k, j);
          const float up = k > 0 ? u[k - 1] * mf(k - 1) : cur[idx - PITCH];
          const float down = k + 1 < ROWS ? u[k + 1] * mf(k + 1) : cur[idx + PITCH];
          const float au = dg[k] * u[k] - (((up + down) + cur[idx - 1]) + cur[idx + 1]);
          r_out[q] = from_f32<T>((bv[k] - au) * mf(k));
        }
      }
    }
    __syncthreads();  // the next band overwrites the buffers
  };

  // the block's bands that go through the sweeps, one bit each
  unsigned sweep_bits = (1u << (c1 - c0)) - 1u;
  if constexpr (VEC) {
    // ---- a window without an unknown cell streams: thread t owns the
    // 16-byte chunks t, t + THREADS, .. of the window's rows
    constexpr int EPC = 16 / sizeof(T);                 // cells a chunk
    constexpr int PER_ROW = WIN / EPC;                  // chunks a window row
    constexpr int NCH = WIN * PER_ROW / THREADS;        // chunks a thread
    static_assert(R % EPC == 0 && TILE % EPC == 0, "a chunk lies in the ring or the interior");
    float dq[NCH][EPC];  // degree of the chunks' cells
    size_t off[NCH];     // plane offset of each chunk
    unsigned in_bits = 0, wr_bits = 0;  // chunks in the image; in the interior
    bool unknown = false, inv_zero = true;
#pragma unroll
    for (int n = 0; n < NCH; ++n) {
      const int ch = threadIdx.x + n * THREADS;
      const int wi = ch / PER_ROW, wj = ch % PER_ROW * EPC;
      const int gi = i0 + wi, gjc = j0 + wj;
      // W is a multiple of EPC: a chunk lies wholly in or out of the image
      const bool in = gi >= 0 && gi < H && gjc >= 0 && gjc < W;
      in_bits |= (in ? 1u : 0u) << n;
      wr_bits |= (in && wi >= R && wi < R + TILE && wj >= R && wj < R + TILE ? 1u : 0u) << n;
      off[n] = in ? (size_t)gi * W + gjc : 0;
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        float d = 1.f;
        if (in) {
          unknown |= mask[off[n] + e] != 0;
          d = round_to<T>(to_f32(deg[off[n] + e]));
        }
        dq[n][e] = d;
        // inv on a known cell: +0, or NaN where 1/deg overflows
        inv_zero &= __float_as_uint((d > 0.f ? 1.f / d : 0.f) * 0.f) == 0u;
      }
    }
    if (!__syncthreads_or(unknown)) {
      // every tap reads u * 0 = +-0 while u is finite, so A u = deg * u
      // wherever deg * u != 0, and a cell keeps its u when its update
      // (omega * (b - deg * u)) * inv is (finite) * (+0): then the window
      // is static, its u is the given one and r = (b - deg * u) * 0
      Chunk<T> uc[NCH], bc[NCH], un[NCH], bn[NCH];
      auto load_band = [&](int c, Chunk<T>* uu, Chunk<T>* bb) {
        const size_t band = (size_t)c * H * W;
#pragma unroll
        for (int n = 0; n < NCH; ++n) {
          if (in_bits >> n & 1u) {
            uu[n] = load16(u_in + band + off[n]);
            bb[n] = load16(b_in + band + off[n]);
          }
        }
      };
      load_band(c0, un, bn);
      for (int c = c0; c < c1; ++c) {
        const size_t band = (size_t)c * H * W;
#pragma unroll
        for (int n = 0; n < NCH; ++n) {
          uc[n] = un[n];
          bc[n] = bn[n];
        }
        if (c + 1 < c1) load_band(c + 1, un, bn);
        bool fixed = inv_zero;
#pragma unroll
        for (int n = 0; n < NCH; ++n) {
          if (!(in_bits >> n & 1u)) continue;
#pragma unroll
          for (int e = 0; e < EPC; ++e) {
            const float du = dq[n][e] * to_f32(uc[n].e[e]);
            fixed &= (du != 0.f) & (fabsf(omega * (to_f32(bc[n].e[e]) - du)) <= 3.402823466e38f);
          }
        }
        if (!__syncthreads_and(fixed)) continue;  // left to the sweeps
        sweep_bits &= ~(1u << (c - c0));
#pragma unroll
        for (int n = 0; n < NCH; ++n) {
          if (!(wr_bits >> n & 1u)) continue;
          store16(u_out + band + off[n], uc[n]);
          if (EMIT) {
            Chunk<T> rc;
#pragma unroll
            for (int e = 0; e < EPC; ++e) {
              const float du = dq[n][e] * to_f32(uc[n].e[e]);
              rc.e[e] = from_f32<T>((to_f32(bc[n].e[e]) - du) * 0.f);
            }
            store16(r_out + band + off[n], rc);
          }
        }
      }
    }
  }
  if (sweep_bits == 0) return;
  load_strip();
  for (int c = c0; c < c1; ++c) {
    if (sweep_bits >> (c - c0) & 1u) sweep_band(c);
  }
}

template <typename T, typename D, bool EMIT, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int tx = (a.W + TILE - 1) / TILE, ty = (a.H + TILE - 1) / TILE;
  int per = 1;
  const cudaError_t err = stencil::bands_per_block(a.C, tx * ty, MAX_BANDS_PER_BLOCK, &per);
  if (err != cudaSuccess) return err;
  const dim3 grid(tx, ty, (a.C + per - 1) / per);
  jacobi_v2_kernel<T, D, EMIT, VEC><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, typename D>
cudaError_t dispatch(int emit, const Args& a, cudaStream_t s) {
  const bool vec = a.W * sizeof(T) % 16 == 0 && aligned16(a.u) && aligned16(a.b) &&
                   aligned16(a.u_out) && (!emit || aligned16(a.r_out));
  if (vec) return emit ? launch<T, D, true, true>(a, s) : launch<T, D, false, true>(a, s);
  return emit ? launch<T, D, true, false>(a, s) : launch<T, D, false, false>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of u, b, u_out and r_out; deg_dtype:
// 0 = float32, or 1 = bfloat16 with dtype 1. u, b, u_out, r_out: (C, H, W);
// mask (bool, one byte a cell) and deg: (H, W).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_jacobi_v2(int dtype, int deg_dtype, int emit, const void* u, const void* b,
                             const void* mask, const void* deg, void* u_out, void* r_out, int C,
                             int H, int W, int sweeps, float omega, void* stream) {
  if (sweeps < 1 || sweeps + (emit ? 1 : 0) > R || !stencil::grid_fits(C, H, W, TILE)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a = {u, b, static_cast<const unsigned char*>(mask), deg, u_out, r_out,
                  C, H, W, sweeps, omega};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && deg_dtype == 0) return (int)dispatch<float, float>(emit, a, s);
  if (dtype == 1 && deg_dtype == 0) return (int)dispatch<__nv_bfloat16, float>(emit, a, s);
  if (dtype == 1 && deg_dtype == 1) {
    return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(emit, a, s);
  }
  return (int)cudaErrorInvalidValue;
}
