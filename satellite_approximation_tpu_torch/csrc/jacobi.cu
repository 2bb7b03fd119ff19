// Fused Chebyshev-weighted Jacobi smoother of the masked 5-point operator
//
//     A u = deg * u - sum of the unknown 4-neighbours of u
//
// for the multigrid V-cycle (models/multigrid.py::_v_cycle, _smooth).
//
// Replaces, in satellite_approximation_tpu/ops/pallas_kernels.py
// (_kernel_factory, called through _zero_call and the jitted wrappers):
//   * fused_jacobi_zero_tpu / fused_jacobi_zero_tpu_padded (zero_start=True):
//     the pre-smooth from u = 0, emitting (u, r = (b - A u) * m)
//                                           -> jacobi_kernel<T, FROM_ZERO, *>
//   * the same with emit_residual="half": r comes out with its row pairs
//     already summed, r[2i] + r[2i + 1] (the row pass of _restrict), into a
//     (C, ceil(H/2), W) raster          -> jacobi_kernel<T, FROM_ZERO, EMIT_HALF>
//   * fused_jacobi_tpu / fused_jacobi_tpu_padded: K sweeps from a given u,
//     r on request                      -> jacobi_kernel<T, FROM_U, *>
//   * fused_jacobi_corr_tpu_padded (fuse_corr=True): the post-smooth,
//     u += prolong(e_c) on unknowns and then K sweeps, r on request
//                                           -> jacobi_kernel<T, FROM_U_CORR, *>
//
// What bounds it on an H100: device memory. Counted densely, the zero-start
// call with its residual at 13x2048x2048 f32 moves 0.67 GB (b and invm in,
// u and r out), 0.200 ms at 3.35 TB/s; a known cell needs none of b and its
// outputs are fixed, so on bench.py's cloud mask (6.1 % unknown) what must
// move is 0.47 GB, 0.140 ms (the post-smooth: 0.69 GB, 0.206 ms). The
// arithmetic (7 sweeps of ~10 flops on the unknown cells) is far below the
// f32 peak. The earlier design swept every window cell of every tile from
// five shared-memory planes (~12 shared-memory words per cell and sweep)
// and took 1.47 ms there: it was bound by shared-memory throughput. This one
// takes 0.22 ms for the zero start and 0.38 ms for the post-smooth (62 % and
// 55 % of those bounds; 2.49 -> 0.68 ms and 3.16 -> 0.94 ms on a 60 % mask),
// on an H100 80GB HBM3 at 700 W (chip_smoke.py, with --against for both).
//
// Design. One block of 512 threads per 48x48 tile with an 8-cell ring (a
// 64x64 window) and a group of up to 4 bands. Cells outside the image are
// known (b = invm = u = 0).
//   * Tile skip: each thread reads invm for its cells once for all the
//     block's bands, and __syncthreads_or over the tile's interior decides,
//     block-uniformly, whether any interior cell is unknown. A known cell's
//     outputs never depend on its neighbours, so a tile without one does no
//     sweeps and only streams its outputs (u: +0 from zero, a copy from u,
//     u + 0 after the correction, as the plain version's add gives; r: +0).
//     On the bench mask 85 % of the tiles stream.
//   * Registers: thread (j, g) owns the window column j, rows 8g .. 8g + 7,
//     and keeps invm, the degree, b and u of those cells in registers for
//     all sweeps; its vertical neighbours are its own registers. Shared
//     memory holds only u, masked (0 on known cells, as every neighbour sees
//     them), in two ping-pong buffers with a zero guard ring: per cell and
//     sweep two loads (left, right) and one store, plus two loads per strip
//     for the rows above and below it. A thread whose cells are all known
//     skips the sweeps (their masked values are constant), so a warp over a
//     known patch does no work; b, u and e_c are read on unknown cells only,
//     the known cells' u only when it is written out.
//   * 64 registers a thread (two blocks an SM) hold a 64x64 window; a wider
//     or taller one (1.52x the interior instead of 1.78x) leaves one block
//     an SM and measured slower on the bench mask. The arguments are a
//     __grid_constant__, so indexing their weights costs no per-thread copy.
//   * Sweep t is exact at ring >= t (the error of the window's edge moves in
//     one cell per sweep), so the interior stays exact while the general
//     sweeps (+1 with a residual) are at most 8; the zero-start first sweep
//     is local (A 0 = 0) and does not count. The ring cells are computed
//     like any other and never written.
//   * The half residual pairs rows inside a strip: tiles and strips start on
//     even rows and hold an even number of them, so a pair never straddles
//     two threads; for odd H the last row pairs with the known cell below
//     the image (+0), as _restrict pads it with a zero row.
//
// Arithmetic is f32 in the operand order of the plain version
// (ops/stencil_kernels.py): neighbour sum ((up + down) + left) + right,
// au = deg*u - nsum, u + (omega*(b - au))*invm, masking by selects, the
// degree as rint(1/invm). Built with -fmad=false and without fast math, so
// it is bit-equal to the plain version. Storage is f32 or bf16 (rounded to
// nearest even on store; the half residual rounds each row's r and then
// their sum, as the plain row pass of the stored residual does).

#include "stencil.cuh"

namespace {

using stencil::from_f32;
using stencil::MAX_SWEEPS;
using stencil::R;
using stencil::round_to;
using stencil::to_f32;

constexpr int WIN = 64;                // window edge
constexpr int TILE = WIN - 2 * R;      // interior tile edge (48)
constexpr int ROWS = 8;                // window rows per thread (one strip)
constexpr int THREADS = WIN * WIN / ROWS;
constexpr int PITCH = WIN + 2;         // shared row with a guard cell each side
constexpr int PLANE = PITCH * PITCH;   // one u buffer with its guard ring
constexpr int MAX_BANDS_PER_BLOCK = 4;

static_assert(TILE % 2 == 0 && R % 2 == 0 && ROWS % 2 == 0,
              "row pairs of the half residual must not straddle tiles or strips");
static_assert(R % ROWS == 0 && TILE % ROWS == 0, "a strip lies in the ring or the interior");
static_assert(WIN % 32 == 0, "a warp covers 32 window columns of one row");
static_assert(2 * (PITCH + WIN) <= THREADS, "one thread per guard cell");

// where the sweeps start
enum Start { FROM_ZERO = 0, FROM_U = 1, FROM_U_CORR = 2 };
// what is written besides u
enum Emit { EMIT_NONE = 0, EMIT_FULL = 1, EMIT_HALF = 2 };

struct Args {
  const void* u;     // (C, H, W), unused FROM_ZERO
  const void* b;     // (C, H, W)
  const void* invm;  // (H, W)
  const void* ec;    // (C, Hc, Wc), read only FROM_U_CORR
  void* u_out;       // (C, H, W)
  void* r_out;       // (C, H, W), or (C, ceil(H/2), W) for EMIT_HALF
  int C, H, W, Hc, Wc, sweeps;
  float w[MAX_SWEEPS];
};

// shared-memory index of window cell (wi, wj)
__device__ __forceinline__ int at(int wi, int wj) { return (wi + 1) * PITCH + wj + 1; }

template <typename T, int START, int EMIT>
__global__ void __launch_bounds__(THREADS, 2) jacobi_kernel(const __grid_constant__ Args a) {
  __shared__ float buf[2 * PLANE];  // two u buffers
  const T* __restrict__ u_in = static_cast<const T*>(a.u);
  const T* __restrict__ b_in = static_cast<const T*>(a.b);
  const T* __restrict__ invm = static_cast<const T*>(a.invm);
  const T* __restrict__ ec = static_cast<const T*>(a.ec);
  T* __restrict__ u_out = static_cast<T*>(a.u_out);
  T* __restrict__ r_out = static_cast<T*>(a.r_out);
  const int H = a.H, W = a.W;

  const int j = threadIdx.x % WIN;           // window column
  const int r0 = threadIdx.x / WIN * ROWS;   // first window row of the strip
  const int i0 = blockIdx.y * TILE - R;      // image row of window row 0 (even)
  const int gj = blockIdx.x * TILE - R + j;  // image column
  const bool col_in = gj >= 0 && gj < W;
  // the strip's rows are all interior or all ring (ROWS divides R and TILE)
  const bool writes = j >= R && j < R + TILE && gj < W && r0 >= R && r0 < R + TILE;
  // this block's bands: an even split of the C bands over gridDim.z blocks
  const int c0 = blockIdx.z * a.C / gridDim.z;
  const int c1 = (blockIdx.z + 1) * a.C / gridDim.z;

  // invm of the strip (shared by every band), and whether the tile's
  // interior holds an unknown cell
  float iv[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int gi = i0 + r0 + k;
    iv[k] = col_in && gi >= 0 && gi < H ? to_f32(invm[(size_t)gi * W + gj]) : 0.f;
  }
  bool interior_unknown = false;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) interior_unknown |= writes && iv[k] > 0.f;
  const bool active = __syncthreads_or(interior_unknown);

  // u of band c's known cell (gi, gj) as the plain version leaves it: +0
  // from zero, copied from u, u + 0 after the correction (its add)
  auto known_u = [&](int c, int gi) -> float {
    if (START == FROM_ZERO) return 0.f;
    const float x = to_f32(u_in[((size_t)c * H + gi) * W + gj]);
    return START == FROM_U_CORR ? x + 0.f : x;
  };

  if (!active) {
    // no unknown interior cell: no sweeps, only the outputs stream
    if (!writes) return;
    const int Hh = (H + 1) / 2;
    for (int c = c0; c < c1; ++c) {
      float kv[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) kv[k] = i0 + r0 + k < H ? known_u(c, i0 + r0 + k) : 0.f;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int gi = i0 + r0 + k;
        if (gi >= H) break;
        const size_t o = ((size_t)c * H + gi) * W + gj;
        u_out[o] = from_f32<T>(kv[k]);
        if (EMIT == EMIT_FULL) r_out[o] = from_f32<T>(0.f);
        if (EMIT == EMIT_HALF && k % 2 == 0) {
          r_out[((size_t)c * Hh + (gi >> 1)) * W + gj] = from_f32<T>(0.f);
        }
      }
    }
    return;
  }

  // per tile: the degree, which strips hold an unknown cell, the zero guard
  // ring and the zero (known) cells of every strip, in both buffers
  float dg[ROWS];
  bool mine = false;  // the strip holds an unknown cell
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const bool unk = iv[k] > 0.f;
    mine |= unk;
    // exact stencil degree: 1/(1/d) round trips in f32, and the rounding
    // restores it from a bf16-stored invm
    dg[k] = unk ? rintf(1.f / iv[k]) : 1.f;
    buf[at(r0 + k, j)] = 0.f;
    buf[PLANE + at(r0 + k, j)] = 0.f;
  }
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

  for (int c = c0; c < c1; ++c) {
    // u (masked: 0 on known cells) and b of the strip; b, u and e_c are
    // read on unknown cells only, all loads issued before any use
    float u[ROWS], bv[ROWS], e[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int gi = i0 + r0 + k;
      const size_t q = ((size_t)c * H + gi) * W + gj;
      bv[k] = u[k] = e[k] = 0.f;
      if (iv[k] > 0.f) {  // implies the cell lies in the image
        bv[k] = to_f32(b_in[q]);
        if (START != FROM_ZERO) u[k] = to_f32(u_in[q]);
        if (START == FROM_U_CORR) {
          e[k] = to_f32(ec[((size_t)c * a.Hc + (gi >> 1)) * a.Wc + (gj >> 1)]);
        }
      }
    }
    int p = 0;  // buffer holding the current u
    if (mine) {
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const bool unk = iv[k] > 0.f;
        if (START == FROM_ZERO) u[k] = unk ? (a.w[0] * bv[k]) * iv[k] : 0.f;
        if (START == FROM_U_CORR) u[k] = unk ? u[k] + e[k] : 0.f;
        buf[at(r0 + k, j)] = u[k];
        buf[PLANE + at(r0 + k, j)] = u[k];
      }
    }
    __syncthreads();

    for (int s = START == FROM_ZERO ? 1 : 0; s < a.sweeps; ++s) {
      if (mine) {
        const float* cur = buf + p * PLANE;
        float* nxt = buf + (p ^ 1) * PLANE;
        const float w = a.w[s];
        float up = cur[at(r0 - 1, j)];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const int idx = at(r0 + k, j);
          const float uc = u[k];
          const float down = k + 1 < ROWS ? u[k + 1] : cur[idx + PITCH];
          const float nsum = ((up + down) + cur[idx - 1]) + cur[idx + 1];
          const float au = dg[k] * uc - nsum;
          const float un = iv[k] > 0.f ? uc + (w * (bv[k] - au)) * iv[k] : uc;
          up = uc;
          u[k] = un;
          nxt[idx] = un;
        }
      }
      __syncthreads();
      p ^= 1;
    }

    // (b - A u) on an unknown cell k of the strip, 0 on a known one
    const float* cur = buf + p * PLANE;
    auto residual = [&](int k) -> float {
      if (!(iv[k] > 0.f)) return 0.f;
      const int idx = at(r0 + k, j);
      const float up = k > 0 ? u[k - 1] : cur[idx - PITCH];
      const float down = k + 1 < ROWS ? u[k + 1] : cur[idx + PITCH];
      const float au = dg[k] * u[k] - (((up + down) + cur[idx - 1]) + cur[idx + 1]);
      return bv[k] - au;
    };
    if (writes) {
      // the residual first, then u: the known cells' u is read only now
      const int Hh = (H + 1) / 2;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int gi = i0 + r0 + k;
        if (gi >= H) break;
        if (EMIT == EMIT_FULL) r_out[((size_t)c * H + gi) * W + gj] = from_f32<T>(residual(k));
        if (EMIT == EMIT_HALF && k % 2 == 0) {
          // row gi + 1 == H lies outside the image: a known cell, r = +0
          const float even = round_to<T>(residual(k));
          const float odd = round_to<T>(residual(k + 1));
          r_out[((size_t)c * Hh + (gi >> 1)) * W + gj] = from_f32<T>(even + odd);
        }
      }
      float kv[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int gi = i0 + r0 + k;
        kv[k] = gi < H && !(iv[k] > 0.f) ? known_u(c, gi) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int gi = i0 + r0 + k;
        if (gi >= H) break;
        u_out[((size_t)c * H + gi) * W + gj] = from_f32<T>(iv[k] > 0.f ? u[k] : kv[k]);
      }
    }
    __syncthreads();  // the next band overwrites the buffers
  }
}

template <typename T, int START, int EMIT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int tx = (a.W + TILE - 1) / TILE, ty = (a.H + TILE - 1) / TILE;
  int per = 1;
  const cudaError_t err = stencil::bands_per_block(a.C, tx * ty, MAX_BANDS_PER_BLOCK, &per);
  if (err != cudaSuccess) return err;
  const dim3 grid(tx, ty, (a.C + per - 1) / per);
  jacobi_kernel<T, START, EMIT><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int start, int emit, const Args& a, cudaStream_t s) {
  switch (start * 3 + emit) {
    case FROM_ZERO * 3 + EMIT_NONE: return launch<T, FROM_ZERO, EMIT_NONE>(a, s);
    case FROM_ZERO * 3 + EMIT_FULL: return launch<T, FROM_ZERO, EMIT_FULL>(a, s);
    case FROM_ZERO * 3 + EMIT_HALF: return launch<T, FROM_ZERO, EMIT_HALF>(a, s);
    case FROM_U * 3 + EMIT_NONE: return launch<T, FROM_U, EMIT_NONE>(a, s);
    case FROM_U * 3 + EMIT_FULL: return launch<T, FROM_U, EMIT_FULL>(a, s);
    case FROM_U_CORR * 3 + EMIT_NONE: return launch<T, FROM_U_CORR, EMIT_NONE>(a, s);
    case FROM_U_CORR * 3 + EMIT_FULL: return launch<T, FROM_U_CORR, EMIT_FULL>(a, s);
    default: return cudaErrorInvalidValue;  // the half residual exists only from zero
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every operand in the same type).
// start: 0 = from u = 0 (u and ec unused), 1 = from u (ec unused), 2 = from
// u with the coarse correction ec (C, Hc, Wc) added on unknowns first.
// emit: 0 = u only, 1 = also r (C, H, W), 2 = also the row-paired r
// (C, ceil(H/2), W), start 0 only.
// omegas: host array of `sweeps` f32 weights, applied in order.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sat_jacobi(int dtype, int start, int emit, const void* u, const void* b,
                          const void* invm, const void* ec, void* u_out, void* r_out, int C,
                          int H, int W, int Hc, int Wc, int sweeps, const void* omegas,
                          void* stream) {
  const int general = start == FROM_ZERO ? sweeps - 1 : sweeps;
  if (sweeps < 1 || sweeps > MAX_SWEEPS || general + (emit ? 1 : 0) > R ||
      !stencil::grid_fits(C, H, W, TILE)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {u, b, invm, ec, u_out, r_out, C, H, W, Hc, Wc, sweeps, {}};
  const float* w = static_cast<const float*>(omegas);
  for (int k = 0; k < sweeps; ++k) a.w[k] = w[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(start, emit, a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(start, emit, a, s);
  return (int)cudaErrorInvalidValue;
}
