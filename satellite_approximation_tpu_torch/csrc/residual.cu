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
//     emits b                                   -> residual_kernel<TI, false, *>
//   * residual_pair_tpu_padded (_residual_factory(with_xlo=True)): every
//     refinement pass                           -> residual_kernel<TI, true, *>
//
// What bounds it on an H100: device-memory bytes, and of those the output
// stream. A known cell's outputs are fixed (r = +0, b = +0), so at
// 13x2048x2048 on bench.py's mask (6.1 % unknown) the entry call must write
// r and b (436 MB), read invm once (17 MB) and the image only in the 32-byte
// sectors around unknown cells: 0.47 GB, 0.140 ms at 3.35 TB/s; the pair
// call 0.28 GB, 0.083 ms. The arithmetic (~40 flops on an unknown cell) is
// far below the f32 peak. The earlier design (one thread per cell, one block
// per band and 8x32 tile) re-read the invm plane for every band (13 x 16.8 MB,
// as much as the pair call's whole output), moved 4 bytes a thread and read
// each neighbour's invm once per band: 0.31 and 0.21 ms, 45 % and 41 % of
// those bounds. This one takes 0.20 and 0.125 ms (69 % and 66-68 %), and
// at one 10980x10980 band 0.53 and 0.43 ms against 0.70 and 0.50 (H100
// 80GB HBM3 at 700 W, chip_smoke.py --against for both).
//
// Design:
//   * A thread owns a strip of 4 contiguous cells of one row; a warp covers
//     128 columns of a row, a block 8 rows, and the block loops over a group
//     of bands. The launcher picks the fewest groups (one, holding all C
//     bands, on a large image) that still give 8 blocks an SM, two waves of
//     the 4 that are resident at once.
//   * invm is read once per group: each thread loads its strip's 4 values
//     (16 bytes, 8 in bf16) and, only if the strip holds an unknown cell,
//     those of the rows above and below and of the cells left and right. It
//     derives k of its cells and a bitmask of the unknown flags of its cells
//     and their neighbours once for every band of the group.
//   * At most 64 registers a thread (4 blocks of 256 threads an SM). Left
//     free, the pair took 90-97 registers, 2 blocks an SM, and was slower
//     than the earlier design at C = 1, where a thread makes one load and
//     one store: too few bytes were in flight. Two or four rows a thread,
//     or two or four band groups, measured no faster on the bench mask.
//   * A strip with no unknown cell stores +0 into r (and b) of every band of
//     the group, 16 bytes a store, and reads nothing else.
//   * A strip with an unknown cell reads, per band, the 16-byte vectors of
//     img, x_hi and x_lo of the three rows its unknown cells touch, each only
//     where one of them needs it, and the cells left and right, straight from
//     device memory: a one-cell halo is served by L1 and needs no
//     shared-memory staging. Its known cells get r = +0 (b = +0).
//   * 16-byte accesses need a width that is a multiple of 4 and aligned
//     operands; otherwise the launcher takes the same template with per-cell
//     loads and stores bounded by the width (a 1373x1374 grid, or an operand
//     at an address 4 mod 16). Cells outside the image are known, with value
//     +0, as the plain version pads them.
//
// Bit-parity contract with the plain version (ops/stencil_kernels.py): the
// TwoSum chain folds the terms in the order (up, down, left, right,
// -4*x_hi, k*x_hi), then the lo sum ((((lu + ld) + ll) + lr) - 4*x_lo) +
// k*x_lo, with k = 4 - deg on unknowns; b sums ((up + down) + left) + right
// of the known neighbours. TwoSum is error-free only if no add is
// reassociated or contracted: built with -fmad=false and without fast math.
// img, x_hi and x_lo are f32; invm is f32 or bf16 (the degree is rounded
// back to an integer either way).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int STRIP = 4;              // contiguous cells of a row a thread owns
constexpr int BX = 32;                // strips across a block: one warp, 128 columns
constexpr int BY = 8;                 // rows of a block, one warp each
constexpr int THREADS = BX * BY;
constexpr int MIN_BLOCKS_PER_SM = 4;  // resident blocks an SM: at most 64 registers
constexpr int BLOCKS_PER_SM = 8;      // the grid keeps at least this many (two waves)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The strip j0 .. j0 + 3 of `row` in f32. VEC: one 16-byte load (8 bytes
// for bf16); else per-cell loads, +0 past the width.
template <bool VEC>
__device__ __forceinline__ void load_strip(const float* __restrict__ row, int j0, int W,
                                           float (&v)[STRIP]) {
  if (VEC) {
    const float4 t = *reinterpret_cast<const float4*>(row + j0);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < STRIP; ++k) v[k] = j0 + k < W ? row[j0 + k] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load_strip(const __nv_bfloat16* __restrict__ row, int j0, int W,
                                           float (&v)[STRIP]) {
  if (VEC) {
    // a bf16 is the high half of the f32 it widens to
    const uint2 t = *reinterpret_cast<const uint2*>(row + j0);
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int k = 0; k < STRIP; ++k) v[k] = j0 + k < W ? to_f32(row[j0 + k]) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_strip(float* __restrict__ row, int j0, int W,
                                            const float (&v)[STRIP]) {
  if (VEC) {
    *reinterpret_cast<float4*>(row + j0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < STRIP; ++k) {
      if (j0 + k < W) row[j0 + k] = v[k];
    }
  }
}

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// the hi cascade over (up, down, left, right, -4 x, k x): (s, c)
__device__ __forceinline__ void cascade(float t1, float t2, float t3, float t4, float x, float kf,
                                        float& s, float& c) {
  float e;
  two_sum(t1, t2, s, c);
  two_sum(s, t3, s, e);
  c = c + e;
  two_sum(s, t4, s, e);
  c = c + e;
  two_sum(s, -4.f * x, s, e);
  c = c + e;
  two_sum(s, kf * x, s, e);
  c = c + e;
}

// Thread (x, y) of block (bx, by, g) owns the strip of row 8 by + y at
// columns 4 (32 bx + x) .. + 3 for the bands of group g.
// PAIR = false: entry residual from img alone (y = img), also writes b_out.
// PAIR = true: residual of the pair (x_hi, x_lo), with y = known + x_hi.
// VEC: 16-byte strips (W % 4 == 0, aligned operands); else per-cell accesses.
template <typename TI, bool PAIR, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM) residual_kernel(
    const float* __restrict__ img, const float* __restrict__ xhi, const float* __restrict__ xlo,
    const TI* __restrict__ invm, float* __restrict__ r_out, float* __restrict__ b_out, int C,
    int H, int W) {
  const int j0 = (blockIdx.x * BX + threadIdx.x) * STRIP;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= H || j0 >= W) return;
  // this block's bands: an even split of the C bands over gridDim.z groups
  const int c0 = blockIdx.z * C / gridDim.z;
  const int c1 = (blockIdx.z + 1) * C / gridDim.z;
  const size_t plane = (size_t)H * W;
  const size_t row = (size_t)i * W;  // offset of the strip's row in a band

  float iv[STRIP];
  load_strip<VEC>(invm + row, j0, W, iv);
  // bit k: cell k is unknown; 4 + k, 8 + k: the cell above, below it;
  // WEST: the cell left of cell 0; EAST: the cell right of cell 3
  constexpr int UP = 4, DOWN = 8, WEST = 12, EAST = 13;
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < STRIP; ++k) m |= (iv[k] > 0.f ? 1u : 0u) << k;
  if (m == 0) {
    const float zero[STRIP] = {0.f, 0.f, 0.f, 0.f};
    for (int c = c0; c < c1; ++c) {
      store_strip<VEC>(r_out + c * plane + row, j0, W, zero);
      if (!PAIR) store_strip<VEC>(b_out + c * plane + row, j0, W, zero);
    }
    return;
  }

  // once for the group: k of the strip's cells and the neighbours' flags
  auto bit = [&](int b) { return ((m >> b) & 1u) != 0; };
  const bool up_in = i > 0, down_in = i + 1 < H;
  const bool west = j0 > 0 && bit(0);               // cell 0 reads its left neighbour
  const bool east = j0 + STRIP < W && bit(STRIP - 1);  // cell 3 its right one
  float kf[STRIP];
#pragma unroll
  for (int k = 0; k < STRIP; ++k) kf[k] = bit(k) ? 4.f - rintf(1.f / iv[k]) : 0.f;
  {
    float nb[STRIP];
    if (up_in) {
      load_strip<VEC>(invm + row - W, j0, W, nb);
#pragma unroll
      for (int k = 0; k < STRIP; ++k) m |= (nb[k] > 0.f ? 1u : 0u) << (UP + k);
    }
    if (down_in) {
      load_strip<VEC>(invm + row + W, j0, W, nb);
#pragma unroll
      for (int k = 0; k < STRIP; ++k) m |= (nb[k] > 0.f ? 1u : 0u) << (DOWN + k);
    }
    if (west && to_f32(invm[row + j0 - 1]) > 0.f) m |= 1u << WEST;
    if (east && to_f32(invm[row + j0 + STRIP]) > 0.f) m |= 1u << EAST;
  }
  auto unk_w = [&](int k) { return k > 0 ? bit(k - 1) : bit(WEST); };
  auto unk_e = [&](int k) { return k + 1 < STRIP ? bit(k + 1) : bit(EAST); };
  // which vectors the pair reads (y is x_hi on unknown cells, img on known):
  // img of the strip's row where a known cell lies beside an unknown one,
  // x_hi / img of the rows above and below where an unknown cell's
  // neighbour there is unknown / known
  const unsigned own = m & 0xfu, up = (m >> UP) & 0xfu, down = (m >> DOWN) & 0xfu;
  const bool img_own = (~own & ((own << 1) | (own >> 1)) & 0xfu) != 0;
  const bool hi_up = up_in && (own & up) != 0, img_up = up_in && (own & ~up) != 0;
  const bool hi_down = down_in && (own & down) != 0, img_down = down_in && (own & ~down) != 0;

  for (int c = c0; c < c1; ++c) {
    const size_t at = c * plane + row;  // the strip's row in band c
    const float* im = img + at;
    float r[STRIP];
    if (PAIR) {
      const float* xh = xhi + at;
      const float* xl = xlo + at;
      float hc[STRIP], lc[STRIP], ic[STRIP] = {};
      float hu[STRIP] = {}, iu[STRIP] = {}, lu[STRIP] = {};
      float hd[STRIP] = {}, id[STRIP] = {}, ld[STRIP] = {};
      load_strip<VEC>(xh, j0, W, hc);
      load_strip<VEC>(xl, j0, W, lc);
      if (img_own) load_strip<VEC>(im, j0, W, ic);
      if (hi_up) load_strip<VEC>(xh - W, j0, W, hu);
      if (img_up) load_strip<VEC>(im - W, j0, W, iu);
      if (up_in) load_strip<VEC>(xl - W, j0, W, lu);
      if (hi_down) load_strip<VEC>(xh + W, j0, W, hd);
      if (img_down) load_strip<VEC>(im + W, j0, W, id);
      if (down_in) load_strip<VEC>(xl + W, j0, W, ld);
      float yw = 0.f, lw = 0.f, ye = 0.f, le = 0.f;
      if (west) {
        yw = bit(WEST) ? xh[j0 - 1] : im[j0 - 1];
        lw = xl[j0 - 1];
      }
      if (east) {
        ye = bit(EAST) ? xh[j0 + STRIP] : im[j0 + STRIP];
        le = xl[j0 + STRIP];
      }
#pragma unroll
      for (int k = 0; k < STRIP; ++k) {
        r[k] = 0.f;
        if (!bit(k)) continue;
        const float y_u = bit(UP + k) ? hu[k] : iu[k];
        const float y_d = bit(DOWN + k) ? hd[k] : id[k];
        const float y_w = k > 0 ? (bit(k - 1) ? hc[k - 1] : ic[k - 1]) : yw;
        const float y_e = k + 1 < STRIP ? (bit(k + 1) ? hc[k + 1] : ic[k + 1]) : ye;
        const float l_w = k > 0 ? lc[k - 1] : lw;
        const float l_e = k + 1 < STRIP ? lc[k + 1] : le;
        float s, e;
        cascade(y_u, y_d, y_w, y_e, hc[k], kf[k], s, e);
        const float lo = ((((lu[k] + ld[k]) + l_w) + l_e) - 4.f * lc[k]) + kf[k] * lc[k];
        r[k] = s + (e + lo);
      }
    } else {
      float ic[STRIP], iu[STRIP] = {}, id[STRIP] = {}, b[STRIP];
      load_strip<VEC>(im, j0, W, ic);
      if (up_in) load_strip<VEC>(im - W, j0, W, iu);
      if (down_in) load_strip<VEC>(im + W, j0, W, id);
      const float iw = west ? im[j0 - 1] : 0.f;
      const float ie = east ? im[j0 + STRIP] : 0.f;
#pragma unroll
      for (int k = 0; k < STRIP; ++k) {
        r[k] = b[k] = 0.f;
        if (!bit(k)) continue;
        const float t_w = k > 0 ? ic[k - 1] : iw;
        const float t_e = k + 1 < STRIP ? ic[k + 1] : ie;
        float s, e;
        cascade(iu[k], id[k], t_w, t_e, ic[k], kf[k], s, e);
        r[k] = s + e;
        // the known neighbours' values (unknown or outside: 0)
        b[k] = (((bit(UP + k) ? 0.f : iu[k]) + (bit(DOWN + k) ? 0.f : id[k])) +
                (unk_w(k) ? 0.f : t_w)) +
               (unk_e(k) ? 0.f : t_e);
      }
      store_strip<VEC>(b_out + at, j0, W, b);
    }
    store_strip<VEC>(r_out + at, j0, W, r);
  }
}

// the fewest band groups (the most bands a block, so invm is read the
// fewest times) that still give BLOCKS_PER_SM blocks an SM
cudaError_t band_groups(int C, long long tiles, int* groups) {
  static int sms = 0;  // the same for every card of a host
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  for (*groups = 1; *groups < C; ++*groups) {
    if (tiles * *groups >= (long long)BLOCKS_PER_SM * sms) break;
  }
  return cudaSuccess;
}

template <typename TI, bool PAIR>
cudaError_t launch(bool vec, const float* img, const float* xhi, const float* xlo, const TI* invm,
                   float* r_out, float* b_out, int C, int H, int W, cudaStream_t stream) {
  const unsigned gx = ((W + STRIP - 1) / STRIP + BX - 1) / BX;
  const unsigned gy = (H + BY - 1) / BY;
  int groups = 1;
  const cudaError_t err = band_groups(C, (long long)gx * gy, &groups);
  if (err != cudaSuccess) return err;
  const dim3 grid(gx, gy, groups);
  const dim3 block(BX, BY);
  if (vec) {
    residual_kernel<TI, PAIR, true>
        <<<grid, block, 0, stream>>>(img, xhi, xlo, invm, r_out, b_out, C, H, W);
  } else {
    residual_kernel<TI, PAIR, false>
        <<<grid, block, 0, stream>>>(img, xhi, xlo, invm, r_out, b_out, C, H, W);
  }
  return cudaGetLastError();
}

template <typename TI>
cudaError_t dispatch(int pair, const void* img, const void* xhi, const void* xlo,
                     const void* invm, void* r_out, void* b_out, int C, int H, int W,
                     cudaStream_t s) {
  auto aligned = [](const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  // unused operands are null, which counts as aligned
  const bool vec = W % STRIP == 0 && aligned(img, 16) && aligned(xhi, 16) && aligned(xlo, 16) &&
                   aligned(r_out, 16) && aligned(b_out, 16) && aligned(invm, STRIP * sizeof(TI));
  const float* im = static_cast<const float*>(img);
  const float* xh = static_cast<const float*>(xhi);
  const float* xl = static_cast<const float*>(xlo);
  const TI* iv = static_cast<const TI*>(invm);
  float* r = static_cast<float*>(r_out);
  float* b = static_cast<float*>(b_out);
  if (pair) return launch<TI, true>(vec, im, xh, xl, iv, r, b, C, H, W, s);
  return launch<TI, false>(vec, im, xh, xl, iv, r, b, C, H, W, s);
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
    return (int)dispatch<float>(pair, img, xhi, xlo, invm, r_out, b_out, C, H, W, s);
  if (invm_dtype == 1)
    return (int)dispatch<__nv_bfloat16>(pair, img, xhi, xlo, invm, r_out, b_out, C, H, W, s);
  return (int)cudaErrorInvalidValue;
}
