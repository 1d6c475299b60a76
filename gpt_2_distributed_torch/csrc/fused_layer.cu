// Fused layer epilogues for Hopper (sm_90a): K4, K5 and K6 of the port,
// bf16 activations in and out, fp32 arithmetic.
//
// Replaces, in gpt_2_distributed_tpu/ops/fused_layer.py:
//   K4 _ln_res_fwd_kernel / _ln_res_bwd_kernel:  r = x + dropout(o);
//      y = LayerNorm(r), saving each row's mean and rstd; the backward
//      gives dx, do, dscale and dbias;
//   K5 _res_drop_fwd_kernel:  r = x + dropout(o), and the backward's mask
//      rescale do = keep * dr / kp (XLA elementwise code there; here a
//      kernel, as a plain-torch version would hash the mask in int64);
//   K6 _bias_gelu_fwd_kernel / _bias_gelu_bwd_kernel:
//      out = dropout(gelu_tanh(h + b)); the backward gives dh and db.
// The masks are dropout_hash_bits(seed, 0, salt, row, col) >= threshold
// (csrc/dropout_hash.cuh) on the absolute flattened row and the feature,
// the TPU kernels' stream bit for bit; the backward rehashes them, so no
// mask is ever stored.
//
// Where the TPU kernels round, these do too: the forward's dropped o is
// o / kp rounded to bf16 with kp = bf16(1 - rate) (a bf16 operand over a
// weakly typed float), r = x + o is rounded to bf16 and the LayerNorm
// statistics are taken from that bf16 r in fp32 (the mean, then the mean
// of the squared centered values); K6 adds h + b in bf16 before the fp32
// GELU; the backward divisions and K6's forward one are fp32.
//
// What bounds them on the H100: bytes, if enough loads are in flight and
// the instructions an element costs stay under them. At 124M, batch 4 x
// 1024 (N = 4096 rows, C = 768, F = 3072), each input read once and each
// output written once: K4 forward 25.2 MB (7.5 us at 3.35 TB/s), K4
// backward 31.5 MB, K5 18.9 MB, K5's rescale 12.6 MB, K6 forward 50.3 MB
// (15.0 us), K6 backward 75.5 MB (22.5 us). K6 does the most work an
// element (the hash, a GELU and in the backward its derivative: 25-40
// instructions, two of them MUFU), which the 132 SMs issue in less than
// its byte time; so its design keeps the instructions few and the loads
// many in flight (on an H100 SXM it moves ~2.0 TB/s forward and ~2.4 in
// the backward's rows pass, the rates of PyTorch's own elementwise GELU
// kernels there).
//
// Design: every element is read and written once, with 16-byte loads and
// stores where a row is 16-byte aligned (width % 8 == 0; otherwise element
// loads masked at the width), so any N and any width are taken; row and
// column indices are 32-bit, with no division.
//   * K4's forward runs one warp a row: the row (C <= 2048) sits in the
//     warp's registers, eight features a lane per 256-feature stride, and
//     the row sums are __shfl_xor reductions. The rows are spread over
//     contiguous strips (the wrapper's rows_per_block, a function of N
//     only) of one row a warp up to N = 4224, so at 124M's N = 4096 all
//     rows are in flight at once, four 8-warp blocks an SM at ~50
//     registers (a warp walking two rows with the next row's loads in
//     flight, or scale and bias in shared memory, read slower there); kept
//     values are divided by keep as K6 divides (below)
//     with the sign of o copied onto the quotient (div_keep makes -0 +0),
//     which rounded to bf16 is the IEEE quotient rounded to bf16. A null o
//     stands for o = 0 (serving's LayerNorm): no o loads and no r.
//   * K4's backward spreads the rows over at most one 8-warp block an SM
//     (the wrapper's rows_per_block, a function of N only): each block a
//     contiguous strip, each warp two rows at a time (C <= 1024) with the
//     loads of r, dy and dr of both in flight together; its column sums
//     and scale sit in shared memory, so the registers hold the rows.
//   * K5 and its rescale run a 2-D block shaped to the width (ew_block:
//     whole warps along a row's 8-feature vectors, at C = 768 96 threads,
//     two rows of them a block), a thread 8 features of a row with its
//     loads issued before the math, at 32 registers (8 blocks an SM); row
//     and column come from the grid, which is a function of N and C only.
//     Two or four rows a thread read slower on the H100 (more registers,
//     fewer warps; PERF.md). They divide a kept value as K4's forward does
//     (div_keep, the dividend's sign copied on), which rounded to bf16 is
//     the IEEE quotient rounded to bf16.
//   * K6 takes its GELU in sigmoid form, 0.5 (1 + tanh z) = 1 / (1 +
//     2^(-2 z log2 e)): one ex2 and one reciprocal (MUFU, approximate, by
//     name: the shared flags have no fast math), no 1 + t cancellation in
//     the negative tail; it adds h + b as bf16 pairs, and divides by keep
//     as a product with the host's fp32 1 / keep and one fma correction
//     instead of div.rn, with the dividend's sign copied onto the quotient
//     (the fma turns -0 into +0, where the TPU kernels keep -0: at u = -0
//     in the forward, dout = -0 in the backward). Its forward runs a 2-D
//     grid (8-feature vectors in x, rows in y), each thread the same
//     columns of GF_ROWS rows, their loads issued before the math and the
//     bias loaded once, at 40 registers (12 blocks an SM). Its backward
//     gives each block a contiguous strip of rows (a function of N only,
//     as K4's) and a 256-feature slab, a lane 8 features, the 8 warps the
//     strip's rows in turn with the next row's h and dout loads in flight
//     while the current one computes; each lane keeps its column sums in
//     registers.
//   * dscale, dbias (K4) and db (K6) are sums over every row. The TPU
//     kernels accumulate them across a sequential grid; Hopper blocks run
//     in no order, so each block adds its warps' sums as a fixed-order tree
//     in shared memory and writes one fp32 partial row, and one second pass
//     for both, column_sum_kernel, gives each 32 columns 8 warps, each
//     summing a fixed share of the partials, then a fixed-order tree.
//     No atomics: two launches give bit-identical grads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "dropout_hash.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;          // warps a block in K4's and K6's backward
constexpr int EW_THREADS = 256;   // most threads a block in K5's kernels
constexpr int EW_MIN_BLOCKS = 8;  // blocks an SM K5's kernels are built for (32 registers)
constexpr int GF_THREADS = 128;   // threads a block in K6's forward
constexpr int GF_ROWS = 2;        // rows a thread in K6's forward
constexpr int GF_MIN_BLOCKS = 12; // blocks an SM K6's forward is built for (40 registers)
constexpr int GB_MIN_BLOCKS = 3;  // blocks an SM K6's backward is built for

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Elements [c, c + 8) of a row of width n as fp32, zeros at and past n;
// c < n. `vec`: n % 8 == 0 and the row is 16-byte aligned, so one load.
__device__ __forceinline__ void load8(const bf16* p, int c, int n, bool vec,
                                      float* v) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c + j < n ? __bfloat162float(p[c + j]) : 0.f;
  }
}

__device__ __forceinline__ void load8(const float* p, int c, int n, bool vec,
                                      float* v) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p + c);
    const float4 b = *reinterpret_cast<const float4*>(p + c + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c + j < n ? p[c + j] : 0.f;
  }
}

// Stores v[0, 8) rounded to bf16 at [c, c + 8), masked at n.
__device__ __forceinline__ void store8(bf16* p, int c, int n, bool vec,
                                       const float* v) {
  if (vec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p + c) = u;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c + j < n) p[c + j] = __float2bfloat16(v[j]);
  }
}

// Elements [c, c + 8) of a bf16 row of width n, packed as they lie in
// memory, zeros at and past n; c < n.
__device__ __forceinline__ uint4 load8_raw(const bf16* p, int c, int n, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p + c);
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = c + j < n ? p[c + j] : __float2bfloat16(0.f);
  return u;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// A lane's 8 floats as two float4 32 apart in shared memory (t[0], t[32]),
// so a warp's stores and loads of either half are contiguous; and back.
__device__ __forceinline__ void put8(float4* t, const float* v) {
  t[0] = make_float4(v[0], v[1], v[2], v[3]);
  t[32] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void get8(float* v, const float4* t) {
  const float4 a = t[0], b = t[32];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// v / keep: the product with rkeep = fp32(1 / keep), formed on the host,
// and one fma correction of its remainder (none where the product
// overflows, which the remainder would turn into NaN).
__device__ __forceinline__ float div_keep(float v, float keep, float rkeep) {
  const float q = v * rkeep;
  return isinf(q) ? q : fmaf(fmaf(-q, keep, v), rkeep, q);
}

// div_keep with v's sign: the correction turns -0 into +0, and the TPU
// kernels' true division keeps -0.
__device__ __forceinline__ float div_keep_signed(float v, float keep, float rkeep) {
  return copysignf(div_keep(v, keep, rkeep), v);
}

// ---------------------------------------------------------------------------
// K4: r = x + dropout(o); y = LayerNorm(r) * scale + bias.
// ---------------------------------------------------------------------------

// Block blockIdx.x takes the contiguous strip of rows_per_block rows from
// blockIdx.x * rows_per_block (a function of N only, ln_fwd_strips in
// ops/fused_layer.py: one row a warp up to N = 4224, one wave of blocks at
// four an SM); its warp w takes the strip's rows w, w + WARPS, ... A row's
// arithmetic does not depend on its strip: lane i holds features (i + 32 v)
// * 8 .. + 8, the sums are the same __shfl_xor trees, so a row's bits are
// the same in any launch. o == nullptr (then r == nullptr) stands for o =
// 0: no o loads, no r store, y as with o = 0.
template <int VPL>
__global__ void __launch_bounds__(WARPS * 32) ln_res_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ o,
    const float* __restrict__ scale, const float* __restrict__ bias,
    bf16* __restrict__ r, bf16* __restrict__ y, float* __restrict__ mean,
    float* __restrict__ rstd, int N, int C, int rows_per_block, float eps,
    Dropout drop, float rkeep, bool vec) {
  const int lane = threadIdx.x % 32;
  const bool has_o = o != nullptr;
  const int row_end = min((int)(blockIdx.x + 1) * rows_per_block, N);
  for (int row = (int)blockIdx.x * rows_per_block + (int)threadIdx.x / 32; row < row_end;
       row += WARPS) {
    const size_t base = (size_t)row * C;
    const unsigned hr = drop.row_part(row);
    float v[VPL][8];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c >= C) continue;
      float xv[8], ov[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      load8(x + base, c, C, vec, xv);
      if (has_o) load8(o + base, c, C, vec, ov);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float od = ov[j];
        if (has_o && drop.on)
          od = drop.kept(hr, c + j)
                   ? round_bf16(div_keep_signed(od, drop.keep, rkeep))
                   : 0.f;
        v[i][j] = round_bf16(xv[j] + od);  // zero past C
        sum += v[i][j];
      }
      if (has_o) store8(r + base, c, C, vec, v[i]);
    }
    const float mu = warp_sum(sum) / (float)C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c >= C) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mu;
        if (c + j < C) sq += d * d;
      }
    }
    const float rs = rsqrtf(warp_sum(sq) / (float)C + eps);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c >= C) continue;
      float sc[8], bi[8], yv[8];
      load8(scale, c, C, vec, sc);
      load8(bias, c, C, vec, bi);
#pragma unroll
      for (int j = 0; j < 8; ++j) yv[j] = (v[i][j] - mu) * rs * sc[j] + bi[j];
      store8(y + base, c, C, vec, yv);
    }
    if (lane == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
}

// K4 backward: rhat = (r - mean) rstd, g = dy * scale,
//   dr_tot = dr + rstd (g - mean_C(g) - rhat mean_C(g rhat)),
//   dx = dr_tot, do = keep * dr_tot / kp;
// and this block's fp32 partial sums of dy * rhat and dy over its rows,
// into partial[blockIdx.x][2][C].
//
// Block blockIdx.x takes the contiguous strip of rows_per_block rows from
// blockIdx.x * rows_per_block; its warp w takes RIF rows at a time, rows
// w * RIF + k * WARPS * RIF + [0, RIF) of the strip, and issues the loads of
// r, dy and dr of all RIF rows at once (dr does not wait for the row sums),
// so RIF rows' loads are in flight a warp. Registers go to those rows:
// scale is copied to shared memory once a block, and each warp adds its
// rows' dy * rhat and dy into its own slot of shared memory, a lane to its
// own columns (no two threads touch one word), in row order. The slots are
// then added as a fixed-order tree by all threads (the upper half of the
// live slots into the lower half, 8 -> 4 -> 2 -> 1), and the block writes
// slot 0 as its partial. Shared memory is laid out [VPL][2 halves][32 lanes]
// of float4, a lane's 8 columns of a vector as two float4 32 apart, so a
// warp's accesses to either half are contiguous.
template <int VPL>
struct LnBwdSmem {
  static constexpr int SLOT = 2 * VPL * 64;  // float4 of a warp's sums
  static constexpr int SCALE = VPL * 64;     // float4 of scale
  static constexpr int BYTES = (WARPS * SLOT + SCALE) * 16;
};

// The column of element e (0..3) of float4 index f of a [VPL][2][32] layout.
__device__ __forceinline__ int layout_col(int f, int e) {
  const int i = f / 64, half = (f / 32) % 2, lane = f % 32;
  return (lane + 32 * i) * 8 + half * 4 + e;
}

template <int VPL, int RIF>
__global__ void __launch_bounds__(WARPS * 32, 1) ln_res_bwd_kernel(
    const bf16* __restrict__ r, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ scale,
    const bf16* __restrict__ dr, const bf16* __restrict__ dy,
    bf16* __restrict__ dx, bf16* __restrict__ d_o, float* __restrict__ partial,
    int N, int C, int rows_per_block, Dropout drop, bool vec) {
  using L = LnBwdSmem<VPL>;
  extern __shared__ float4 smem4[];  // [WARPS] slots of dscale, dbias sums; scale
  float4* sc4 = smem4 + WARPS * L::SLOT;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float4* mine = smem4 + warp * L::SLOT + lane;  // this lane's columns of its warp's slot
  for (int f = threadIdx.x; f < L::SCALE; f += WARPS * 32) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = layout_col(f, e);
      v[e] = c < C ? scale[c] : 0.f;
    }
    sc4[f] = make_float4(v[0], v[1], v[2], v[3]);
  }
#pragma unroll
  for (int i = 0; i < 2 * VPL; ++i) mine[i * 64] = mine[i * 64 + 32] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(row0 + rows_per_block, N);
  for (int rk = row0 + warp * RIF; rk < row_end; rk += WARPS * RIF) {
    uint4 rv[RIF][VPL], dyv[RIF][VPL], drv[RIF][VPL];
    float mu[RIF], rs[RIF];
#pragma unroll
    for (int k = 0; k < RIF; ++k) {
      if (rk + k >= row_end) continue;
      const size_t base = (size_t)(rk + k) * C;
      mu[k] = mean[rk + k];
      rs[k] = rstd[rk + k];
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = (lane + 32 * i) * 8;
        if (c >= C) continue;
        rv[k][i] = load8_raw(r + base, c, C, vec);
        dyv[k][i] = load8_raw(dy + base, c, C, vec);
        drv[k][i] = load8_raw(dr + base, c, C, vec);
      }
    }
#pragma unroll
    for (int k = 0; k < RIF; ++k) {
      const int row = rk + k;
      if (row >= row_end) continue;
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = (lane + 32 * i) * 8;
        if (c >= C) continue;
        float rf[8], dyf[8], sc[8], dsv[8], dbv[8];
        unpack8(rv[k][i], rf);
        unpack8(dyv[k][i], dyf);
        get8(sc, sc4 + i * 64 + lane);
        get8(dsv, mine + i * 64);
        get8(dbv, mine + (VPL + i) * 64);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float rh = c + j < C ? (rf[j] - mu[k]) * rs[k] : 0.f;
          const float g = dyf[j] * sc[j];  // zero past C
          m1 += g;
          m2 += g * rh;
          dsv[j] += dyf[j] * rh;
          dbv[j] += dyf[j];
        }
        put8(mine + i * 64, dsv);
        put8(mine + (VPL + i) * 64, dbv);
      }
      m1 = warp_sum(m1) / (float)C;
      m2 = warp_sum(m2) / (float)C;
      const unsigned hr = drop.row_part(row);
      const size_t base = (size_t)row * C;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = (lane + 32 * i) * 8;
        if (c >= C) continue;
        float rf[8], dyf[8], sc[8], t[8], dov[8];
        unpack8(rv[k][i], rf);
        unpack8(dyv[k][i], dyf);
        unpack8(drv[k][i], t);
        get8(sc, sc4 + i * 64 + lane);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float rh = c + j < C ? (rf[j] - mu[k]) * rs[k] : 0.f;
          t[j] = t[j] + rs[k] * (dyf[j] * sc[j] - m1 - rh * m2);
          dov[j] = drop.on ? (drop.kept(hr, c + j) ? t[j] / drop.keep : 0.f) : t[j];
        }
        store8(dx + base, c, C, vec, t);
        store8(d_o + base, c, C, vec, dov);
      }
    }
  }

  // The slots as a fixed-order tree, every thread adding float4s.
#pragma unroll
  for (int half = WARPS / 2; half > 0; half /= 2) {
    __syncthreads();
    for (int f = threadIdx.x; f < half * L::SLOT; f += WARPS * 32) {
      const float4 a = smem4[f], b = smem4[f + half * L::SLOT];
      smem4[f] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * 2 * C;
  for (int f = threadIdx.x; f < L::SLOT; f += WARPS * 32) {
    const int which = f / (VPL * 64);  // 0: dscale, 1: dbias
    const float4 a = smem4[f];
    const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = layout_col(f % (VPL * 64), e);
      if (c < C) out[which * C + c] = v[e];
    }
  }
}

// The second pass of the column sums (K4's dscale and dbias, K6's db):
// out[c] = the sum over p of partial[p][c]. A block takes 32 columns, a
// lane each; its SHARES warps each sum a fixed share of the partial rows
// (p = w, w + SHARES, ...), in order, with the loads of several rows in
// flight; the shares are then added as a fixed-order tree. So W / 32 blocks
// of SHARES warps run at once. fp32 out (K4) or rounded to bf16 (K6).
constexpr int SHARES = 8;

__device__ __forceinline__ void put_sum(float* p, float v) { *p = v; }
__device__ __forceinline__ void put_sum(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(SHARES * 32) column_sum_kernel(
    const float* __restrict__ partial, int P, int W, T* __restrict__ out) {
  __shared__ float share[SHARES][32];
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < W) {
#pragma unroll 4
    for (int p = w; p < P; p += SHARES) s += partial[(size_t)p * W + c];
  }
  share[w][lane] = s;
  __syncthreads();
  if (w != 0 || c >= W) return;
  float t[SHARES];
#pragma unroll
  for (int k = 0; k < SHARES; ++k) t[k] = share[k][lane];
#pragma unroll
  for (int half = SHARES / 2; half > 0; half /= 2)
#pragma unroll
    for (int k = 0; k < half; ++k) t[k] += t[k + half];
  put_sum(out + c, t[0]);
}

// ---------------------------------------------------------------------------
// K5: r = x + dropout(o), and the backward's do = keep * dr / kp.
// ---------------------------------------------------------------------------

// Each thread the 8 features at c of one row at a time: row threadIdx.y of
// its block's band of blockDim.y rows, the bands stepping by gridDim.y.
// Its loads are issued before the math.
__global__ void __launch_bounds__(EW_THREADS, EW_MIN_BLOCKS) res_drop_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ o,
    bf16* __restrict__ r, int N, int C, Dropout drop, float rkeep, bool vec) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (c >= C) return;
  for (int row = blockIdx.y * blockDim.y + threadIdx.y; row < N; row += gridDim.y * blockDim.y) {
    const size_t base = (size_t)row * C;
    const uint4 xv = load8_raw(x + base, c, C, vec), ov = load8_raw(o + base, c, C, vec);
    float v[8], od[8];
    unpack8(xv, v);
    unpack8(ov, od);
    const unsigned hr = drop.row_part(row);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (drop.on)
        od[j] = drop.kept(hr, c + j) ? round_bf16(div_keep_signed(od[j], drop.keep, rkeep))
                                     : 0.f;
      v[j] += od[j];
    }
    store8(r + base, c, C, vec, v);
  }
}

// The same layout over dr alone.
__global__ void __launch_bounds__(EW_THREADS, EW_MIN_BLOCKS) drop_scale_kernel(
    const bf16* __restrict__ dr, bf16* __restrict__ d_o, int N, int C,
    Dropout drop, float rkeep, bool vec) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (c >= C) return;
  for (int row = blockIdx.y * blockDim.y + threadIdx.y; row < N; row += gridDim.y * blockDim.y) {
    const size_t base = (size_t)row * C;
    float v[8];
    unpack8(load8_raw(dr + base, c, C, vec), v);
    const unsigned hr = drop.row_part(row);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (drop.on) v[j] = drop.kept(hr, c + j) ? div_keep_signed(v[j], drop.keep, rkeep) : 0.f;
    store8(d_o + base, c, C, vec, v);
  }
}

// ---------------------------------------------------------------------------
// K6: out = dropout(gelu_tanh(u)), u = bf16(h + b), the GELU in fp32.
// ---------------------------------------------------------------------------

// The GELU in sigmoid form: with z = c0 (u + a u^3),
//   s = 0.5 (1 + tanh z) = 1 / (1 + 2^(u (GELU_K + GELU_KA u^2))),
//   gelu(u) = u s,  gelu'(u) = s + 2 c0 u s (1 - s) (1 + 3 a u^2),
// the derivative's 3 a u u multiplied in the JAX kernel's order, so it
// overflows where the tanh form's does.
constexpr float GELU_K = (float)(-2.0 * 1.4426950408889634 * 0.7978845608028654);
constexpr float GELU_KA = (float)(-2.0 * 1.4426950408889634 * 0.7978845608028654 * 0.044715);
constexpr float GELU_2C0 = (float)(2.0 * 0.7978845608028654);
constexpr float GELU_3A = (float)(3.0 * 0.044715);

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float gelu_sigma(float u) {
  return rcp_approx(1.f + ex2_approx(u * fmaf(GELU_KA, u * u, GELU_K)));
}

__device__ __forceinline__ float gelu_grad(float u, float s) {
  return fmaf(GELU_2C0 * u * s * (1.f - s), fmaf(GELU_3A * u, u, 1.f), s);
}

// u = bf16(h + b) for the 8 packed features of h and b: one bf16x2 add a
// pair (a single rounding of the exact sum, which the fp32 sum rounded to
// bf16 equals: fp32 keeps more than twice bf16's bits), unpacked to fp32.
__device__ __forceinline__ void add_unpack8(const uint4& h, const uint4& b, float* u) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&h);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(__hadd2(h2[j], b2[j]));
    u[2 * j] = f.x;
    u[2 * j + 1] = f.y;
  }
}

// Each thread the 8 features at c of GF_ROWS rows: their h loads all
// issued before the math, the bias loaded once.
__global__ void __launch_bounds__(GF_THREADS, GF_MIN_BLOCKS) bias_gelu_fwd_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ b,
    bf16* __restrict__ out, int N, int F, Dropout drop, float rkeep, bool vec) {
  const int c = (blockIdx.x * GF_THREADS + threadIdx.x) * 8;
  if (c >= F) return;
  const uint4 bv = load8_raw(b, c, F, vec);
  for (int row0 = blockIdx.y * GF_ROWS; row0 < N; row0 += gridDim.y * GF_ROWS) {
    uint4 hv[GF_ROWS];
#pragma unroll
    for (int k = 0; k < GF_ROWS; ++k)
      if (row0 + k < N) hv[k] = load8_raw(h + (size_t)(row0 + k) * F, c, F, vec);
#pragma unroll
    for (int k = 0; k < GF_ROWS; ++k) {
      const int row = row0 + k;
      if (row >= N) break;
      float v[8];
      add_unpack8(hv[k], bv, v);
      const unsigned hr = drop.row_part(row);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float g = v[j] * gelu_sigma(v[j]);
        if (drop.on) g = drop.kept(hr, c + j) ? div_keep_signed(g, drop.keep, rkeep) : 0.f;
        v[j] = g;
      }
      store8(out + (size_t)row * F, c, F, vec, v);
    }
  }
}

// K6 backward over a strip of rows_per_strip rows (blockIdx.y) and a slab
// of 256 features (blockIdx.x), 8 a lane: dh = dg * gelu'(u) with dg =
// keep * dout / kp. Warp w takes the strip's rows w, w + WARPS, ..., with
// the next row's h and dout loads issued before the current row's math,
// and adds its rows' fp32 dh into its lane's column sums in row order. The
// warps' sums are then added as a fixed-order tree in shared memory
// (8 -> 4 -> 2 -> 1) and the block writes them as partial[blockIdx.y][slab].
__global__ void __launch_bounds__(WARPS * 32, GB_MIN_BLOCKS) bias_gelu_bwd_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ b,
    const bf16* __restrict__ dout, bf16* __restrict__ dh,
    float* __restrict__ partial, int N, int F, int rows_per_strip,
    Dropout drop, float rkeep, bool vec) {
  __shared__ float4 sums[WARPS][64];  // a lane's 8 sums as two float4 32 apart
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = (blockIdx.x * 32 + lane) * 8;
  const int row_end = min((int)(blockIdx.y + 1) * rows_per_strip, N);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c < F) {
    const uint4 bv = load8_raw(b, c, F, vec);
    int row = (int)blockIdx.y * rows_per_strip + warp;
    uint4 hc, dc;
    if (row < row_end) {
      hc = load8_raw(h + (size_t)row * F, c, F, vec);
      dc = load8_raw(dout + (size_t)row * F, c, F, vec);
    }
    for (; row < row_end; row += WARPS) {
      uint4 hn, dn;
      if (row + WARPS < row_end) {
        hn = load8_raw(h + (size_t)(row + WARPS) * F, c, F, vec);
        dn = load8_raw(dout + (size_t)(row + WARPS) * F, c, F, vec);
      }
      float u[8], dv[8];
      add_unpack8(hc, bv, u);
      unpack8(dc, dv);
      const unsigned hr = drop.row_part(row);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float gp = gelu_grad(u[j], gelu_sigma(u[j]));
        float dg = dv[j];
        if (drop.on) dg = drop.kept(hr, c + j) ? div_keep_signed(dg, drop.keep, rkeep) : 0.f;
        const float du = dg * gp;  // zero past F: dout is
        dv[j] = du;
        acc[j] += du;
      }
      store8(dh + (size_t)row * F, c, F, vec, dv);
      hc = hn;
      dc = dn;
    }
  }
  put8(&sums[warp][lane], acc);
#pragma unroll
  for (int half = WARPS / 2; half > 0; half /= 2) {
    __syncthreads();
    if (warp < half) {
      float o[8];
      get8(o, &sums[warp + half][lane]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += o[j];
      if (half > 1) put8(&sums[warp][lane], acc);
    }
  }
  if (warp != 0 || c >= F) return;
  float* out = partial + (size_t)blockIdx.y * F;
  if (vec) {
    *reinterpret_cast<float4*>(out + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(out + c + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c + j < F) out[c + j] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// 16-byte rows: the width is a multiple of 8 and every base is aligned.
bool vectorized(int width, std::initializer_list<const void*> ptrs) {
  if (width % 8) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

int vectors_a_lane(int C) { return ((C + 7) / 8 + 31) / 32; }

int grid_1d(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

// K5's block: whole warps along a row's (C + 7) / 8 vectors, split into as
// few block columns as EW_THREADS allows (C = 768: 96 threads; 1600: 224),
// and as many rows of them as fit in EW_THREADS (768: 2; 1600: 1).
dim3 ew_block(int C) {
  const int vectors = (C + 7) / 8;
  const int x = 32 * grid_1d(grid_1d(vectors, grid_1d(vectors, EW_THREADS)), 32);
  return dim3(x, EW_THREADS / x);
}

// K5's grid: the block columns of a row, and bands of block.y rows (a band a
// block up to 65535 of them).
dim3 ew_grid(int N, int C, dim3 block) {
  return dim3(grid_1d((C + 7) / 8, block.x), std::min(grid_1d(N, block.y), 65535));
}

template <int VPL>
void ln_fwd(const void* x, const void* o, const void* scale, const void* bias,
            void* r, void* y, void* mean, void* rstd, int N, int C,
            int rows_per_block, float eps, Dropout d, float rkeep, bool vec,
            cudaStream_t s) {
  ln_res_fwd_kernel<VPL><<<grid_1d(N, rows_per_block), WARPS * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(o),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<bf16*>(r), static_cast<bf16*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), N, C, rows_per_block, eps, d, rkeep, vec);
}

// Rows a warp keeps in flight: two up to C = 1024, where their registers
// fit, else one.
constexpr int rows_in_flight(int vpl) { return vpl <= 4 ? 2 : 1; }

template <int VPL>
int ln_bwd(const void* r, const void* mean, const void* rstd, const void* scale,
           const void* dr, const void* dy, void* dx, void* d_o, void* partial,
           void* sums, int N, int C, int rows_per_block, Dropout d, bool vec,
           cudaStream_t s) {
  constexpr int RIF = rows_in_flight(VPL);
  constexpr int smem = LnBwdSmem<VPL>::BYTES;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_res_bwd_kernel<VPL, RIF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int blocks = grid_1d(N, rows_per_block);
  ln_res_bwd_kernel<VPL, RIF><<<blocks, WARPS * 32, smem, s>>>(
      static_cast<const bf16*>(r), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(scale),
      static_cast<const bf16*>(dr), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dx), static_cast<bf16*>(d_o),
      static_cast<float*>(partial), N, C, rows_per_block, d, vec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  column_sum_kernel<float><<<grid_1d(2 * C, 32), SHARES * 32, 0, s>>>(
      static_cast<const float*>(partial), blocks, 2 * C, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

#define DISPATCH_VPL(vpl, call)                      \
  switch (vpl) {                                     \
    case 1: call(1); break;                          \
    case 2: call(2); break;                          \
    case 3: call(3); break;                          \
    case 4: call(4); break;                          \
    case 5: call(5); break;                          \
    case 6: call(6); break;                          \
    case 7: call(7); break;                          \
    case 8: call(8); break;                          \
    default: return (int)cudaErrorInvalidValue;      \
  }

}  // namespace

// Every entry point takes contiguous row-major [N, width] bf16 activations
// (scale, bias, mean, rstd and the column partials fp32), the dropout
// site's seed and salt, its keep threshold (0: no dropout) and the keep
// probability the kept values are divided by, and PyTorch's stream. It
// launches on that stream and returns cudaGetLastError().

// K4 forward: r, y [N, C] bf16; mean, rstd [N] fp32. C <= 2048. o and r
// both null: o = 0, and no r. Strips of rows_per_block rows a block.
extern "C" int ln_res_fwd_bf16(const void* x, const void* o, const void* scale,
                               const void* bias, void* r, void* y, void* mean,
                               void* rstd, int N, int C, int rows_per_block,
                               float eps, unsigned seed, unsigned salt,
                               unsigned threshold, float keep, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  if (rows_per_block < 1 || (o == nullptr) != (r == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dropout d = make_dropout(seed, salt, threshold, keep);
  const bool vec = vectorized(C, {x, o, scale, bias, r, y});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LN_FWD(V) ln_fwd<V>(x, o, scale, bias, r, y, mean, rstd, N, C, rows_per_block, \
                            eps, d, 1.f / keep, vec, s)
  DISPATCH_VPL(vectors_a_lane(C), LN_FWD)
#undef LN_FWD
  return (int)cudaGetLastError();
}

// K4 backward: dx, do [N, C] bf16; dscale_dbias [2 C] fp32 (dscale, then
// dbias); partial: fp32 scratch of ceil(N / rows_per_block) x 2 C.
extern "C" int ln_res_bwd_bf16(const void* r, const void* mean,
                               const void* rstd, const void* scale,
                               const void* dr, const void* dy, void* dx,
                               void* d_o, void* partial, void* dscale_dbias,
                               int N, int C, int rows_per_block, unsigned seed,
                               unsigned salt, unsigned threshold, float keep,
                               void* stream) {
  if (N == 0 || rows_per_block < 1) return (int)cudaErrorInvalidValue;
  const Dropout d = make_dropout(seed, salt, threshold, keep);
  const bool vec = vectorized(C, {r, scale, dr, dy, dx, d_o});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = (int)cudaSuccess;
#define LN_BWD(V) code = ln_bwd<V>(r, mean, rstd, scale, dr, dy, dx, d_o, partial, \
                                   dscale_dbias, N, C, rows_per_block, d, vec, s)
  DISPATCH_VPL(vectors_a_lane(C), LN_BWD)
#undef LN_BWD
  return code;
}

// K5 forward: r [N, C] bf16.
extern "C" int res_drop_fwd_bf16(const void* x, const void* o, void* r, int N,
                                 int C, unsigned seed, unsigned salt,
                                 unsigned threshold, float keep, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  const dim3 block = ew_block(C);
  res_drop_fwd_kernel<<<ew_grid(N, C, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(o),
      static_cast<bf16*>(r), N, C, make_dropout(seed, salt, threshold, keep), 1.f / keep,
      vectorized(C, {x, o, r}));
  return (int)cudaGetLastError();
}

// K5's backward rescale: do [N, C] bf16 from dr.
extern "C" int drop_scale_bf16(const void* dr, void* d_o, int N, int C,
                               unsigned seed, unsigned salt, unsigned threshold,
                               float keep, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  const dim3 block = ew_block(C);
  drop_scale_kernel<<<ew_grid(N, C, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dr), static_cast<bf16*>(d_o), N, C,
      make_dropout(seed, salt, threshold, keep), 1.f / keep, vectorized(C, {dr, d_o}));
  return (int)cudaGetLastError();
}

// K6 forward: out [N, F] bf16; b [F] bf16.
extern "C" int bias_gelu_fwd_bf16(const void* h, const void* b, void* out,
                                  int N, int F, unsigned seed, unsigned salt,
                                  unsigned threshold, float keep, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  const dim3 grid(grid_1d((F + 7) / 8, GF_THREADS), std::min(grid_1d(N, GF_ROWS), 65535));
  bias_gelu_fwd_kernel<<<grid, GF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), N, F, make_dropout(seed, salt, threshold, keep),
      1.f / keep, vectorized(F, {h, b, out}));
  return (int)cudaGetLastError();
}

// K6 backward: dh [N, F] bf16, db [F] bf16; partial: fp32 scratch of
// ceil(N / rows_per_strip) x F.
extern "C" int bias_gelu_bwd_bf16(const void* h, const void* b,
                                  const void* dout, void* dh, void* partial,
                                  void* db, int N, int F, int rows_per_strip,
                                  unsigned seed, unsigned salt,
                                  unsigned threshold, float keep, void* stream) {
  if (N == 0 || rows_per_strip < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int strips = grid_1d(N, rows_per_strip);
  if (strips > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_1d(F, 256), strips);
  bias_gelu_bwd_kernel<<<grid, WARPS * 32, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(b),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dh),
      static_cast<float*>(partial), N, F, rows_per_strip,
      make_dropout(seed, salt, threshold, keep), 1.f / keep,
      vectorized(F, {h, b, dout, dh}));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  column_sum_kernel<bf16><<<grid_1d(F, 32), SHARES * 32, 0, s>>>(
      static_cast<const float*>(partial), strips, F, static_cast<bf16*>(db));
  return (int)cudaGetLastError();
}
