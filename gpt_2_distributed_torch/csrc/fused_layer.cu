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
// What bounds them on the H100: bytes. Every kernel does a few tens of
// operations per element (the hash, a LayerNorm or a tanh) against 4-6
// bytes moved, far below the ~20 fp32 operations a byte the card can do.
// At 124M, batch 4 x 1024 (N = 4096 rows, C = 768, F = 3072), each input
// read once and each output written once: K4 forward 25.2 MB (7.5 us at
// 3.35 TB/s), K4 backward 31.5 MB, K5 18.9 MB, K5's rescale 12.6 MB, K6
// forward 50.3 MB, K6 backward 75.5 MB.
//
// Design: every element is read and written once, with 16-byte loads and
// stores where a row is 16-byte aligned (width % 8 == 0; otherwise element
// loads masked at the width), so any N and any width are taken.
//   * K4 runs one warp per row: the row (C <= 2048) sits in the warp's
//     registers, eight features a lane per 256-feature stride, and the
//     row sums are __shfl_xor reductions.
//   * K5, its rescale and K6's forward run one thread per eight features
//     of a row.
//   * dscale, dbias (K4) and db (K6) are sums over every row. The TPU
//     kernels accumulate them across a sequential grid; Hopper blocks run
//     in no order, so each block writes fp32 partial sums of its rows and
//     a second kernel adds the partials in a fixed order, one thread per
//     column. No atomics: two launches give bit-identical grads.
// Faster versions (fewer column partials, a wider K4 block) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "dropout_hash.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;          // warps a block in K4's kernels
constexpr int EW_THREADS = 256;   // threads a block in the elementwise kernels
constexpr int COL_THREADS = 128;  // threads a block in the column kernels
constexpr float GELU_C0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float GELU_A = 0.044715f;
constexpr float GELU_3A = 0.134145f;            // 3 * GELU_A

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

// ---------------------------------------------------------------------------
// K4: r = x + dropout(o); y = LayerNorm(r) * scale + bias. One warp a row.
// ---------------------------------------------------------------------------

template <int VPL>
__global__ void __launch_bounds__(WARPS * 32) ln_res_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ o,
    const float* __restrict__ scale, const float* __restrict__ bias,
    bf16* __restrict__ r, bf16* __restrict__ y, float* __restrict__ mean,
    float* __restrict__ rstd, int N, int C, float eps, Dropout drop, bool vec) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= N) return;  // the whole warp: row is warp-uniform
  const size_t base = (size_t)row * C;
  const unsigned hr = drop.row_part(row);
  float v[VPL][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c >= C) continue;
    float xv[8], ov[8];
    load8(x + base, c, C, vec, xv);
    load8(o + base, c, C, vec, ov);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float od = ov[j];
      if (drop.on) od = drop.kept(hr, c + j) ? round_bf16(od / drop.keep) : 0.f;
      v[i][j] = round_bf16(xv[j] + od);  // zero past C
      sum += v[i][j];
    }
    store8(r + base, c, C, vec, v[i]);
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

// K4 backward: rhat = (r - mean) rstd, g = dy * scale,
//   dr_tot = dr + rstd (g - mean_C(g) - rhat mean_C(g rhat)),
//   dx = dr_tot, do = keep * dr_tot / kp;
// and this block's fp32 partial sums of dy * rhat and dy over its rows,
// into partial[blockIdx.x][2][C]. Each warp sums its rows in registers; the
// warps' sums are added in shared memory in warp order.
template <int VPL>
__global__ void __launch_bounds__(WARPS * 32) ln_res_bwd_kernel(
    const bf16* __restrict__ r, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ scale,
    const bf16* __restrict__ dr, const bf16* __restrict__ dy,
    bf16* __restrict__ dx, bf16* __restrict__ d_o, float* __restrict__ partial,
    int N, int C, int rows_per_block, Dropout drop, bool vec) {
  extern __shared__ float red[];  // [2][C]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float ds[VPL][8], db[VPL][8];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) ds[i][j] = db[i][j] = 0.f;

  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(row0 + rows_per_block, N);
  for (int row = row0 + warp; row < row_end; row += WARPS) {
    const size_t base = (size_t)row * C;
    const float mu = mean[row];
    const float rs = rstd[row];
    float rh[VPL][8], g[VPL][8];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c >= C) continue;
      float rv[8], dyv[8], sc[8];
      load8(r + base, c, C, vec, rv);
      load8(dy + base, c, C, vec, dyv);
      load8(scale, c, C, vec, sc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = c + j < C;
        rh[i][j] = in ? (rv[j] - mu) * rs : 0.f;
        g[i][j] = dyv[j] * sc[j];  // zero past C
        m1 += g[i][j];
        m2 += g[i][j] * rh[i][j];
        ds[i][j] += dyv[j] * rh[i][j];
        db[i][j] += dyv[j];
      }
    }
    m1 = warp_sum(m1) / (float)C;
    m2 = warp_sum(m2) / (float)C;
    const unsigned hr = drop.row_part(row);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c >= C) continue;
      float drv[8], dov[8];
      load8(dr + base, c, C, vec, drv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t = drv[j] + rs * (g[i][j] - m1 - rh[i][j] * m2);
        drv[j] = t;
        dov[j] = drop.on ? (drop.kept(hr, c + j) ? t / drop.keep : 0.f) : t;
      }
      store8(dx + base, c, C, vec, drv);
      store8(d_o + base, c, C, vec, dov);
    }
  }

  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = (lane + 32 * i) * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c + j >= C) continue;
          red[c + j] = w ? red[c + j] + ds[i][j] : ds[i][j];
          red[C + c + j] = w ? red[C + c + j] + db[i][j] : db[i][j];
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.x * 2 * C;
  for (int k = threadIdx.x; k < 2 * C; k += blockDim.x) out[k] = red[k];
}

// The second pass of every column sum: out[c] = sum over p of
// partial[p][c], p in order, one thread a column; fp32 or bf16 out.
__global__ void column_sum_kernel(const float* __restrict__ partial, int P,
                                  int W, float* __restrict__ out32,
                                  bf16* __restrict__ out16) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= W) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[(size_t)p * W + c];
  if (out16)
    out16[c] = __float2bfloat16(s);
  else
    out32[c] = s;
}

// ---------------------------------------------------------------------------
// K5: r = x + dropout(o), and the backward's do = keep * dr / kp. One
// thread per 8 features of a row.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(EW_THREADS) res_drop_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ o,
    bf16* __restrict__ r, int N, int C, Dropout drop, bool vec) {
  const int CV = (C + 7) / 8;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= (long long)N * CV) return;
  const int row = (int)(v / CV);
  const int c = (int)(v % CV) * 8;
  const size_t base = (size_t)row * C;
  float xv[8], ov[8];
  load8(x + base, c, C, vec, xv);
  load8(o + base, c, C, vec, ov);
  const unsigned hr = drop.row_part(row);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float od = ov[j];
    if (drop.on) od = drop.kept(hr, c + j) ? round_bf16(od / drop.keep) : 0.f;
    xv[j] += od;
  }
  store8(r + base, c, C, vec, xv);
}

__global__ void __launch_bounds__(EW_THREADS) drop_scale_kernel(
    const bf16* __restrict__ dr, bf16* __restrict__ d_o, int N, int C,
    Dropout drop, bool vec) {
  const int CV = (C + 7) / 8;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= (long long)N * CV) return;
  const int row = (int)(v / CV);
  const int c = (int)(v % CV) * 8;
  const size_t base = (size_t)row * C;
  float dv[8];
  load8(dr + base, c, C, vec, dv);
  const unsigned hr = drop.row_part(row);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (drop.on) dv[j] = drop.kept(hr, c + j) ? dv[j] / drop.keep : 0.f;
  store8(d_o + base, c, C, vec, dv);
}

// ---------------------------------------------------------------------------
// K6: out = dropout(gelu_tanh(u)), u = bf16(h + b), the GELU in fp32.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float gelu_tanh_inner(float u) {
  return tanhf(GELU_C0 * (u + GELU_A * u * u * u));
}

__global__ void __launch_bounds__(EW_THREADS) bias_gelu_fwd_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ b,
    bf16* __restrict__ out, int N, int F, Dropout drop, bool vec) {
  const int FV = (F + 7) / 8;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= (long long)N * FV) return;
  const int row = (int)(v / FV);
  const int c = (int)(v % FV) * 8;
  const size_t base = (size_t)row * F;
  float hv[8], bv[8];
  load8(h + base, c, F, vec, hv);
  load8(b, c, F, vec, bv);
  const unsigned hr = drop.row_part(row);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float u = round_bf16(hv[j] + bv[j]);
    float g = 0.5f * u * (1.f + gelu_tanh_inner(u));
    if (drop.on) g = drop.kept(hr, c + j) ? g / drop.keep : 0.f;
    hv[j] = g;
  }
  store8(out + base, c, F, vec, hv);
}

// K6 backward over a tile of rows_per_tile rows x 8 features a thread:
// dh = dg * gelu'(u) with dg = keep * dout / kp, and the tile's fp32 sums
// of dh's fp32 values, into partial[blockIdx.y][F].
__global__ void __launch_bounds__(COL_THREADS) bias_gelu_bwd_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ b,
    const bf16* __restrict__ dout, bf16* __restrict__ dh,
    float* __restrict__ partial, int N, int F, int rows_per_tile,
    Dropout drop, bool vec) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (c >= F) return;
  const int row0 = blockIdx.y * rows_per_tile;
  const int row_end = min(row0 + rows_per_tile, N);
  float bv[8], acc[8];
  load8(b, c, F, vec, bv);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int row = row0; row < row_end; ++row) {
    const size_t base = (size_t)row * F;
    float hv[8], dv[8];
    load8(h + base, c, F, vec, hv);
    load8(dout + base, c, F, vec, dv);
    const unsigned hr = drop.row_part(row);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float u = round_bf16(hv[j] + bv[j]);
      const float t = gelu_tanh_inner(u);
      const float gp = 0.5f * (1.f + t)
                       + 0.5f * u * (1.f - t * t) * GELU_C0 * (1.f + GELU_3A * u * u);
      float dg = dv[j];
      if (drop.on) dg = drop.kept(hr, c + j) ? dg / drop.keep : 0.f;
      const float du = dg * gp;  // zero past F: dout is
      hv[j] = du;
      acc[j] += du;
    }
    store8(dh + base, c, F, vec, hv);
  }
  float* out = partial + (size_t)blockIdx.y * F;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (c + j < F) out[c + j] = acc[j];
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

template <int VPL>
void ln_fwd(const void* x, const void* o, const void* scale, const void* bias,
            void* r, void* y, void* mean, void* rstd, int N, int C, float eps,
            Dropout d, bool vec, cudaStream_t s) {
  ln_res_fwd_kernel<VPL><<<grid_1d(N, WARPS), WARPS * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(o),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<bf16*>(r), static_cast<bf16*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), N, C, eps, d, vec);
}

template <int VPL>
void ln_bwd(const void* r, const void* mean, const void* rstd,
            const void* scale, const void* dr, const void* dy, void* dx,
            void* d_o, void* partial, int N, int C, int rows_per_block,
            Dropout d, bool vec, cudaStream_t s) {
  ln_res_bwd_kernel<VPL><<<grid_1d(N, rows_per_block), WARPS * 32,
                           2 * C * sizeof(float), s>>>(
      static_cast<const bf16*>(r), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(scale),
      static_cast<const bf16*>(dr), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dx), static_cast<bf16*>(d_o),
      static_cast<float*>(partial), N, C, rows_per_block, d, vec);
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

// K4 forward: r, y [N, C] bf16; mean, rstd [N] fp32. C <= 2048.
extern "C" int ln_res_fwd_bf16(const void* x, const void* o, const void* scale,
                               const void* bias, void* r, void* y, void* mean,
                               void* rstd, int N, int C, float eps,
                               unsigned seed, unsigned salt, unsigned threshold,
                               float keep, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  const Dropout d = make_dropout(seed, salt, threshold, keep);
  const bool vec = vectorized(C, {x, o, scale, bias, r, y});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LN_FWD(V) ln_fwd<V>(x, o, scale, bias, r, y, mean, rstd, N, C, eps, d, vec, s)
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
#define LN_BWD(V) ln_bwd<V>(r, mean, rstd, scale, dr, dy, dx, d_o, partial, N, C, \
                            rows_per_block, d, vec, s)
  DISPATCH_VPL(vectors_a_lane(C), LN_BWD)
#undef LN_BWD
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  column_sum_kernel<<<grid_1d(2 * C, COL_THREADS), COL_THREADS, 0, s>>>(
      static_cast<const float*>(partial), grid_1d(N, rows_per_block), 2 * C,
      static_cast<float*>(dscale_dbias), nullptr);
  return (int)cudaGetLastError();
}

// K5 forward: r [N, C] bf16.
extern "C" int res_drop_fwd_bf16(const void* x, const void* o, void* r, int N,
                                 int C, unsigned seed, unsigned salt,
                                 unsigned threshold, float keep, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  const long long threads = (long long)N * ((C + 7) / 8);
  res_drop_fwd_kernel<<<grid_1d(threads, EW_THREADS), EW_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(o),
      static_cast<bf16*>(r), N, C, make_dropout(seed, salt, threshold, keep),
      vectorized(C, {x, o, r}));
  return (int)cudaGetLastError();
}

// K5's backward rescale: do [N, C] bf16 from dr.
extern "C" int drop_scale_bf16(const void* dr, void* d_o, int N, int C,
                               unsigned seed, unsigned salt, unsigned threshold,
                               float keep, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  const long long threads = (long long)N * ((C + 7) / 8);
  drop_scale_kernel<<<grid_1d(threads, EW_THREADS), EW_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dr), static_cast<bf16*>(d_o), N, C,
      make_dropout(seed, salt, threshold, keep), vectorized(C, {dr, d_o}));
  return (int)cudaGetLastError();
}

// K6 forward: out [N, F] bf16; b [F] bf16.
extern "C" int bias_gelu_fwd_bf16(const void* h, const void* b, void* out,
                                  int N, int F, unsigned seed, unsigned salt,
                                  unsigned threshold, float keep, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  const long long threads = (long long)N * ((F + 7) / 8);
  bias_gelu_fwd_kernel<<<grid_1d(threads, EW_THREADS), EW_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), N, F, make_dropout(seed, salt, threshold, keep),
      vectorized(F, {h, b, out}));
  return (int)cudaGetLastError();
}

// K6 backward: dh [N, F] bf16, db [F] bf16; partial: fp32 scratch of
// ceil(N / rows_per_tile) x F.
extern "C" int bias_gelu_bwd_bf16(const void* h, const void* b,
                                  const void* dout, void* dh, void* partial,
                                  void* db, int N, int F, int rows_per_tile,
                                  unsigned seed, unsigned salt,
                                  unsigned threshold, float keep, void* stream) {
  if (N == 0 || rows_per_tile < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = grid_1d(N, rows_per_tile);
  const dim3 grid(grid_1d((F + 7) / 8, COL_THREADS), tiles);
  bias_gelu_bwd_kernel<<<grid, COL_THREADS, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(b),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dh),
      static_cast<float*>(partial), N, F, rows_per_tile,
      make_dropout(seed, salt, threshold, keep), vectorized(F, {h, b, dout, dh}));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  column_sum_kernel<<<grid_1d(F, COL_THREADS), COL_THREADS, 0, s>>>(
      static_cast<const float*>(partial), tiles, F, nullptr, static_cast<bf16*>(db));
  return (int)cudaGetLastError();
}
