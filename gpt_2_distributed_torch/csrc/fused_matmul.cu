// Fused matmuls for Hopper (sm_90a): K7 of the port, a tiled bf16 GEMM on
// the tensor cores with fp32 accumulators and the epilogues applied to the
// accumulator before its one write-back.
//
// Replaces, in gpt_2_distributed_tpu/ops/fused_matmul.py (one pallas_call
// each, built by _build_matmul):
//   forward  _mm_bias_fwd_kernel   y = x @ w + b
//            _mm_gelu_fwd_kernel   y = dropout(gelu_tanh(u)), u = x @ w + b,
//                                  u also written (the backward's residual)
//            _mm_resid_fwd_kernel  y = r + dropout(x @ w + b)
//   dgrad    _mm_dgrad_kernel, _mm_dgrad_gelu_kernel   dx = du @ w^T
//   wgrad    _mm_wgrad_plain_kernel, _mm_wgrad_gelu_kernel
//                                  dw = x^T @ du, db = sum over rows of du
// where du = keep * dy / (1 - rate) [* gelu'(u)], formed per tile in fp32
// and rounded to bf16 before the product, as the TPU kernels do. The mask
// is dropout_hash_bits(seed, 0, salt, row, col) >= threshold on the
// absolute row of the flattened [N, M] output and the output column
// (csrc/dropout_hash.cuh), so the backward rehashes the forward's mask.
// Roundings, as there: the bias is added to the fp32 accumulator and the
// sum rounded once; the GELU runs in fp32 on the unrounded u; the kept
// values are divided by fp32(1 - rate) (0.9f at rate 0.1, not the bf16
// keep probability K4-K6 divide by); resid adds fp32(r) and rounds once;
// dx and dw are rounded once; db is the fp32 sum of the bf16 du.
//
// Two more epilogues of the same forward serve inference: the unfused
// model's roundings (round(x @ w), then + b in bf16; the JAX package's
// XLA products outside --fused_matmul) and fp32 logits of the tied head,
// h @ wte^T, which reads wte [V, C] as a transposed operand.
//
// What bounds it on the H100: operations. At 124M, batch 4 x 1024 (N =
// 4096, C = 768) the four forward legs do 14.5 to 19.3 GFLOP on 9 to 44 MB
// of operands: 15 to 20 us at 989 TFLOP/s against 3 to 13 us of bytes.
// Decode rows (N = 8) are bound by the weight bytes instead.
//
// Design: one core for three operand layouts. A block computes a 128 x 128
// output tile with 8 warps (2 x 4, a 64 x 32 tile each) from 32-deep
// stages: each thread loads its 16-byte pieces of the next stage into
// registers while the warps multiply the current one out of shared memory
// (ldmatrix, .trans for an operand stored along its output dimension, into
// mma.sync m16n8k16 bf16 with fp32 accumulators), then stores them into
// the other of two shared buffers: one barrier a stage. Shared rows carry
// 16 bytes of padding, so ldmatrix reads no bank twice. Loads are 16 bytes
// where a matrix's rows are (width % 8 == 0 and an aligned base) and
// element loads masked at the edge otherwise; rows and depth past the
// matrix read zeros. So any shape is taken: the 1.5B C = 1600, any row
// count, one-row decode and the head's V = 50257.
//   NN (forward):  x[N, K] @ w[K, M]
//   NT (dgrad, head):  du[N, M] @ w[K, M]^T, h[R, C] @ wte[V, C]^T
//   TN (wgrad):  x[N, K]^T @ du[N, M]
// dgrad forms du while it stores the A stage, wgrad while it stores the B
// stage.
//
// Determinism and batch invariance. No atomics. The forward and dgrad sum
// every output element over the whole depth in one block, stage by stage
// in order, with a tile shape that never changes: a row's result does not
// depend on how many rows share the launch or where the row sits in its
// tile, which is what keeps the serving engine's streams equal to
// one-request decoding. wgrad splits the rows it sums over into a fixed
// number of slices (a function of the shape only, so the 36 output tiles of
// a [768, 768] weight fill the card): each slice writes fp32 partials of
// dw and db (db summed over the slice's rows, in order, by the blocks of
// the first row tile of dw), and a second kernel adds the slices in order
// and rounds dw once. Two launches give the same bits.
// Faster versions (wgmma from TMA-fed stages, a persistent grid, a staged
// epilogue with 16-byte stores) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;       // output rows a block
constexpr int BN = 128;       // output columns a block
constexpr int BK = 32;        // depth a stage
constexpr int PAD = 8;        // bf16 padding a shared row: 16 bytes
constexpr int THREADS = 256;  // 8 warps: 2 along the rows, 4 along the columns
constexpr int SUM_THREADS = 256;
constexpr float GELU_C0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float GELU_A = 0.044715f;

enum Epilogue { EPI_BIAS = 0, EPI_ROUND = 1, EPI_GELU = 2, EPI_RESID = 3, EPI_F32 = 4 };

// A row-major bf16 matrix, rows x cols, leading dimension ld; vec: every
// row is 16-byte aligned (ld % 8 == 0 and an aligned base).
struct Mat {
  const bf16* p;
  int rows, cols;
  long long ld;
  bool vec;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu(float u) {
  return 0.5f * u * (1.f + tanhf(GELU_C0 * (u + GELU_A * u * u * u)));
}

__device__ __forceinline__ float gelu_grad(float u) {
  const float t = tanhf(GELU_C0 * (u + GELU_A * u * u * u));
  return 0.5f * (1.f + t) +
         0.5f * u * (1.f - t * t) * GELU_C0 * (1.f + 3.f * GELU_A * u * u);
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return v;
}

// Elements [c, c + 8) of row r, zeros past the matrix.
__device__ __forceinline__ uint4 load8(const Mat& m, int r, int c) {
  if (r >= m.rows || c >= m.cols) return make_uint4(0u, 0u, 0u, 0u);
  const bf16* p = m.p + (long long)r * m.ld + c;
  if (m.vec && c + 8 <= m.cols) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned short s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = c + j < m.cols ? __bfloat16_as_ushort(p[j]) : 0;
  return make_uint4(s[0] | (unsigned)s[1] << 16, s[2] | (unsigned)s[3] << 16,
                    s[4] | (unsigned)s[5] << 16, s[6] | (unsigned)s[7] << 16);
}

// One stage of one operand: a TR x TC piece of a matrix, held in registers
// between its load and its store to shared memory ([TR][TC + PAD]).
template <int TR, int TC>
struct Stage {
  static constexpr int PER_ROW = TC / 8;
  static constexpr int PER_THREAD = TR * PER_ROW / THREADS;
  static constexpr int LD = TC + PAD;
  static constexpr int ELEMS = TR * LD;
  uint4 v[PER_THREAD];

  __device__ __forceinline__ int row(int i) const {
    return (threadIdx.x + i * THREADS) / PER_ROW;
  }
  __device__ __forceinline__ int col(int i) const {
    return (threadIdx.x + i * THREADS) % PER_ROW * 8;
  }
  __device__ __forceinline__ void load(const Mat& m, int r0, int c0) {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) v[i] = load8(m, r0 + row(i), c0 + col(i));
  }
  __device__ __forceinline__ void store(bf16* s) const {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      *reinterpret_cast<uint4*>(s + row(i) * LD + col(i)) = v[i];
  }
  // du from dy in place: keep * dy / kp [* gelu'(u)], rounded to bf16, for
  // the piece at (r0, c0) of the [N, M] gradient.
  __device__ __forceinline__ void make_du(const Stage& u, bool gelu_on, int r0,
                                          int c0, const Dropout& d) {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      float g[8];
      unpack8(v[i], g);
      if (d.on) {
        const unsigned hr = d.row_part(r0 + row(i));
#pragma unroll
        for (int j = 0; j < 8; ++j) g[j] = d.kept(hr, c0 + col(i) + j) ? g[j] / d.keep : 0.f;
      }
      if (gelu_on) {
        float uf[8];
        unpack8(u.v[i], uf);
#pragma unroll
        for (int j = 0; j < 8; ++j) g[j] *= gelu_grad(uf[j]);
      }
      v[i] = pack8(g);
    }
  }
};

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's 64 x 32 share of one stage. A is [BM][BK] in shared memory
// when A_KMAJOR (depth contiguous), else [BK][BM]; B is [BN][BK] when
// B_KMAJOR, else [BK][BN]. acc[i][j] is the m16 x n8 tile (i, j) of the
// warp's share in mma's accumulator layout.
template <bool A_KMAJOR, bool B_KMAJOR>
__device__ __forceinline__ void multiply(const bf16* sa, const bf16* sb,
                                         float (&acc)[4][4][4]) {
  constexpr int LDA = (A_KMAJOR ? BK : BM) + PAD;
  constexpr int LDB = (B_KMAJOR ? BK : BN) + PAD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    unsigned a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = wm + i * 16;
      if (A_KMAJOR)
        ldsm4(a[i], sa + (m + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
      else
        ldsm4_t(a[i], sa + (kk + (lane & 7) + (lane >> 4) * 8) * LDA + m +
                          ((lane >> 3) & 1) * 8);
    }
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      const int n = wn + jp * 16;
      unsigned r[4];
      if (B_KMAJOR)
        ldsm4(r, sb + (n + (lane & 7) + (lane >> 4) * 8) * LDB + kk +
                     ((lane >> 3) & 1) * 8);
      else
        ldsm4_t(r, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + n +
                       (lane >> 4) * 8);
      b[2 * jp][0] = r[0];
      b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2];
      b[2 * jp + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// Shared memory of one block: two stages of A and of B.
template <bool A_KMAJOR, bool B_KMAJOR>
struct Smem {
  typedef Stage<A_KMAJOR ? BM : BK, A_KMAJOR ? BK : BM> SA;
  typedef Stage<B_KMAJOR ? BN : BK, B_KMAJOR ? BK : BN> SB;
  bf16 a[2][SA::ELEMS];
  bf16 b[2][SB::ELEMS];
};

// acc += A[m0 : m0 + BM, k0 : k1] @ B[k0 : k1, n0 : n0 + BN], stage by
// stage in order. A is the matrix with depth along its columns
// (A_KMAJOR) or its rows; B the matrix with depth along its rows
// (!B_KMAJOR) or its columns. DU names the operand that is the gradient
// dy turned into du while it is stored (1: A, 2: B; U holds u when GELU).
// With `colsum` every thread below BN adds column threadIdx.x of each B
// stage (du, rows in order) into `csum`.
template <bool A_KMAJOR, bool B_KMAJOR, int DU, bool GELU>
__device__ __forceinline__ void mainloop(Smem<A_KMAJOR, B_KMAJOR>& sm, const Mat& A,
                                         const Mat& B, const Mat& U, const Dropout& d,
                                         int m0, int n0, int k0, int k1,
                                         float (&acc)[4][4][4], bool colsum,
                                         float& csum) {
  typedef Smem<A_KMAJOR, B_KMAJOR> S;
  typename S::SA sa;
  typename S::SB sb;
  typename S::SA ua;  // u beside an A that is du (DU == 1)
  typename S::SB ub;  // u beside a B that is du (DU == 2)
  constexpr bool TRANSFORM_A = DU == 1, TRANSFORM_B = DU == 2;
  const bool transform = DU != 0 && (GELU || d.on);

  auto fetch = [&](int k) {
    sa.load(A, A_KMAJOR ? m0 : k, A_KMAJOR ? k : m0);
    sb.load(B, B_KMAJOR ? n0 : k, B_KMAJOR ? k : n0);
    if (TRANSFORM_A && GELU) ua.load(U, m0, k);
    if (TRANSFORM_B && GELU) ub.load(U, k, n0);
  };
  auto put = [&](int st, int k) {
    if (TRANSFORM_A && transform) sa.make_du(ua, GELU, m0, k, d);
    if (TRANSFORM_B && transform) sb.make_du(ub, GELU, k, n0, d);
    sa.store(sm.a[st]);
    sb.store(sm.b[st]);
  };

  const int stages = k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;
  if (stages == 0) return;
  fetch(k0);
  put(0, k0);
  __syncthreads();
  for (int t = 0; t < stages; ++t) {
    const int st = t & 1;
    const bool more = t + 1 < stages;
    if (more) fetch(k0 + (t + 1) * BK);
    if (colsum && threadIdx.x < BN) {
#pragma unroll 8
      for (int r = 0; r < BK; ++r)
        csum += __bfloat162float(sm.b[st][r * S::SB::LD + threadIdx.x]);
    }
    multiply<A_KMAJOR, B_KMAJOR>(sm.a[st], sm.b[st], acc);
    if (more) put(st ^ 1, k0 + (t + 1) * BK);
    __syncthreads();
  }
}

// Calls f(row, col, value, value of col + 1) for the pairs of adjacent
// output columns each thread holds; rows past N are skipped, col + 1 may
// lie past M (the caller masks it).
template <typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[4][4][4], int m0,
                                              int n0, int N, int M, F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + (lane >> 2) + h * 8;
      if (row >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + (lane & 3) * 2;
        if (col < M) f(row, col, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// Stores (v0, v1) at [row, col], [row, col + 1] of a row-major [*, M]
// output, as one 4-byte store where both lie inside an even-width row.
__device__ __forceinline__ void store2(bf16* out, int row, int col, int M, float v0,
                                       float v1) {
  const long long o = (long long)row * M + col;
  if (col + 1 < M && M % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
  } else {
    out[o] = __float2bfloat16(v0);
    if (col + 1 < M) out[o + 1] = __float2bfloat16(v1);
  }
}

// ---------------------------------------------------------------------------
// Forward: y[N, M] = epilogue(x[N, K] @ B), B = w[K, M] (NN) or w[M, K]^T
// (B_KMAJOR, the head). Grid (column tiles, row tiles).
// ---------------------------------------------------------------------------

template <bool B_KMAJOR, int EPI>
__global__ void __launch_bounds__(THREADS) mm_fwd_kernel(
    Mat X, Mat W, const bf16* __restrict__ bias, const bf16* __restrict__ resid,
    void* __restrict__ out, bf16* __restrict__ u_out, int N, int M, Dropout d) {
  __shared__ __align__(16) Smem<true, B_KMAJOR> sm;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float unused = 0.f;
  mainloop<true, B_KMAJOR, 0, false>(sm, X, W, X, d, m0, n0, 0, X.cols, acc, false,
                                     unused);

  for_each_pair(acc, m0, n0, N, M, [&](int row, int col, float a0, float a1) {
    const float acc2[2] = {a0, a1};
    float v[2], u[2];
    const unsigned hr = d.row_part(row);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = min(col + e, M - 1);  // col + 1 may lie past M: computed, not stored
      const float a = acc2[e];
      const float b = bias ? __bfloat162float(bias[c]) : 0.f;
      if (EPI == EPI_F32 || EPI == EPI_BIAS) {
        v[e] = a + b;
      } else if (EPI == EPI_ROUND) {
        v[e] = bias ? round_bf16(a) + b : a;
      } else if (EPI == EPI_GELU) {
        u[e] = a + b;
        const float g = gelu(u[e]);
        v[e] = d.on ? (d.kept(hr, c) ? g / d.keep : 0.f) : g;
      } else {  // EPI_RESID
        float t = a + b;
        if (d.on) t = d.kept(hr, c) ? t / d.keep : 0.f;
        v[e] = __bfloat162float(resid[(long long)row * M + c]) + t;
      }
    }
    if (EPI == EPI_F32) {
      float* o = static_cast<float*>(out) + (long long)row * M + col;
      o[0] = v[0];
      if (col + 1 < M) o[1] = v[1];
    } else {
      store2(static_cast<bf16*>(out), row, col, M, v[0], v[1]);
      if (EPI == EPI_GELU && u_out) store2(u_out, row, col, M, u[0], u[1]);
    }
  });
}

// ---------------------------------------------------------------------------
// dgrad: dx[N, K] = du[N, M] @ w[K, M]^T (NT), du formed from g while each
// A stage is stored. Grid (column tiles of K, row tiles).
// ---------------------------------------------------------------------------

template <bool GELU>
__global__ void __launch_bounds__(THREADS) mm_dgrad_kernel(Mat G, Mat W, Mat U,
                                                           bf16* __restrict__ dx,
                                                           int N, int K, Dropout d) {
  __shared__ __align__(16) Smem<true, true> sm;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float unused = 0.f;
  mainloop<true, true, 1, GELU>(sm, G, W, U, d, m0, n0, 0, G.cols, acc, false, unused);
  for_each_pair(acc, m0, n0, N, K, [&](int row, int col, float a0, float a1) {
    store2(dx, row, col, K, a0, a1);
  });
}

// ---------------------------------------------------------------------------
// wgrad: slice z of the rows, partial[z] = (x[rows, K]^T @ du[rows, M] as
// [K, M], then db's [M] column sums of du over the rows), fp32. Grid
// (column tiles of M, row tiles of K, slices).
// ---------------------------------------------------------------------------

template <bool GELU>
__global__ void __launch_bounds__(THREADS) mm_wgrad_kernel(Mat X, Mat G, Mat U,
                                                           float* __restrict__ partial,
                                                           int K, int M, int rows_per_slice,
                                                           Dropout d) {
  __shared__ __align__(16) Smem<false, false> sm;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int r0 = blockIdx.z * rows_per_slice;
  const int r1 = min(X.rows, r0 + rows_per_slice);
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const bool colsum = blockIdx.y == 0;
  float csum = 0.f;
  mainloop<false, false, 2, GELU>(sm, X, G, U, d, m0, n0, r0, r1, acc, colsum, csum);

  float* part = partial + (long long)blockIdx.z * ((long long)K * M + M);
  for_each_pair(acc, m0, n0, K, M, [&](int row, int col, float a0, float a1) {
    float* o = part + (long long)row * M + col;
    o[0] = a0;
    if (col + 1 < M) o[1] = a1;
  });
  if (colsum && threadIdx.x < BN && n0 + threadIdx.x < M)
    part[(long long)K * M + n0 + threadIdx.x] = csum;
}

// out[i] = sum over z of partial[z][i], in order of z: dw (the first n16
// values, rounded to bf16) and db (the next n32, fp32).
__global__ void __launch_bounds__(SUM_THREADS) slice_sum_kernel(
    const float* __restrict__ partial, int slices, long long stride, long long n16,
    bf16* __restrict__ out16, long long n32, float* __restrict__ out32) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= n16 + n32) return;
  float s = 0.f;
  for (int z = 0; z < slices; ++z) s += partial[z * stride + i];
  if (i < n16)
    out16[i] = __float2bfloat16(s);
  else
    out32[i - n16] = s;
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

Mat mat(const void* p, int rows, int cols) {
  const bool vec = cols % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return Mat{static_cast<const bf16*>(p), rows, cols, cols, vec};
}

dim3 tiles(int rows, int cols, int slices = 1) {
  return dim3((cols + BN - 1) / BN, (rows + BM - 1) / BM, slices);
}

template <int EPI>
int fwd(const void* x, const void* w, const void* b, const void* r, void* y,
        void* u, int N, int K, int M, Dropout d, cudaStream_t s) {
  mm_fwd_kernel<false, EPI><<<tiles(N, M), THREADS, 0, s>>>(
      mat(x, N, K), mat(w, K, M), static_cast<const bf16*>(b),
      static_cast<const bf16*>(r), y, static_cast<bf16*>(u), N, M, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point takes contiguous row-major bf16 operands (fp32 where
// named), the dropout site's seed and salt, its keep threshold (0: no
// dropout) and the keep probability kept values are divided by, and
// PyTorch's stream. It launches on that stream and returns
// cudaGetLastError().

// Forward: y[N, M] = epilogue(x[N, K] @ w[K, M]) with epi
//   0 bias:   round(acc + b)
//   1 round:  round(round(acc) + b), or round(acc) when b is null
//   2 gelu:   round(dropout(gelu(u))), u = acc + b, written rounded to
//             u_out unless it is null
//   3 resid:  round(r + dropout(acc + b)), r [N, M]
extern "C" int mm_fwd_bf16(const void* x, const void* w, const void* b, const void* r,
                           void* y, void* u_out, int N, int K, int M, int epi,
                           unsigned seed, unsigned salt, unsigned threshold, float keep,
                           void* stream) {
  if (N == 0 || M == 0) return (int)cudaSuccess;
  const Dropout d = make_dropout(seed, salt, threshold, keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case EPI_BIAS: return fwd<EPI_BIAS>(x, w, b, r, y, u_out, N, K, M, d, s);
    case EPI_ROUND: return fwd<EPI_ROUND>(x, w, b, r, y, u_out, N, K, M, d, s);
    case EPI_GELU: return fwd<EPI_GELU>(x, w, b, r, y, u_out, N, K, M, d, s);
    case EPI_RESID: return fwd<EPI_RESID>(x, w, b, r, y, u_out, N, K, M, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The head: out[N, M] fp32 = x[N, K] @ w[M, K]^T (w the [V, C] embedding).
extern "C" int mm_nt_f32(const void* x, const void* w, void* out, int N, int K, int M,
                         void* stream) {
  if (N == 0 || M == 0) return (int)cudaSuccess;
  mm_fwd_kernel<true, EPI_F32><<<tiles(N, M), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      mat(x, N, K), mat(w, M, K), nullptr, nullptr, out, nullptr, N, M,
      make_dropout(0u, 0u, 0u, 1.f));
  return (int)cudaGetLastError();
}

// dgrad: dx[N, K] = du[N, M] @ w[K, M]^T, du = keep * g / kp [* gelu'(u)]
// rounded to bf16 (u [N, M] may be null: no GELU).
extern "C" int mm_dgrad_bf16(const void* g, const void* u, const void* w, void* dx,
                             int N, int M, int K, unsigned seed, unsigned salt,
                             unsigned threshold, float keep, void* stream) {
  if (N == 0 || K == 0) return (int)cudaSuccess;
  const Dropout d = make_dropout(seed, salt, threshold, keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mat G = mat(g, N, M), W = mat(w, K, M);
  if (u)
    mm_dgrad_kernel<true><<<tiles(N, K), THREADS, 0, s>>>(G, W, mat(u, N, M),
                                                        static_cast<bf16*>(dx), N, K, d);
  else
    mm_dgrad_kernel<false><<<tiles(N, K), THREADS, 0, s>>>(G, W, G, static_cast<bf16*>(dx),
                                                         N, K, d);
  return (int)cudaGetLastError();
}

// wgrad: dw[K, M] bf16 = x[N, K]^T @ du[N, M] and db[M] fp32 = the column
// sums of du, du as in mm_dgrad_bf16, over `slices` slices of the rows;
// partial: fp32 scratch of slices x (K M + M).
extern "C" int mm_wgrad_bf16(const void* x, const void* g, const void* u, void* partial,
                             void* dw, void* db, int N, int K, int M, int slices,
                             unsigned seed, unsigned salt, unsigned threshold, float keep,
                             void* stream) {
  if (K == 0 || M == 0 || slices < 1) return (int)cudaErrorInvalidValue;
  const Dropout d = make_dropout(seed, salt, threshold, keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_slice = ((N + BK - 1) / BK + slices - 1) / slices * BK;
  const Mat X = mat(x, N, K), G = mat(g, N, M);
  float* part = static_cast<float*>(partial);
  if (u)
    mm_wgrad_kernel<true><<<tiles(K, M, slices), THREADS, 0, s>>>(X, G, mat(u, N, M), part,
                                                                K, M, rows_per_slice, d);
  else
    mm_wgrad_kernel<false><<<tiles(K, M, slices), THREADS, 0, s>>>(X, G, G, part, K, M,
                                                                 rows_per_slice, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n16 = (long long)K * M, n = n16 + M;
  slice_sum_kernel<<<(unsigned)((n + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0, s>>>(
      part, slices, n, n16, static_cast<bf16*>(dw), M, static_cast<float*>(db));
  return (int)cudaGetLastError();
}
