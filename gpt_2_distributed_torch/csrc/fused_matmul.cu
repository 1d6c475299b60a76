// Fused matmuls for Hopper (sm_90a): K7 of the port. The forward is a bf16
// GEMM on wgmma with fp32 accumulators and the epilogues applied to the
// accumulator before its one write-back; the backward forms du once per leg
// and runs dgrad and wgrad as plain bf16 GEMMs on the same wgmma pipeline.
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
// where du = keep * dy / (1 - rate) [* gelu'(u)] in fp32, rounded to bf16
// before the products, as the TPU kernels' _dgrad_tile forms it. The mask is
// dropout_hash_bits(seed, 0, salt, row, col) >= threshold on the absolute
// row of the flattened [N, M] output and the output column
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
// 4096, C = 768) each leg does 14.5 to 19.3 GFLOP each way on 9 to 44 MB
// of operands: 15 to 20 us at 989 TFLOP/s against 3 to 13 us of bytes.
// Decode rows (N = 8) are bound by the weight bytes instead.
//
// Forward (fwd_kernel): a block computes a 128 x 128 output tile from the
// same pipeline as the backward's products below: one producer thread
// keeps TMA loads of 64-deep stages in flight through a ring of 3 stages,
// and two consumer warpgroups issue wgmma.mma_async m64n128k16 into fp32
// registers, each 64 rows. x is the K-major A operand; w [K, M] the
// MN-major B operand (wgmma's transpose bit for B alone), the head's
// wte [V, C] a K-major one. Once both warpgroups' products have completed,
// they stage the fp32 tile through the freed stages and apply the epilogue
// in the tile's row order: 16 threads a row, 8 columns each, so the bias,
// the residual, y and u move as 16-byte loads and stores (element by
// element along the row where the width is not a multiple of 8, and for
// the head's fp32 logits). The epilogue (tanh, the mask hash) leaves the
// tensor cores idle, so two blocks share an SM: while one applies its
// epilogue, the other multiplies.
//   NN (forward):  x[N, K] @ w[K, M]
//   NT (head):     h[R, C] @ wte[V, C]^T
// The forward sums every output element over the whole depth in one block,
// stage by stage in order, with a tile shape and instruction that never
// change: a row's result does not depend on how many rows share the launch
// or where the row sits in its tile, which is what keeps the serving
// engine's streams equal to one-request decoding.
//
// Backward, in two kernels a leg. The TPU kernels rebuild du inside every
// output tile of dgrad and of wgrad to keep it out of HBM; here that is 6
// to 24 rebuilds of the mask hash and the tanh, while du itself is 25 MB
// of bf16 at fc, 8 us of this card's HBM. So:
//   du pass (du_kernel): one read of dy (and u), one write of du, and db as
//     fp32 column sums of the bf16 du: each block sums a chunk of rows of
//     its columns (each thread its rows in order, then the 8 threads of a
//     column in order), and slice_sum_kernel adds the chunks' partials (8
//     threads a column, each its chunks in order, then the 8 in order). At
//     rate 0 without GELU du is dy itself and the pass only sums db.
//   products (gemm_kernel): dgrad dx[N, K] = du[N, M] @ w[K, M]^T (both
//     operands K-major) and wgrad dw[K, M] = x[N, K]^T @ du[N, M] (both
//     MN-major, wgmma's transpose bits). A block computes a 128 x 128 tile:
//     one producer thread keeps TMA loads (cp.async.bulk.tensor, 128-byte
//     swizzle, zeros past the matrix) of 64-deep A and B stages in flight
//     through a ring of 5 stages completed on mbarriers, and two consumer
//     warpgroups issue wgmma.mma_async m64n128k16 from those stages into
//     fp32 registers, each 64 rows; a stage is released once the next
//     stage's products are issued and its own have completed. The result is
//     rounded to bf16 once on store.
// TMA takes rows whose stride is a multiple of 16 bytes at a 16-byte
// aligned base; the wrappers give such operands (a zeroed copy with its
// rows padded to 8 elements otherwise) and the matrix's true width, so
// ragged shapes (the 1.5B widths, one-row decode, the head's V = 50257)
// run the same kernels; rows and depth past the matrix read zeros.
//
// Determinism. No atomics, no split-K with a race. The forward and dgrad
// sum each output over the whole depth in one block, in order. wgrad
// splits the rows it
// sums over into a number of slices that is a function of the shape only
// (so the 36 output tiles of a [768, 768] weight fill the card): each
// slice writes fp32 partials and slice_sum_kernel adds them in order and
// rounds dw once; one slice writes dw directly. Two launches give the same
// bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

typedef __nv_bfloat16 bf16;

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
// du pass: du[N, M] = bf16(keep * g / kp [* gelu'(u)]) (written unless
// !WRITE, where du is g) and partial[chunk][M], the fp32 column sums of the
// bf16 du over each chunk of `chunk_rows` rows. Block (DU_TX, DU_TY): thread
// (tx, ty) takes 8 columns and the rows ty, ty + DU_TY, ... of the chunk.
// Grid (column strips of DU_TX * 8, chunks).
// ---------------------------------------------------------------------------

constexpr int DU_TX = 32;
constexpr int DU_TY = 8;
constexpr int DU_COLS = DU_TX * 8;  // columns a block

template <bool WRITE, bool GELU>
__global__ void __launch_bounds__(DU_TX* DU_TY) du_kernel(Mat G, Mat U, bf16* __restrict__ du,
                                                         long long ld_du,
                                                         float* __restrict__ partial,
                                                         int chunk_rows, Dropout d) {
  __shared__ float red[DU_TY][DU_COLS];
  const int N = G.rows, M = G.cols;
  const int c0 = blockIdx.x * DU_COLS + threadIdx.x * 8;
  const int r0 = blockIdx.y * chunk_rows, r1 = min(N, r0 + chunk_rows);
  const bool vec_out = ld_du % 8 == 0 && reinterpret_cast<uintptr_t>(du) % 16 == 0;
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0.f;
  if (c0 < M) {
    for (int r = r0 + threadIdx.y; r < r1; r += DU_TY) {
      float g[8];
      unpack8(load8(G, r, c0), g);
      if (WRITE) {
        if (d.on) {
          const unsigned hr = d.row_part(r);
#pragma unroll
          for (int j = 0; j < 8; ++j) g[j] = d.kept(hr, c0 + j) ? g[j] / d.keep : 0.f;
        }
        if (GELU) {
          float uf[8];
          unpack8(load8(U, r, c0), uf);
#pragma unroll
          for (int j = 0; j < 8; ++j) g[j] *= gelu_grad(uf[j]);
        }
        const uint4 v = pack8(g);
        unpack8(v, g);  // the bf16 du, summed into db as the products see it
        bf16* o = du + (long long)r * ld_du + c0;
        if (vec_out && c0 + 8 <= M) {
          *reinterpret_cast<uint4*>(o) = v;
        } else {
          const bf16* h = reinterpret_cast<const bf16*>(&v);
          for (int j = 0; j < 8 && c0 + j < M; ++j) o[j] = h[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] += g[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) red[threadIdx.y][threadIdx.x * 8 + j] = s[j];
  __syncthreads();
  const int t = threadIdx.y * DU_TX + threadIdx.x;  // this thread's column of the strip
  const int col = blockIdx.x * DU_COLS + t;
  if (col < M) {
    float sum = 0.f;
#pragma unroll
    for (int y = 0; y < DU_TY; ++y) sum += red[y][t];
    partial[(long long)blockIdx.y * M + col] = sum;
  }
}

// ---------------------------------------------------------------------------
// The wgmma pipeline of the forward and of the backward's products. A block
// computes a 128 x 128 tile of out = A @ B over a run of 64-deep stages:
// warpgroups 0 and 1 consume (rows 0-63 and 64-127 of the tile),
// warpgroup 2's first thread produces. Each operand of a stage is either
//   K-major: the depth contiguous; one TMA box of 64 deep x 128 rows, or
//   MN-major: the tile's rows (A) or columns (B) contiguous; two TMA boxes
//     of 64 wide x 64 deep,
// with 128-byte swizzle; wgmma reads an MN-major operand through its
// transpose bit.
// ---------------------------------------------------------------------------

namespace gm {

constexpr int BM = 128, BN = 128, BK = 64, CONSUMERS = 2;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// The backward's products: 5 stages, one block an SM, a producer
// warpgroup (its first thread issues the loads).
constexpr int STAGES = 5;
constexpr int THREADS = 128 * (CONSUMERS + 1);
// The forward: 3 stages and a producer warp, so two blocks fit an SM (in
// shared memory and in registers) and one block's epilogue runs beside the
// other's products.
constexpr int FWD_STAGES = 3;
constexpr int FWD_THREADS = 128 * CONSUMERS + 32;
constexpr int FWD_BLOCKS = 2;
constexpr int smem_bytes(int stages) {
  return stages * STAGE_BYTES + 2 * stages * 8 + 1024;  // + alignment
}
// The forward stages its fp32 output tile through the freed stages in rows
// of TLD floats: the 4-float pad keeps both the fragment writes and the
// row-order reads free of bank conflicts.
constexpr int TLD = BN + 4;
static_assert(BM * TLD * 4 <= FWD_STAGES * STAGE_BYTES, "the output tile fits the stages");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of `bar` with this parity has completed. A wait
// of ~2^34 cycles (seconds) traps, so a stalled pipeline is a launch error
// and not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// The box at (c0 inner, c1 outer) of `map` into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand at
// `addr`: lbo the stride between 64-element chunks of an MN-major operand's
// output dimension, sbo the stride between groups of 8 rows (K-major) or 8
// depth rows (MN-major), both in bytes.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] @ B[16 x 128], fp32 accumulators; TA, TB: A, B
// MN-major (wgmma's transpose bits), else K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The S stages and their barriers in a block's dynamic shared memory.
template <int S>
struct Pipe {
  uint8_t* sa;      // S x A_BYTES
  uint8_t* sb;      // S x B_BYTES
  uint64_t* full;   // S: the stage's loads have landed
  uint64_t* empty;  // S: the stage's products have completed
};

// Carves the pipe out of dynamic shared memory and initialises its
// barriers; every thread of the block calls it.
template <int S>
__device__ __forceinline__ Pipe<S> make_pipe(uint8_t* smem_raw) {
  // 128-byte swizzled tiles start on 1024-byte boundaries.
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * STAGE_BYTES);
  const Pipe<S> p{smem, smem + S * A_BYTES, full, full + S};
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&p.full[s], 1);
      mbar_init(&p.empty[s], CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return p;
}

// The producer: keeps up to S stages of depth [k0, k0 + nk * BK) in
// flight, A's tile at rows m0 and B's at columns n0.
template <int S, bool A_MN, bool B_MN>
__device__ __forceinline__ void produce(const Pipe<S>& p, const CUtensorMap* ta,
                                        const CUtensorMap* tb, int m0, int n0, int k0,
                                        int nk) {
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % S;
    if (kb >= S) mbar_wait(&p.empty[s], ((kb / S) + 1) & 1);
    mbar_expect_tx(&p.full[s], STAGE_BYTES);
    const int k = k0 + kb * BK;
    uint8_t* a = p.sa + s * A_BYTES;
    uint8_t* b = p.sb + s * B_BYTES;
    if (A_MN) {
      tma_load(a, ta, &p.full[s], m0, k);
      tma_load(a + A_BYTES / 2, ta, &p.full[s], m0 + 64, k);
    } else {
      tma_load(a, ta, &p.full[s], k, m0);
    }
    if (B_MN) {
      tma_load(b, tb, &p.full[s], n0, k);
      tma_load(b + B_BYTES / 2, tb, &p.full[s], n0 + 64, k);
    } else {
      tma_load(b, tb, &p.full[s], k, n0);
    }
  }
}

// A consumer warpgroup: d = its 64 rows of the tile summed over the nk
// stages in order. d[j * 4 + h * 2 + e] holds row w * 16 + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 128 tile (w its
// warp).
template <int S, bool A_MN, bool B_MN>
__device__ __forceinline__ void consume(const Pipe<S>& p, float (&d)[64], int wg, int nk) {
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  fence_acc(d);
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % S;
    mbar_wait(&p.full[s], (kb / S) & 1);
    const uint32_t a = smem_u32(p.sa + s * A_BYTES), b = smem_u32(p.sb + s * B_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // MN-major: 16 depth rows of 128 bytes a step; K-major: 16 depth
      // elements (32 bytes) a step inside each 128-byte row.
      const uint64_t da = A_MN ? descriptor(a + wg * (A_BYTES / 2) + kk * 2048, A_BYTES / 2, 1024)
                               : descriptor(a + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = B_MN ? descriptor(b + kk * 2048, B_BYTES / 2, 1024)
                               : descriptor(b + kk * 32, 16, 1024);
      wgmma_m64n128k16<A_MN, B_MN>(d, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kb > 0) mbar_arrive(&p.empty[(kb - 1) % S]);
  }
  wgmma_wait<0>();
  fence_acc(d);
}

// The backward's products: out[rows, cols] (+)= A @ B over the depth
// [z * per_slice, min(depth, (z + 1) * per_slice)) of slice z.
//   !MN_MAJOR (dgrad): A = du[rows, depth], B = w[cols, depth], K-major.
//   MN_MAJOR (wgrad): A = x[depth, rows], B = du[depth, cols], MN-major.
// F32: fp32 partials at out + z * rows * cols, else bf16 out. Grid (column
// tiles, row tiles, slices).
template <bool MN_MAJOR, bool F32>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                void* __restrict__ out, int rows, int cols, int depth, int per_slice) {
  extern __shared__ uint8_t smem_raw[];
  const Pipe<STAGES> p = make_pipe<STAGES>(smem_raw);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k0 = blockIdx.z * per_slice, k1 = min(depth, k0 + per_slice);
  const int nk = k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;
  const int wg = threadIdx.x / 128;

  if (wg == CONSUMERS) {
    if (threadIdx.x == CONSUMERS * 128)
      produce<STAGES, MN_MAJOR, MN_MAJOR>(p, &ta, &tb, m0, n0, k0, nk);
  } else {
    float d[64];
    consume<STAGES, MN_MAJOR, MN_MAJOR>(p, d, wg, nk);

    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + j * 8 + (lane % 4) * 2;
        if (col >= cols) continue;
        const float v0 = d[j * 4 + h * 2], v1 = d[j * 4 + h * 2 + 1];
        if (F32) {
          float* o = static_cast<float*>(out) + (long long)blockIdx.z * rows * cols +
                     (long long)row * cols + col;
          o[0] = v0;
          if (col + 1 < cols) o[1] = v1;
        } else {
          store2(static_cast<bf16*>(out), row, col, cols, v0, v1);
        }
      }
    }
  }
}

// The forward's epilogue of one output element from its fp32 sum a, its
// bias b (0 without one) and its residual r: the value written, and u for
// the gelu epilogue (module comment for the roundings).
template <int EPI>
__device__ __forceinline__ float epilogue(float a, float b, float r, const Dropout& d,
                                          unsigned hr, int col, float& u) {
  if (EPI == EPI_F32 || EPI == EPI_BIAS) return a + b;
  if (EPI == EPI_ROUND) return round_bf16(a) + b;
  if (EPI == EPI_GELU) {
    u = a + b;
    const float g = gelu(u);
    return d.on ? (d.kept(hr, col) ? g / d.keep : 0.f) : g;
  }
  float t = a + b;  // EPI_RESID
  if (d.on) t = d.kept(hr, col) ? t / d.keep : 0.f;
  return r + t;
}

// The forward: out[N, M] = epilogue(x[N, K] @ B), B = w[K, M] (B_MN) or
// w[M, K]^T (the head), bf16 out but for EPI_F32. vec: M % 8 == 0 and every
// bf16 vector operand on a 16-byte boundary, so each thread of the
// epilogue moves 8 elements of a row at a time. Grid (column tiles, row
// tiles).
template <bool B_MN, int EPI>
__global__ void __launch_bounds__(FWD_THREADS, FWD_BLOCKS)
    fwd_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               const bf16* __restrict__ bias, const bf16* __restrict__ resid,
               void* __restrict__ out, bf16* __restrict__ u_out, int N, int M, int K, bool vec,
               Dropout d) {
  extern __shared__ uint8_t smem_raw[];
  const Pipe<FWD_STAGES> p = make_pipe<FWD_STAGES>(smem_raw);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    if (threadIdx.x == CONSUMERS * 128)
      produce<FWD_STAGES, false, B_MN>(p, &ta, &tb, m0, n0, 0, (K + BK - 1) / BK);
    return;
  }
  float acc[64];
  consume<FWD_STAGES, false, B_MN>(p, acc, wg, (K + BK - 1) / BK);

  // Both warpgroups' products have completed before the stages they read
  // are overwritten with the fp32 tile [BM][TLD].
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
  float* tile = reinterpret_cast<float*>(p.sa);
  {
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + warp * 16 + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(tile + r * TLD + j * 8 + (lane % 4) * 2) =
            make_float2(acc[j * 4 + h * 2], acc[j * 4 + h * 2 + 1]);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");

  const int tid = threadIdx.x;  // 0 .. CONSUMERS * 128 - 1
  if (vec) {
    // 16 threads a row, 8 columns each: 16 rows a pass.
    const int c = tid % 16 * 8, col = n0 + c;
    if (col >= M) return;  // M % 8 == 0: the 8 columns lie all inside or all outside
    float bv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (bias) unpack8(*reinterpret_cast<const uint4*>(bias + col), bv);
    constexpr int PASS = CONSUMERS * 128 / 16;  // rows a pass
#pragma unroll
    for (int i = 0; i < BM / PASS; ++i) {
      const int r = tid / 16 + i * PASS, row = m0 + r;
      if (row >= N) break;
      const long long o = (long long)row * M + col;
      const float4 a0 = *reinterpret_cast<const float4*>(tile + r * TLD + c);
      const float4 a1 = *reinterpret_cast<const float4*>(tile + r * TLD + c + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float rv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (EPI == EPI_RESID) unpack8(*reinterpret_cast<const uint4*>(resid + o), rv);
      const unsigned hr = d.row_part(row);
      float v[8], u[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = epilogue<EPI>(av[j], bv[j], rv[j], d, hr, col + j, u[j]);
      *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) = pack8(v);
      if (EPI == EPI_GELU && u_out) *reinterpret_cast<uint4*>(u_out + o) = pack8(u);
    }
  } else {
    // Element by element, neighbouring threads on neighbouring columns.
    for (int i = tid; i < BM * BN; i += CONSUMERS * 128) {
      const int r = i / BN, c = i % BN;
      const int row = m0 + r, col = n0 + c;
      if (row >= N) break;
      if (col >= M) continue;
      const long long o = (long long)row * M + col;
      const float b = bias ? __bfloat162float(bias[col]) : 0.f;
      const float rr = EPI == EPI_RESID ? __bfloat162float(resid[o]) : 0.f;
      float u = 0.f;
      const float v = epilogue<EPI>(tile[r * TLD + c], b, rr, d, d.row_part(row), col, u);
      if (EPI == EPI_F32) {
        static_cast<float*>(out)[o] = v;
      } else {
        static_cast<bf16*>(out)[o] = __float2bfloat16(v);
        if (EPI == EPI_GELU && u_out) u_out[o] = __float2bfloat16(u);
      }
    }
  }
}

}  // namespace gm

// out[i] = the sum over z of partial[z][i] (i < n) rounded to T, the
// du pass's db (fp32; z the row chunks, 128 at 4096 rows) and wgrad's dw
// (bf16; z the row slices, a few): thread (tx, ty) of a (SUM_THREADS / ty,
// ty) block sums z = ty, ty + blockDim.y, ... of element blockIdx.x *
// blockDim.x + tx in order, then the blockDim.y sums are added in order
// of ty. blockDim.y is SUM_SPLIT where there are that many slices (db's
// few columns and many chunks), else 1 (dw's many elements and few
// slices): a function of the shape only.
constexpr int SUM_THREADS = 256;
constexpr int SUM_SPLIT = 8;

__device__ __forceinline__ void put_sum(float* o, float v) { *o = v; }
__device__ __forceinline__ void put_sum(bf16* o, float v) { *o = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(SUM_THREADS) slice_sum_kernel(
    const float* __restrict__ partial, int slices, long long n, T* __restrict__ out) {
  __shared__ float red[SUM_THREADS];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  if (i < n)
    for (int z = threadIdx.y; z < slices; z += blockDim.y) s += partial[z * n + i];
  red[threadIdx.y * blockDim.x + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float t = 0.f;
    for (int y = 0; y < (int)blockDim.y; ++y) t += red[y * blockDim.x + threadIdx.x];
    put_sum(out + i, t);
  }
}

template <typename T>
int slice_sum(const float* partial, int slices, long long n, void* out, cudaStream_t s) {
  const int ty = slices >= SUM_SPLIT ? SUM_SPLIT : 1, tx = SUM_THREADS / ty;
  slice_sum_kernel<T><<<(unsigned)((n + tx - 1) / tx), dim3(tx, ty), 0, s>>>(
      partial, slices, n, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

Mat mat(const void* p, int rows, int cols) {
  const bool vec = cols % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return Mat{static_cast<const bf16*>(p), rows, cols, cols, vec};
}

// cuTensorMapEncodeTiled through the runtime, so the library needs no link
// against libcuda.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The TMA map of a row-major bf16 [rows, cols] matrix with row stride ld
// elements (ld % 8 == 0, 16-byte aligned base), boxes of box_cols x
// box_rows, 128-byte swizzle; reads past the matrix give zeros.
bool tensor_map(CUtensorMap* map, const void* p, int rows, int cols, long long ld,
                int box_cols, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (!encode || ld % 8 != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool MN_MAJOR, bool F32>
int gemm(const CUtensorMap& ta, const CUtensorMap& tb, void* out, int rows, int cols,
         int depth, int slices, int per_slice, cudaStream_t s) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(gm::gemm_kernel<MN_MAJOR, F32>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               gm::smem_bytes(gm::STAGES));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid((cols + gm::BN - 1) / gm::BN, (rows + gm::BM - 1) / gm::BM, slices);
  gm::gemm_kernel<MN_MAJOR, F32><<<grid, gm::THREADS, gm::smem_bytes(gm::STAGES), s>>>(
      ta, tb, out, rows, cols, depth, per_slice);
  return (int)cudaGetLastError();
}

// The forward on `stream`: out = epilogue(A @ B) from the maps of x [N, K]
// (K-major) and of w [K, M] (B_MN) or w [M, K].
template <bool B_MN, int EPI>
int fwd(const CUtensorMap& ta, const CUtensorMap& tb, const void* b, const void* r, void* y,
        void* u, int N, int K, int M, Dropout d, cudaStream_t s) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(gm::fwd_kernel<B_MN, EPI>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               gm::smem_bytes(gm::FWD_STAGES));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const bool vec = EPI != EPI_F32 && M % 8 == 0 && aligned(y) && aligned(u) && aligned(r) &&
                   aligned(b);
  const dim3 grid((M + gm::BN - 1) / gm::BN, (N + gm::BM - 1) / gm::BM);
  gm::fwd_kernel<B_MN, EPI><<<grid, gm::FWD_THREADS, gm::smem_bytes(gm::FWD_STAGES), s>>>(
      ta, tb, static_cast<const bf16*>(b), static_cast<const bf16*>(r), y,
      static_cast<bf16*>(u), N, M, K, vec, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point takes row-major bf16 operands (fp32 where named) and
// PyTorch's stream; the forward and the du pass also the dropout site's
// seed and salt, its keep threshold (0: no dropout) and the keep
// probability kept values are divided by. It launches on that stream and
// returns cudaGetLastError() (cudaErrorInvalidValue for an operand TMA
// cannot take).

// Forward: y[N, M] = epilogue(x[N, K] @ w[K, M]) with epi
//   0 bias:   round(acc + b)
//   1 round:  round(round(acc) + b), or round(acc) when b is null
//   2 gelu:   round(dropout(gelu(u))), u = acc + b, written rounded to
//             u_out unless it is null
//   3 resid:  round(r + dropout(acc + b)), r [N, M]
// x and w with row strides ld_x, ld_w (multiples of 8 elements); b, r, y
// and u_out contiguous.
extern "C" int mm_fwd_bf16(const void* x, int ld_x, const void* w, int ld_w, const void* b,
                           const void* r, void* y, void* u_out, int N, int K, int M, int epi,
                           unsigned seed, unsigned salt, unsigned threshold, float keep,
                           void* stream) {
  if (N == 0 || M == 0) return (int)cudaSuccess;
  CUtensorMap ta, tb;
  if (K == 0 || !tensor_map(&ta, x, N, K, ld_x, gm::BK, gm::BM) ||
      !tensor_map(&tb, w, K, M, ld_w, 64, gm::BK))
    return (int)cudaErrorInvalidValue;
  const Dropout d = make_dropout(seed, salt, threshold, keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case EPI_BIAS: return fwd<true, EPI_BIAS>(ta, tb, b, r, y, u_out, N, K, M, d, s);
    case EPI_ROUND: return fwd<true, EPI_ROUND>(ta, tb, b, r, y, u_out, N, K, M, d, s);
    case EPI_GELU: return fwd<true, EPI_GELU>(ta, tb, b, r, y, u_out, N, K, M, d, s);
    case EPI_RESID: return fwd<true, EPI_RESID>(ta, tb, b, r, y, u_out, N, K, M, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The head: out[N, M] fp32 = x[N, K] @ w[M, K]^T (w the [V, C] embedding),
// row strides ld_x, ld_w (multiples of 8 elements).
extern "C" int mm_nt_f32(const void* x, int ld_x, const void* w, int ld_w, void* out, int N,
                         int K, int M, void* stream) {
  if (N == 0 || M == 0) return (int)cudaSuccess;
  CUtensorMap ta, tb;
  if (K == 0 || !tensor_map(&ta, x, N, K, ld_x, gm::BK, gm::BM) ||
      !tensor_map(&tb, w, M, K, ld_w, gm::BK, gm::BN))
    return (int)cudaErrorInvalidValue;
  return fwd<false, EPI_F32>(ta, tb, nullptr, nullptr, out, nullptr, N, K, M,
                             make_dropout(0u, 0u, 0u, 1.f), static_cast<cudaStream_t>(stream));
}

// du pass: du[N, M] (row stride ld_du) = bf16(keep * g / kp [* gelu'(u)])
// from g [N, M] and u [N, M] (null: no GELU), and db[M] fp32 = the column
// sums of du through partial, fp32 scratch of ceil(N / chunk_rows) x M.
// du may be null only with u null and threshold 0: du is g, and only db is
// formed.
extern "C" int mm_du_bf16(const void* g, const void* u, void* du, int ld_du, void* partial,
                          void* db, int N, int M, int chunk_rows, unsigned seed,
                          unsigned salt, unsigned threshold, float keep, void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (chunk_rows < 1 || (!du && (u || threshold))) return (int)cudaErrorInvalidValue;
  const Dropout d = make_dropout(seed, salt, threshold, keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (N + chunk_rows - 1) / chunk_rows;
  float* part = static_cast<float*>(partial);
  if (chunks > 0) {
    const dim3 grid((M + DU_COLS - 1) / DU_COLS, chunks), block(DU_TX, DU_TY);
    const Mat G = mat(g, N, M);
    bf16* o = static_cast<bf16*>(du);
    if (!du)
      du_kernel<false, false><<<grid, block, 0, s>>>(G, G, o, ld_du, part, chunk_rows, d);
    else if (u)
      du_kernel<true, true><<<grid, block, 0, s>>>(G, mat(u, N, M), o, ld_du, part,
                                                   chunk_rows, d);
    else
      du_kernel<true, false><<<grid, block, 0, s>>>(G, G, o, ld_du, part, chunk_rows, d);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return slice_sum<float>(part, chunks, M, db, s);
}

// dgrad: dx[N, K] = du[N, M] @ w[K, M]^T; du and w with row strides ld_du,
// ld_w (multiples of 8 elements).
extern "C" int mm_dgrad_bf16(const void* du, int ld_du, const void* w, int ld_w, void* dx,
                             int N, int M, int K, void* stream) {
  if (N == 0 || K == 0 || M == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, du, N, M, ld_du, gm::BK, gm::BM) ||
      !tensor_map(&tb, w, K, M, ld_w, gm::BK, gm::BN))
    return (int)cudaErrorInvalidValue;
  return gemm<false, false>(ta, tb, dx, N, K, M, 1, M, static_cast<cudaStream_t>(stream));
}

// wgrad: dw[K, M] bf16 = x[N, K]^T @ du[N, M] over `slices` slices of the
// rows (row strides ld_x, ld_du); partial: fp32 scratch of slices x K x M
// (unused with one slice).
extern "C" int mm_wgrad_bf16(const void* x, int ld_x, const void* du, int ld_du,
                             void* partial, void* dw, int N, int K, int M, int slices,
                             void* stream) {
  if (N == 0 || K == 0 || M == 0 || slices < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, x, N, K, ld_x, 64, gm::BK) ||
      !tensor_map(&tb, du, N, M, ld_du, 64, gm::BK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_slice = ((N + gm::BK - 1) / gm::BK + slices - 1) / slices * gm::BK;
  if (slices == 1) return gemm<true, false>(ta, tb, dw, K, M, N, 1, per_slice, s);
  float* part = static_cast<float*>(partial);
  const int e = gemm<true, true>(ta, tb, part, K, M, N, slices, per_slice, s);
  if (e != (int)cudaSuccess) return e;
  return slice_sum<bf16>(part, slices, (long long)K * M, dw, s);
}
