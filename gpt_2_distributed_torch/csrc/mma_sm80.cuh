// Tensor-core tile helpers of the flash kernels (K1 csrc/flash_fwd.cu, K2
// csrc/flash_bwd.cu, K8 csrc/flash_block.cu): mma.sync m16n8k16 (bf16 in,
// fp32 accumulate),
// ldmatrix and cp.async. These instructions exist from sm_80 on; the port
// builds them for sm_90a.
//
// Fragments of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), for lane = 4 g + q (g = lane / 4, q = lane % 4):
//   A, 16 x 16 bf16: a[0] = row g,     cols 2q, 2q + 1
//                    a[1] = row g + 8, cols 2q, 2q + 1
//                    a[2] = row g,     cols 2q + 8, 2q + 9
//                    a[3] = row g + 8, cols 2q + 8, 2q + 9
//   B, 16 x 8 bf16:  b[0] = rows 2q, 2q + 1 of col g; b[1] = rows 2q + 8, 2q + 9
//   C, 16 x 8 fp32:  c[0], c[1] = row g, cols 2q, 2q + 1; c[2], c[3] = row g + 8
// So the C fragments of two neighbouring n8 tiles, rounded to bf16 and
// packed in pairs, are the A fragment of one k16 step (to_a): a product's
// result is the next product's left operand without leaving registers.
//
// Tiles sit in shared memory row-major with rows of D + PAD bf16: the
// 16-byte pad puts the 8 rows that one ldmatrix phase reads in 8 different
// bank groups, so no bank is read twice.
#pragma once

#include <cuda_bf16.h>

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int PAD = 8;  // bf16 padding a shared row: 16 bytes

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory. Lanes 8i .. 8i + 7 give the row
// addresses of matrix i; lane l receives register i = row l / 4, elements
// 2 (l % 4) and 2 (l % 4) + 1 of matrix i. With .trans it receives column
// l / 4, rows 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a . b on one m16 x n8 x k16 tile.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Asynchronous copies into shared memory: 16 bytes through L2 only (cg) or
// 4 bytes (ca). Where `full` is false nothing is read and the destination
// is zero-filled (src-size 0); src must still be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Calls f(r, c) for each 16-byte chunk (row r, first column c) of rows
// [0, R) of an [R][D + PAD] tile that thread threadIdx.x of NT owns. The
// one place the chunks are dealt out: load_rows copies and scale_own_rows
// rescales the same chunks in the same thread.
template <int R, int D, int NT, class F>
__device__ __forceinline__ void for_own_chunks(F&& f) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * CH; i += NT) f(i / CH, i % CH * 8);
}

// Rows [t0, t0 + R) of a bf16 [T, D] matrix x (row stride ld elements,
// unit column stride, every row on a 16-byte boundary) into shared
// s[R][D + PAD], zeros past T, as cp.async copies of 16 bytes that the
// caller commits and waits for.
template <int R, int D, int NT>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* x, long long ld, int t0, int T) {
  for_own_chunks<R, D, NT>([&](int r, int c) {
    const int t = t0 + r;
    cp_async16(s + r * (D + PAD) + c, t < T ? x + t * ld + c : x, t < T);
  });
}

// Multiplies in place, and rounds to bf16, the chunks of s[R][D + PAD]
// that this thread copied in with load_rows<R, D, NT>: its own cp.async
// copies are complete and visible to it after cp.async.wait_group, so no
// barrier is needed before this, only the one that publishes the tile
// after it.
template <int R, int D, int NT>
__device__ __forceinline__ void scale_own_rows(bf16* s, float scale) {
  for_own_chunks<R, D, NT>([&](int r, int c) {
    uint4* p = reinterpret_cast<uint4*>(s + r * (D + PAD) + c);
    uint4 x = *p;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      h2[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *p = x;
  });
}

// Entries [t0, t0 + R) of two contiguous fp32 rows a and b (lse and delta)
// into shared sa[R] and sb[R] as 4-byte cp.async copies, zeros past T.
template <int R, int NT>
__device__ __forceinline__ void load_stats(float* sa, float* sb, const float* a, const float* b,
                                           int t0, int T) {
  for (int i = threadIdx.x; i < 2 * R; i += NT) {
    const int r = i % R, t = t0 + r;
    const float* src = i < R ? a : b;
    cp_async4((i < R ? sa : sb) + r, t < T ? src + t : src, t < T);
  }
}

// acc[n] (n8 tile n of an m16 x N result) += A . B^T over the depth D:
// A is 16 rows at a, B is N rows at b, both row-major in shared memory with
// rows of D + PAD (depth contiguous). Only the 16-column groups [lo, hi) are
// formed; the others keep what acc held.
template <int N, int D>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const bf16* a, const bf16* b,
                                        int lo, int hi) {
  constexpr int LD = D + PAD;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    unsigned fa[4];
    ldsm4(fa, a + (lane & 15) * LD + kk + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      if (n < lo || n >= hi) continue;
      unsigned fb[4];
      ldsm4(fb, b + (n * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk + ((lane >> 3) & 1) * 8);
      mma(acc[2 * n], fa, fb[0], fb[1]);
      mma(acc[2 * n + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc[n] (n8 tile n of an m16 x D result) += P . B: P is m16 x K in A
// fragments (p[kk] for depth kk * 16 .. kk * 16 + 15), B is K rows at b,
// row-major in shared memory with rows of D + PAD, read through
// ldmatrix.trans. Only the k16 steps [lo, hi) are taken.
template <int K, int D>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const unsigned (&p)[K / 16][4],
                                       const bf16* b, int lo, int hi) {
  constexpr int LD = D + PAD;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    if (kk < lo || kk >= hi) continue;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      unsigned fb[4];
      ldsm4_t(fb, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n * 16 +
                      (lane >> 4) * 8);
      mma(acc[2 * n], p[kk], fb[0], fb[1]);
      mma(acc[2 * n + 1], p[kk], fb[2], fb[3]);
    }
  }
}

// The A fragments of an m16 x K result held in C fragments, rounded to
// bf16: k16 step kk packs n8 tiles 2 kk and 2 kk + 1.
template <int K>
__device__ __forceinline__ void to_a(unsigned (&p)[K / 16][4], const float (&c)[K / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    p[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    p[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    p[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    p[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Stores (v0, v1) rounded to bf16 at p[0], p[1] (p 4-byte aligned).
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// Writes rows `row` and `row + 8` (those below T) of a warp's m16 x D
// result held in C fragments, times `mul`, as bf16.
template <int D>
__device__ __forceinline__ void store_rows(bf16* x, long long ld, const float (&acc)[D / 8][4],
                                           int row, int T, float mul) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= T) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(x + r * ld + n * 8 + 2 * tq, acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

}  // namespace tc
