// Causal flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: gpt_2_distributed_tpu/ops/flash_attention.py::_fwd_kernel
// (the Pallas TPU kernel built in _build._raw_fwd), with its in-kernel
// dropout. The backward is csrc/flash_bwd.cu (K2).
//
// Computes, for every (b, h) and every query row t < T, with
// s[t, j] = q[t] . k[j] (raw bf16 operands, fp32 sums) and
// c = log2(e) / sqrt(D):
//   p[t, j] = exp2(c s[t, j] - c m[t]) over j <= t, m the running row max
//   o[t]    = sum_j bf16(keep[t, j] p[t, j] / (1 - rate)) v[j] / l[t]
//   lse[t]  = c m[t] + log2(l[t]),  l[t] = sum_j p[t, j]  (UNDROPPED p)
// so the backward rebuilds the normalized probabilities from the base-2
// lse. The scale is applied to the fp32 score in the FMA that feeds exp2,
// so the scores are as exact as fp32 sums of exact bf16 products allow; the
// probabilities are rounded to bf16 before the product with V, where the
// TPU kernel rounds them (p.astype(v.dtype)). keep[t, j] is
// dropout_hash_bits(seed, b, h, t, j) >= threshold on absolute coordinates
// (csrc/dropout_hash.cuh), so the mask is the TPU kernel's bit for bit.
// Dropout is a template flag; threshold 0 launches the kernel without it.
//
// What bounds it on the H100: at [4, 12, 1024, 64] the causal products are
// ~6.4 GFLOP (~6.5 us on the bf16 tensor cores) and the operands ~25 MB
// (~7.5 us at 3.35 TB/s): bytes, with the products close behind, and with
// dropout ~25 M mask hashes of ~10 integer operations each.
//
// Design (FlashAttention-2's forward on mma.sync): one block of 4 warps
// owns one (b, h, 64-row query tile), each warp 16 query rows, and loops
// over the 64-key tiles 0 .. its diagonal in that fixed order, so nothing
// carries between blocks. Q is copied to shared memory once; K and V
// stream through two shared stages filled by cp.async, the next tile's
// copy in flight while the current one is multiplied. Per key tile and warp:
//   S = Q K^T on mma.sync m16n8k16 (ldmatrix of Q and of K rows);
//   the online softmax on the accumulator fragments: each thread holds two
//   rows' 16 scores, the row max is reduced over the 4 lanes of a row with
//   shuffles, each thread keeps its partial row sums until the end;
//   the mask hash on each fragment element's (row, col);
//   P rounded to bf16 in registers is the A operand of O += P V (V through
//   ldmatrix.trans).
// The tile shape is fixed and never chosen from T or B, and the key tiles
// are walked in a fixed order, so a row's result depends on its own
// inputs only: the same leading rows give the same bits at any T, which
// the serving engine's bucket-padded prefill needs. Only the diagonal tile
// is masked (keys past a row, which covers keys past T); in it each warp
// skips the 16-key groups wholly above its rows. Rows past T in the last
// tile read zeros and are not written. Every causal row keeps its
// diagonal, so each row's running sum is positive and the final divide
// needs no guard. Blocks are issued longest query tile first, over every
// (b, h), so the causal imbalance leaves no long tail. Every row of every
// operand must start on a 16-byte boundary (the wrapper copies those that
// do not).
//
// The query-offset form (OFF, flash_fwd_offset_bf16) carries the serving
// engine's chunked prefill: query row r of batch b sits at global position
// start[b] + r, the C query rows attend causally over S keys (the gathered
// block table's view from position 0), no dropout. It is the same kernel:
// keys are tiled from position 0 as above, and a block walks key tiles 0 ..
// (start + q0 + BQ - 1) / BK, clipped to S; a tile that holds a key past
// some row of the block (or past S) is masked by global position, each warp
// forming only the 16-key groups up to its own last row. A key tile that is
// wholly masked for a row leaves its m unchanged (alpha = 1) and adds p = 0
// to its sums, so a row at position i runs the very arithmetic, over the
// very tiles, that the whole-prompt form runs for row i: its o and lse are
// the whole-prompt form's bit for bit. With OFF false every new expression
// folds to the whole-prompt form's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "mma_sm80.cuh"

namespace {

using tc::bf16;

constexpr int BQ = 64;   // query rows per block, 16 a warp
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // 4 warps
constexpr float LOG2E = 1.4426950408889634f;

template <int D, bool DROP, bool OFF>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, const int* __restrict__ start, int H,
    int T, int S,
    long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost,
    unsigned seed, unsigned threshold, float keep) {
  constexpr int LD = D + tc::PAD;
  constexpr int NJ = BK / 8;  // n8 score tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* ks = qs + BQ * LD;                         // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                     // [2][BK][LD]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int q0 = qt * BQ;
  // Global position of the tile's first row, the keys, the last key tile.
  const int p0 = OFF ? start[b] + q0 : q0;
  const int SK = OFF ? S : T;
  const int kt_last = OFF ? min((p0 + BQ - 1) / BK, (S - 1) / BK) : qt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = warp * 16 + g;  // the thread's first row in the tile; the other is wr + 8
  const float scale = LOG2E / sqrtf((float)D);
  const float inv_keep = 1.f / keep;
  unsigned hrow[2];
  if (DROP) {
    const unsigned hbh = dropout_hash_bh(seed, b, h);
    hrow[0] = hbh ^ dropout_hash_row(q0 + wr);
    hrow[1] = hbh ^ dropout_hash_row(q0 + wr + 8);
  }

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;
  tc::load_rows<BQ, D, NT>(qs, qb, qst, q0, T);
  tc::load_rows<BK, D, NT>(ks, kb, kst, 0, SK);
  tc::load_rows<BK, D, NT>(vs, vb, vst, 0, SK);
  tc::cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // BQ == BK, so query tile qt's diagonal lies in key tile qt (whole-prompt
  // form). The offset form's diagonal may straddle two key tiles.
  for (int kt = 0; kt <= kt_last; ++kt) {
    const int st = kt & 1;
    if (kt < kt_last) {
      tc::load_rows<BK, D, NT>(ks + (st ^ 1) * BK * LD, kb, kst, (kt + 1) * BK, SK);
      tc::load_rows<BK, D, NT>(vs + (st ^ 1) * BK * LD, vb, vst, (kt + 1) * BK, SK);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // everything but the tile just requested has landed
    __syncthreads();

    // A masked tile holds a key past some row of the block (or past S).
    const bool diag = OFF ? kt * BK + BK - 1 > p0 || kt * BK + BK > S : kt == qt;
    // Row wr's diagonal column in this tile is rel + wr.
    const int rel = OFF ? p0 - kt * BK : 0;
    int hi = diag ? warp + 1 : BK / 16;  // 16-key groups this warp needs
    if (OFF && diag) {
      const int last = min(rel + warp * 16 + 15, S - 1 - kt * BK);  // its last column
      hi = last < 0 ? 0 : min(BK / 16, last / 16 + 1);
    }
    const bf16* kst_s = ks + st * BK * LD;
    const bf16* vst_s = vs + st * BK * LD;
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    tc::mma_abt<BK, D>(s, qs + warp * 16 * LD, kst_s, 0, hi);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * tq + (e & 1);
        if (diag && (col > rel + wr + (e >> 1) * 8 || (OFF && kt * BK + col >= S)))
          s[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float ms[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // Key 0 <= every row, so m is finite from key tile 0 on; mx is -inf
      // only on a tile wholly masked for the row (offset form), which
      // leaves m as it is and gives alpha = 1.
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f((m[i] - m_new) * scale);
      m[i] = m_new;
      ms[i] = m_new * scale;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(fmaf(s[j][e], scale, -ms[i]));
        l[i] += p;
        if (DROP) {
          const unsigned bits = dropout_hash_finish(
              hrow[i] ^ dropout_hash_col(kt * BK + j * 8 + 2 * tq + (e & 1)));
          p = bits >= threshold ? p * inv_keep : 0.f;
        }
        s[j][e] = p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    unsigned pa[BK / 16][4];
    tc::to_a<BK>(pa, s);
    tc::mma_pb<BK, D>(acc, pa, vst_s, 0, hi);
    __syncthreads();  // this stage is consumed before the next copy into it
  }

  bf16* ob = o + b * osb + h * osh;
  float* lb = lse + ((long long)b * H + h) * T;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + wr + i * 8;
    if (row >= T) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      tc::store2(ob + row * ost + n * 8 + 2 * tq, acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (tq == 0) lb[row] = m[i] * scale + log2f(l[i]);
  }
}

template <int D, bool DROP, bool OFF>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const int* start,
           int B, int H, int T, int S, const long long* st, unsigned seed, unsigned threshold,
           float keep, cudaStream_t stream) {
  constexpr size_t smem = sizeof(bf16) * (BQ + 4 * BK) * (D + tc::PAD);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D, DROP, OFF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(B * H, (T + BQ - 1) / BQ);
  flash_fwd_kernel<D, DROP, OFF><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), start, H, T, S,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], seed, threshold, keep);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
             int T, const long long* st, unsigned seed, unsigned threshold, float keep,
             cudaStream_t stream) {
  return threshold ? launch<D, true, false>(q, k, v, o, lse, nullptr, B, H, T, T, st, seed,
                                            threshold, keep, stream)
                   : launch<D, false, false>(q, k, v, o, lse, nullptr, B, H, T, T, st, seed,
                                             threshold, keep, stream);
}

// Every row of every operand on a 16-byte boundary.
bool aligned(const void* const* ptrs, const long long* strides) {
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

}  // namespace

// q, k, v, o: bf16 [B, H, T, D] with element strides (b, h, t) given in
// `strides` as 12 int64 (q, k, v, o in that order); the d stride is 1.
// lse: fp32 [B, H, T], contiguous. Dropout keeps hash bits >= threshold
// and divides the kept probabilities by `keep` (1 - rate); threshold 0
// launches the kernel without dropout. Every row of q, k, v and o must
// start on a 16-byte boundary (pointers 16-byte aligned, strides multiples
// of 8), else nothing is launched and cudaErrorInvalidValue is returned.
// Returns cudaGetLastError().
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int T, int D,
                              const long long* strides, unsigned seed,
                              unsigned threshold, float keep, void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  if (!aligned(ptrs, strides)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_d<32>(q, k, v, o, lse, B, H, T, strides, seed, threshold, keep, s);
    case 64: return launch_d<64>(q, k, v, o, lse, B, H, T, strides, seed, threshold, keep, s);
    case 128: return launch_d<128>(q, k, v, o, lse, B, H, T, strides, seed, threshold, keep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The query-offset form: q, o bf16 [B, H, C, D] whose row r of batch b sits
// at global position start[b] + r (start: int32 [B] on the device); k, v
// bf16 [B, H, S, D] from position 0; element strides (b, h, t) of q, k, v,
// o in `strides` as 12 int64, the d stride 1. lse: fp32 [B, H, C],
// contiguous. Causal by global position, no dropout. Returns
// cudaErrorInvalidValue (nothing launched) for a misaligned row, S < 1 or
// an unsupported D, else cudaGetLastError().
extern "C" int flash_fwd_offset_bf16(const void* q, const void* k, const void* v, void* o,
                                     void* lse, const int* start, int B, int H, int C, int S,
                                     int D, const long long* strides, void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  if (!aligned(ptrs, strides) || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32, false, true>(q, k, v, o, lse, start, B, H, C, S, strides, 0, 0, 1.f, s);
    case 64: return launch<64, false, true>(q, k, v, o, lse, start, B, H, C, S, strides, 0, 0, 1.f, s);
    case 128: return launch<128, false, true>(q, k, v, o, lse, start, B, H, C, S, strides, 0, 0, 1.f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
