// Causal flash-attention backward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: gpt_2_distributed_tpu/ops/flash_attention.py::_bwd_kernel
// (the Pallas TPU kernel built in _build._raw_bwd), with its in-kernel
// dropout. The forward is csrc/flash_fwd.cu (K1).
//
// Computes, for every (b, h), from q, k, v, do (bf16 [B, H, T, D]), K1's
// base-2 lse and delta = rowsum(do * o) (fp32 [B, H, T], o the dropped
// output), with s = q . k on the raw bf16 operands and c = log2(e)/sqrt(D):
//   p   = exp2(c s - lse)          the normalized, UNDROPPED probability
//   dpd = do . v
//   dp  = keep * dpd / kp,  pd = keep * p / kp     (kp = 1 - rate)
//   ds  = p * (dp - delta)
//   dq  = bf16(ds) k / sqrt(D),  dk = bf16(ds)^T q / sqrt(D),  dv = bf16(pd)^T do
// keep[t, j] is dropout_hash_bits(seed, b, h, t, j) >= threshold on
// absolute coordinates, the mask K1 drew. ds and pd are rounded to bf16
// before their products, where the TPU kernel rounds them
// (ds.astype(q.dtype), pd.astype(do.dtype)); everything else is fp32, and
// dq, dk and dv are rounded to bf16 once, on write. q is not pre-scaled
// (the scale goes into the FMA that feeds exp2), so dk needs no 1/log2(e).
//
// What bounds it on the H100: at the training shape [4, 12, 1024, 64] the
// five causal products are ~16 GFLOP (~16 us on the bf16 tensor cores;
// the split below forms S and dP twice, ~23 GFLOP done) and the operands
// ~50 MB (~15 us at 3.35 TB/s); with dropout each kept score element is
// also hashed twice.
//
// Design: the TPU kernel walks one (b, h) in order and accumulates dk/dv
// for the whole sequence in a VMEM-resident [T, D] output across its
// sequential q-block grid axis. On Hopper blocks run in no order, so the
// work is split into two kernels, each of which owns what it writes and
// needs no atomics (the same inputs give bit-identical grads; FA2's fp32
// atomicAdd into dq would not):
//   * the dk/dv kernel: one block of 4 warps per (b, h, 64-key tile), each
//     warp 16 keys. K and V are copied to shared memory once; Q, dO, lse
//     and delta stream through two cp.async stages over the query tiles
//     from the diagonal to T. With keys as rows it forms S^T = K Q^T and
//     dP^T = V dO^T on mma.sync m16n8k16, so pd^T and ds^T come out as
//     accumulator fragments that, rounded to bf16 and packed, are already
//     the A operand of dV += pd^T dO and dK += ds^T Q (dO and Q through
//     ldmatrix.trans); dk and dv stay in registers.
//   * the dq kernel: one block of 4 warps per (b, h, 64-row query tile).
//     Q, dO, lse and delta are copied once; K and V stream through two
//     stages over the key tiles 0 .. the diagonal. It forms S = Q K^T and
//     dP = dO V^T with queries as rows and dQ += ds K from registers.
// Both rebuild p from lse and the mask from the hash, so nothing of size
// T x T is ever stored. Only the diagonal tile (keys past a query) and the
// ragged last query tile (queries past T) are masked; in the diagonal tile
// each warp skips the 16-wide groups wholly on the masked side. Rows and
// keys past T read zeros and are not written, so any T >= 1 is taken.
// Blocks are issued longest loop first, over every (b, h). Every row of
// every bf16 operand must start on a 16-byte boundary (the wrapper copies
// inputs that do not).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "mma_sm80.cuh"

namespace {

using tc::bf16;

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // 4 warps, 16 rows each
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {  // element strides (b, h, t) of each [B, H, T, D] operand
  long long q[3], k[3], v[3], d_o[3], dq[3], dk[3], dv[3];
};

// Three blocks an SM at D <= 64: the register cap (168) holds the kernel
// without spills and takes 24 % off its time against two blocks at 177
// registers. At D = 128 the accumulators alone need ~128 registers.
template <int D, bool DROP>
__global__ void __launch_bounds__(NT, D <= 64 ? 3 : 1) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
    int T, Strides st, unsigned seed, unsigned threshold, float keep) {
  constexpr int LD = D + tc::PAD;
  constexpr int NJ = BQ / 8;  // n8 tiles of queries a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]
  bf16* vs = ks + BK * LD;                         // [BK][LD]
  bf16* qs = vs + BK * LD;                         // [2][BQ][LD]
  bf16* dos = qs + 2 * BQ * LD;                    // [2][BQ][LD]
  float* lses = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* deltas = lses + 2 * BQ;                               // [2][BQ]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kt = blockIdx.y;  // tile 0 loops over every query tile: issued first
  const int k0 = kt * BK;
  const int nq = (T + BQ - 1) / BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wk = warp * 16 + g;  // the thread's first key in the tile; the other is wk + 8
  const float scale = LOG2E / sqrtf((float)D);
  const float inv_keep = 1.f / keep;
  const unsigned hbh = DROP ? dropout_hash_bh(seed, b, h) : 0u;
  unsigned hcol[2];
  hcol[0] = dropout_hash_col(k0 + wk);
  hcol[1] = dropout_hash_col(k0 + wk + 8);
  const long long bh = (long long)b * H + h;

  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* dob = d_o + b * st.d_o[0] + h * st.d_o[1];
  auto fetch = [&](int qt, int stage) {
    tc::load_rows<BQ, D, NT>(qs + stage * BQ * LD, qb, st.q[2], qt * BQ, T);
    tc::load_rows<BQ, D, NT>(dos + stage * BQ * LD, dob, st.d_o[2], qt * BQ, T);
    tc::load_stats<BQ, NT>(lses + stage * BQ, deltas + stage * BQ, lse + bh * T,
                           delta + bh * T, qt * BQ, T);
  };
  tc::load_rows<BK, D, NT>(ks, k + b * st.k[0] + h * st.k[1], st.k[2], k0, T);
  tc::load_rows<BK, D, NT>(vs, v + b * st.v[0] + h * st.v[1], st.v[2], k0, T);
  fetch(kt, 0);
  tc::cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];  // keys wk, wk + 8 in C fragments
  tc::zero(dka);
  tc::zero(dva);

  // BQ == BK, so query tile qt reaches key tile kt iff qt >= kt.
  for (int qt = kt; qt < nq; ++qt) {
    const int stage = (qt - kt) & 1;
    if (qt + 1 < nq) fetch(qt + 1, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // everything but the tile just requested has landed
    __syncthreads();

    const bf16* qss = qs + stage * BQ * LD;
    const bf16* doss = dos + stage * BQ * LD;
    const float* ls = lses + stage * BQ;
    const float* dls = deltas + stage * BQ;
    const int q0 = qt * BQ;
    const bool diag = qt == kt;
    const bool ragged = q0 + BQ > T;
    const int lo = diag ? warp : 0;  // 16-query groups before lo lie before every key

    float s[NJ][4], dp[NJ][4];  // S^T and dP^T: keys as rows, queries as columns
    tc::zero(s);
    tc::zero(dp);
    tc::mma_abt<BQ, D>(s, ks + warp * 16 * LD, qss, lo, BQ / 16);
    tc::mma_abt<BQ, D>(dp, vs + warp * 16 * LD, doss, lo, BQ / 16);

#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = j * 8 + 2 * tq;  // this thread's query columns c, c + 1
      const float2 lse2 = *reinterpret_cast<const float2*>(ls + c);
      const float2 del2 = *reinterpret_cast<const float2*>(dls + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c + (e & 1);
        const bool valid = (!diag || col >= wk + (e >> 1) * 8) && (!ragged || q0 + col < T);
        const float p =
            valid ? exp2f(fmaf(s[j][e], scale, -((e & 1) ? lse2.y : lse2.x))) : 0.f;
        float pd = p, dpv = dp[j][e];
        if (DROP) {
          const bool kept = dropout_hash_finish(hbh ^ dropout_hash_row(q0 + col) ^
                                                hcol[e >> 1]) >= threshold;
          pd = kept ? p * inv_keep : 0.f;
          dpv = kept ? dpv * inv_keep : 0.f;
        }
        s[j][e] = p * (dpv - ((e & 1) ? del2.y : del2.x));  // ds^T
        dp[j][e] = pd;                                       // pd^T
      }
    }
    unsigned fa[BQ / 16][4];
    tc::to_a<BQ>(fa, dp);
    tc::mma_pb<BQ, D>(dva, fa, doss, lo, BQ / 16);
    tc::to_a<BQ>(fa, s);
    tc::mma_pb<BQ, D>(dka, fa, qss, lo, BQ / 16);
    __syncthreads();  // this stage is consumed before the next copy into it
  }

  tc::store_rows<D>(dk + b * st.dk[0] + h * st.dk[1], st.dk[2], dka, k0 + wk, T,
                1.f / sqrtf((float)D));
  tc::store_rows<D>(dv + b * st.dv[0] + h * st.dv[1], st.dv[2], dva, k0 + wk, T, 1.f);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int H, int T, Strides st,
    unsigned seed, unsigned threshold, float keep) {
  constexpr int LD = D + tc::PAD;
  constexpr int NJ = BK / 8;  // n8 tiles of keys a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* dos = qs + BQ * LD;                        // [BQ][LD]
  bf16* ks = dos + BQ * LD;                        // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                     // [2][BK][LD]
  float* lses = reinterpret_cast<float*>(vs + 2 * BK * LD);  // [BQ]
  float* deltas = lses + BQ;                                  // [BQ]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int q0 = qt * BQ;
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
  const long long bh = (long long)b * H + h;

  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  tc::load_rows<BQ, D, NT>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, T);
  tc::load_rows<BQ, D, NT>(dos, d_o + b * st.d_o[0] + h * st.d_o[1], st.d_o[2], q0, T);
  tc::load_stats<BQ, NT>(lses, deltas, lse + bh * T, delta + bh * T, q0, T);
  tc::load_rows<BK, D, NT>(ks, kb, st.k[2], 0, T);
  tc::load_rows<BK, D, NT>(vs, vb, st.v[2], 0, T);
  tc::cp_async_commit();

  float dqa[D / 8][4];  // rows wr, wr + 8 in C fragments
  tc::zero(dqa);
  float lse_r[2], delta_r[2];

  for (int kt = 0; kt <= qt; ++kt) {
    const int stage = kt & 1;
    if (kt < qt) {
      tc::load_rows<BK, D, NT>(ks + (stage ^ 1) * BK * LD, kb, st.k[2], (kt + 1) * BK, T);
      tc::load_rows<BK, D, NT>(vs + (stage ^ 1) * BK * LD, vb, st.v[2], (kt + 1) * BK, T);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // everything but the tile just requested has landed
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse_r[i] = lses[wr + 8 * i];
        delta_r[i] = deltas[wr + 8 * i];
      }
    }

    const bf16* kss = ks + stage * BK * LD;
    const bf16* vss = vs + stage * BK * LD;
    const bool diag = kt == qt;
    const int hi = diag ? warp + 1 : BK / 16;  // 16-key groups this warp needs
    float s[NJ][4], dp[NJ][4];
    tc::zero(s);
    tc::zero(dp);
    tc::mma_abt<BK, D>(s, qs + warp * 16 * LD, kss, 0, hi);
    tc::mma_abt<BK, D>(dp, dos + warp * 16 * LD, vss, 0, hi);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = j * 8 + 2 * tq + (e & 1);
        const float p =
            (!diag || col <= wr + 8 * i) ? exp2f(fmaf(s[j][e], scale, -lse_r[i])) : 0.f;
        float dpv = dp[j][e];
        if (DROP) {
          const bool kept = dropout_hash_finish(hrow[i] ^ dropout_hash_col(kt * BK + col)) >=
                            threshold;
          dpv = kept ? dpv * inv_keep : 0.f;
        }
        s[j][e] = p * (dpv - delta_r[i]);  // ds
      }
    unsigned fa[BK / 16][4];
    tc::to_a<BK>(fa, s);
    tc::mma_pb<BK, D>(dqa, fa, kss, 0, hi);
    __syncthreads();  // this stage is consumed before the next copy into it
  }

  tc::store_rows<D>(dq + b * st.dq[0] + h * st.dq[1], st.dq[2], dqa, q0 + wr, T,
                1.f / sqrtf((float)D));
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  configured = e == cudaSuccess;
  return e;
}

template <int D, bool DROP>
int launch(const void* q, const void* k, const void* v, const void* d_o,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int B, int H, int T, const Strides& st, unsigned seed,
           unsigned threshold, float keep, cudaStream_t stream) {
  constexpr int LD = D + tc::PAD;
  // dk/dv: K, V once, two stages of Q, dO, lse, delta; dq: Q, dO, lse,
  // delta once, two stages of K, V.
  constexpr size_t smem_dkdv = sizeof(bf16) * 6 * 64 * LD + sizeof(float) * 4 * BQ;
  constexpr size_t smem_dq = sizeof(bf16) * 6 * 64 * LD + sizeof(float) * 2 * BQ;
  static bool conf_dkdv = false, conf_dq = false;
  cudaError_t e = set_smem(flash_bwd_dkdv_kernel<D, DROP>, smem_dkdv, conf_dkdv);
  if (e != cudaSuccess) return (int)e;
  e = set_smem(flash_bwd_dq_kernel<D, DROP>, smem_dq, conf_dq);
  if (e != cudaSuccess) return (int)e;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* dop = static_cast<const bf16*>(d_o);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  const dim3 grid(B * H, (T + 63) / 64);
  flash_bwd_dkdv_kernel<D, DROP><<<grid, NT, smem_dkdv, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T, st, seed,
      threshold, keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<D, DROP><<<grid, NT, smem_dq, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dq), H, T, st, seed, threshold, keep);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* d_o,
             const void* lse, const void* delta, void* dq, void* dk, void* dv,
             int B, int H, int T, const Strides& st, unsigned seed,
             unsigned threshold, float keep, cudaStream_t stream) {
  return threshold
             ? launch<D, true>(q, k, v, d_o, lse, delta, dq, dk, dv, B, H, T,
                               st, seed, threshold, keep, stream)
             : launch<D, false>(q, k, v, d_o, lse, delta, dq, dk, dv, B, H, T,
                                st, seed, threshold, keep, stream);
}

}  // namespace

// q, k, v, do, dq, dk, dv: bf16 [B, H, T, D] with element strides
// (b, h, t) given in `strides` as 21 int64 (in that order); the d stride
// is 1. lse (base 2, from K1) and delta (rowsum(do * o)): fp32 [B, H, T],
// contiguous. Dropout as in flash_fwd_bf16 (threshold 0 = none). Every row
// of the bf16 operands must start on a 16-byte boundary, else nothing is
// launched and cudaErrorInvalidValue is returned. Launches the dk/dv
// kernel, then the dq kernel, on `stream`. Returns cudaGetLastError().
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* d_o, const void* lse,
                              const void* delta, void* dq, void* dk, void* dv,
                              int B, int H, int T, int D,
                              const long long* strides, unsigned seed,
                              unsigned threshold, float keep, void* stream) {
  Strides st;
  long long* dst[7] = {st.q, st.k, st.v, st.d_o, st.dq, st.dk, st.dv};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) {
      dst[i][j] = strides[3 * i + j];
      if (strides[3 * i + j] % 8 != 0) return (int)cudaErrorInvalidValue;
    }
  const void* ptrs[7] = {q, k, v, d_o, dq, dk, dv};
  for (int i = 0; i < 7; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_d<32>(q, k, v, d_o, lse, delta, dq, dk, dv, B, H, T, st, seed, threshold, keep, s);
    case 64: return launch_d<64>(q, k, v, d_o, lse, delta, dq, dk, dv, B, H, T, st, seed, threshold, keep, s);
    case 128: return launch_d<128>(q, k, v, d_o, lse, delta, dq, dk, dv, B, H, T, st, seed, threshold, keep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
