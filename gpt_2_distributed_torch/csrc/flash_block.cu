// Rectangular causal block attention at global offsets for Hopper (sm_90a),
// bf16 in and out: the per-step kernel of ring attention (K8).
//
// Replaces: gpt_2_distributed_tpu/ops/flash_block.py::_fwd_kernel and
// ::_bwd_kernel (the Pallas TPU kernels built in _build._raw_fwd and
// _build._raw_bwd).
//
// A query block q [B, H, Tq, D] whose rows sit at global positions
// row_off + r attends to one key/value block k, v [B, H, Tc, D] whose
// columns sit at col_off + c: position (r, c) attends iff
// col_off + c <= row_off + r. With s = bf16(q * log2(e) / sqrt(D)) . k
// (the scaled q rounded to bf16 before the product, as the TPU kernel
// rounds it) the forward writes, per row,
//   lse = m + log2(l),  l = sum_c exp2(s - m) over the UNDROPPED p
//   o   = sum_c bf16(keep * exp2(s - m) / (1 - rate)) * v / l
// (the kept p rounded to bf16 before the product, as the TPU kernel rounds
// it; m the running row max of the online softmax; the kernel multiplies
// by fp32(1 / (1 - rate)) where the TPU kernel divides), o normalised over
// this block only, and the base-2 lse [B, H, Tq] in fp32, which is what
// the ring's block-level combine needs. A row with no attended column (a
// block wholly in the row's future) writes o = 0 and lse = NEG_INF (-1e30)
// exactly. keep is dropout_hash_bits(seed,
// b_off + b, h_off + h, row_off + r, col_off + c) >= threshold on GLOBAL
// coordinates, so with the same seed the ring draws K1's masks over the
// whole sequence, whatever the sp degree.
//
// The backward takes the cotangents (do, dlse) through one effective
// delta = rowsum(do * o) - dlse * log2(e), formed outside the kernel:
//   p  = exp2(s - lse) where (r, c) attends, else exactly 0 (so a
//        NEG_INF row never computes exp2(NEG_INF - NEG_INF) = 1)
//   dp = keep * (do . v) / kp,  pd = keep * p / kp
//   ds = p * (dp - delta)
//   dq = ds k / sqrt(D),  dk = ds^T bf16(q scale) / log2(e),  dv = pd^T do
// accumulated in fp32 and rounded to bf16 once.
//
// ds and pd are rounded to bf16 before their products, where the TPU
// kernel rounds them (ds.astype(q.dtype), pd.astype(do.dtype)).
//
// What bounds it on the H100: one full [4, 12, 512, 64] block (sp = 2 at
// 124M) is ~3.2 GFLOP forward (~3.3 us on the bf16 tensor cores) and
// ~12.7 MB of operands (~3.8 us at 3.35 TB/s), with dropout ~12.6 M mask
// hashes of ~10 integer operations each: bytes, the products close
// behind. The backward's five products are ~8 GFLOP (~8.1 us): operations.
// So every product runs on the tensor cores, each operand tile is copied
// to shared memory once, and the copies overlap the products.
//
// Design: the TPU kernels carry m, l, acc (and dk, dv) across sequential
// grid axes; on Hopper blocks run in no order, so, as K1/K2 do, a block
// owns what it writes and loops over the other axis itself: the forward
// and the dq kernel one block per (b, h, 64-row q-tile) looping over the
// key tiles, the dk/dv kernel one block per (b, h, 64-key tile) looping
// over the q-tiles. No atomics, so two launches on the same inputs give
// the same bits. A tile is skipped when its first global column lies past
// the q-tile's last global row (the TPU kernel's causal gate), and the
// element mask is applied only on tiles that cross the diagonal or the
// ragged edge, so any Tq, Tc >= 1 and any offsets are taken. A block whose
// every tile is skipped still writes its rows' o = 0 and lse = NEG_INF
// (and zero grads).
//
// All three kernels are K1/K2's design (csrc/flash_fwd.cu,
// csrc/flash_bwd.cu) on the tensor cores: 4 warps a block, 16 rows each,
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) through the
// csrc/mma_sm80.cuh helpers.
//   * forward: Q copied once; K and V streamed through two cp.async stages
//     over the needed key tiles, the next tile's copy in flight while the
//     current one is multiplied. S = Q_s K^T; the online softmax on the
//     accumulator fragments (each thread holds two rows' 16 scores, the row
//     max reduced over the row's 4 lanes with shuffles, the row sums kept
//     per thread until the end); the mask hash per fragment element on
//     global coordinates; the dropped, rescaled p rounded to bf16 in
//     registers is the A operand of O += P V, where the TPU kernel rounds
//     it (p.astype(v.dtype)). A row with no attended key so far keeps
//     m = -inf, l = 0 and acc = 0 (alpha 1, p exactly 0: never
//     exp2(-inf - -inf)), so a row with none at all writes exactly o = 0
//     and lse = NEG_INF.
//   * dk/dv kernel: K and V copied to shared memory once; Q, dO, lse and
//     delta streamed through two cp.async stages over the needed query
//     tiles. With keys as rows it forms S^T = K Q_s^T and dP^T = V dO^T,
//     so pd^T and ds^T come out as accumulator fragments that, rounded to
//     bf16 and packed, are the A operand of dV += pd^T dO and
//     dK += ds^T Q_s from registers.
//   * dq kernel: Q, dO, lse and delta copied once; K and V streamed
//     through two stages over the needed key tiles; S = Q_s K^T and
//     dP = dO V^T with queries as rows, dQ += ds K from registers.
// Q_s = bf16(q * log2(e) / sqrt(D)) is formed in shared memory: each
// thread scales the 16-byte chunks it copied in, once they have landed.
// Each warp skips the 16-wide groups of a tile that lie wholly on the
// masked side of the diagonal or past Tq / Tc. Every row of every bf16
// operand must start on a 16-byte boundary (the wrappers copy inputs that
// do not).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "mma_sm80.cuh"

namespace {

using tc::bf16;

constexpr int BQ = 64;   // query rows per tile, 16 a warp
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // 4 warps
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;  // 1 / log2(e)
constexpr float NEG_INF = -1e30f;           // the TPU kernel's masked fill

struct Strides {  // element strides (b, h, t) of each [B, H, T, D] operand
  long long q[3], k[3], v[3], d_o[3], o[3], dq[3], dk[3], dv[3];
};

struct Block {  // where the block sits in the global problem
  int H, Tq, Tc, row_off, col_off, b_off, h_off;
  unsigned seed, threshold;
  float keep;
};

// The causal gate of the (q-tile q0, key tile k0) pair in local indices:
// needed iff its first global column is at or before the q-tile's last
// global row; `masked` iff some pair in it does not attend (the tile
// crosses the diagonal) or it runs past Tq or Tc.
__device__ __forceinline__ bool tile_needed(const Block& p, int q0, int k0) {
  const int r_hi = p.row_off + min(q0 + BQ, p.Tq) - 1;
  return p.col_off + k0 <= r_hi;
}
__device__ __forceinline__ bool tile_masked(const Block& p, int q0, int k0) {
  return p.col_off + k0 + BK - 1 > p.row_off + q0 || q0 + BQ > p.Tq ||
         k0 + BK > p.Tc;
}
__device__ __forceinline__ bool attends(const Block& p, int row, int col) {
  return row < p.Tq && col < p.Tc && p.col_off + col <= p.row_off + row;
}

// Key tiles [0, n) pass the causal gate of the q-tile at q0 (the gate is
// monotone in the key tile).
__device__ __forceinline__ int needed_key_tiles(const Block& p, int q0) {
  const int r_hi = p.row_off + min(q0 + BQ, p.Tq) - 1;
  return r_hi < p.col_off ? 0 : min((p.Tc + BK - 1) / BK, (r_hi - p.col_off) / BK + 1);
}

// The 16-key groups [0, hi) of the key tile at k0 that the warp whose 16
// rows start at local row r0 needs: the later ones lie wholly after its
// last row or past Tc. A tile where hi < BK / 16 is a masked tile.
__device__ __forceinline__ int needed_key_groups(const Block& p, int r0, int k0) {
  const int reach = p.row_off + r0 + 15 - p.col_off - k0;
  return reach < 0 ? 0 : min(min(BK / 16, reach / 16 + 1), (p.Tc - k0 + 15) / 16);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(NT) flash_block_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, Strides st, Block p) {
  constexpr int LD = D + tc::PAD;
  constexpr int NJ = BK / 8;  // n8 score tiles a warp
  extern __shared__ __align__(16) unsigned char smem_fwd[];
  bf16* qs = reinterpret_cast<bf16*>(smem_fwd);  // [BQ][LD] bf16(q * scale)
  bf16* ks = qs + BQ * LD;                         // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                     // [2][BK][LD]

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = warp * 16 + g;  // the thread's first row in the tile; the other is wr + 8
  const float scale = LOG2E * rsqrtf((float)D);
  const float inv_keep = 1.f / p.keep;
  unsigned hrow[2];
  if (DROP) {
    const unsigned hbh = dropout_hash_bh(p.seed, p.b_off + b, p.h_off + h);
    hrow[0] = hbh ^ dropout_hash_row(p.row_off + q0 + wr);
    hrow[1] = hbh ^ dropout_hash_row(p.row_off + q0 + wr + 8);
  }
  const int nk = needed_key_tiles(p, q0);

  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  if (nk > 0) {
    tc::load_rows<BQ, D, NT>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, p.Tq);
    tc::load_rows<BK, D, NT>(ks, kb, st.k[2], 0, p.Tc);
    tc::load_rows<BK, D, NT>(vs, vb, st.v[2], 0, p.Tc);
    tc::cp_async_commit();
  }

  // Rows wr, wr + 8: the running max (base 2), this thread's share of the
  // running sum, and o's accumulator in C fragments.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  tc::zero(acc);

  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < nk) {
      tc::load_rows<BK, D, NT>(ks + (stage ^ 1) * BK * LD, kb, st.k[2], (kt + 1) * BK, p.Tc);
      tc::load_rows<BK, D, NT>(vs + (stage ^ 1) * BK * LD, vb, st.v[2], (kt + 1) * BK, p.Tc);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // everything but the tile just requested has landed
    if (kt == 0) tc::scale_own_rows<BQ, D, NT>(qs, scale);
    __syncthreads();

    const bf16* kss = ks + stage * BK * LD;
    const bf16* vss = vs + stage * BK * LD;
    const int k0 = kt * BK;
    const bool masked = tile_masked(p, q0, k0);
    const int hi = needed_key_groups(p, q0 + warp * 16, k0);
    float s[NJ][4];
    tc::zero(s);
    tc::mma_abt<BK, D>(s, qs + warp * 16 * LD, kss, 0, hi);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j / 2 >= hi) continue;  // never formed, never read
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked && !attends(p, q0 + wr + (e >> 1) * 8, k0 + j * 8 + 2 * tq + (e & 1)))
          s[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // A row with no attended key yet keeps m = -inf (alpha 1 over its
      // zero l and acc); its masked p below are exactly 0.
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = m_new == -INFINITY ? 1.f : exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j / 2 >= hi) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pv = s[j][e] == -INFINITY ? 0.f : exp2f(s[j][e] - m[i]);
        l[i] += pv;  // the undropped p
        if (DROP) {
          const bool kept = dropout_hash_finish(
              hrow[i] ^ dropout_hash_col(p.col_off + k0 + j * 8 + 2 * tq + (e & 1))) >=
              p.threshold;
          pv = kept ? pv * inv_keep : 0.f;
        }
        s[j][e] = pv;
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    unsigned pa[BK / 16][4];
    tc::to_a<BK>(pa, s);  // p rounded to bf16, as the TPU kernel rounds it
    tc::mma_pb<BK, D>(acc, pa, vss, 0, hi);
    __syncthreads();  // this stage is consumed before the next copy into it
  }

  bf16* ob = o + b * st.o[0] + h * st.o[1];
  float* lb = lse + ((long long)b * p.H + h) * p.Tq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + wr + i * 8;
    if (row >= p.Tq) continue;
    const bool has = l[i] > 0.f;
    const float inv = has ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      tc::store2(ob + row * st.o[2] + n * 8 + 2 * tq, acc[n][2 * i] * inv,
                 acc[n][2 * i + 1] * inv);
    if (tq == 0) lb[row] = has ? m[i] + log2f(l[i]) : NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// The backward (K2's design, csrc/flash_bwd.cu, with K8's scaled q, global
// coordinates and masked rows).
// ---------------------------------------------------------------------------

// Three blocks an SM at D <= 64, as K2's dk/dv kernel (168 registers).
template <int D, bool DROP>
__global__ void __launch_bounds__(NT, D <= 64 ? 3 : 1) flash_block_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    Strides st, Block p) {
  constexpr int LD = D + tc::PAD;
  constexpr int NJ = BQ / 8;  // n8 tiles of queries a warp
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  bf16* ks = reinterpret_cast<bf16*>(smem_bwd);  // [BK][LD]
  bf16* vs = ks + BK * LD;                         // [BK][LD]
  bf16* qs = vs + BK * LD;                         // [2][BQ][LD] bf16(q * scale)
  bf16* dos = qs + 2 * BQ * LD;                    // [2][BQ][LD]
  float* lses = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* deltas = lses + 2 * BQ;                               // [2][BQ]

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * BK;  // tile 0 meets the most query tiles: issued first
  const int nq = (p.Tq + BQ - 1) / BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wk = warp * 16 + g;  // the thread's first key in the tile; the other is wk + 8
  const float scale = LOG2E * rsqrtf((float)D);  // the forward's
  const float inv_keep = 1.f / p.keep;
  const unsigned hbh = DROP ? dropout_hash_bh(p.seed, p.b_off + b, p.h_off + h) : 0u;
  unsigned hcol[2];
  hcol[0] = dropout_hash_col(p.col_off + k0 + wk);
  hcol[1] = dropout_hash_col(p.col_off + k0 + wk + 8);
  const long long bh = (long long)b * p.H + h;

  // The first query tile whose last row reaches this key tile (the causal
  // gate is monotone in the query tile); nq when none does.
  const int lag = p.col_off + k0 - p.row_off;
  int qt0 = lag > 0 ? lag / BQ : 0;
  if (qt0 < nq && !tile_needed(p, qt0 * BQ, k0)) qt0 = nq;

  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* dob = d_o + b * st.d_o[0] + h * st.d_o[1];
  auto fetch = [&](int qt, int stage) {
    tc::load_rows<BQ, D, NT>(qs + stage * BQ * LD, qb, st.q[2], qt * BQ, p.Tq);
    tc::load_rows<BQ, D, NT>(dos + stage * BQ * LD, dob, st.d_o[2], qt * BQ, p.Tq);
    tc::load_stats<BQ, NT>(lses + stage * BQ, deltas + stage * BQ, lse + bh * p.Tq,
                               delta + bh * p.Tq, qt * BQ, p.Tq);
  };

  float dka[D / 8][4], dva[D / 8][4];  // keys wk, wk + 8 in C fragments
  tc::zero(dka);
  tc::zero(dva);
  if (qt0 < nq) {
    tc::load_rows<BK, D, NT>(ks, k + b * st.k[0] + h * st.k[1], st.k[2], k0, p.Tc);
    tc::load_rows<BK, D, NT>(vs, v + b * st.v[0] + h * st.v[1], st.v[2], k0, p.Tc);
    fetch(qt0, 0);
    tc::cp_async_commit();
  }

  for (int qt = qt0; qt < nq; ++qt) {
    const int stage = (qt - qt0) & 1;
    if (qt + 1 < nq) fetch(qt + 1, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // everything but the tile just requested has landed
    tc::scale_own_rows<BQ, D, NT>(qs + stage * BQ * LD, scale);
    __syncthreads();

    const bf16* qss = qs + stage * BQ * LD;
    const bf16* doss = dos + stage * BQ * LD;
    const float* ls = lses + stage * BQ;
    const float* dls = deltas + stage * BQ;
    const int q0 = qt * BQ;
    const bool masked = tile_masked(p, q0, k0);
    // The 16-query groups [lo, hi) this warp needs: those before lo lie
    // wholly before its first key, those from hi on past Tq; a warp whose
    // keys all lie past Tc needs none.
    const int reach = p.col_off + k0 + warp * 16 - p.row_off - q0 - 15;
    const int lo = reach <= 0 ? 0 : min(BQ / 16, (reach + 15) / 16);
    const int hi = k0 + warp * 16 >= p.Tc ? 0 : min(BQ / 16, (p.Tq - q0 + 15) / 16);

    float s[NJ][4], dp[NJ][4];  // S^T and dP^T: keys as rows, queries as columns
    tc::zero(s);
    tc::zero(dp);
    tc::mma_abt<BQ, D>(s, ks + warp * 16 * LD, qss, lo, hi);
    tc::mma_abt<BQ, D>(dp, vs + warp * 16 * LD, doss, lo, hi);

#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = j * 8 + 2 * tq;  // this thread's query columns c, c + 1
      const float2 lse2 = *reinterpret_cast<const float2*>(ls + c);
      const float2 del2 = *reinterpret_cast<const float2*>(dls + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c + (e & 1);
        const bool valid = !masked || attends(p, q0 + col, k0 + wk + (e >> 1) * 8);
        const float pv = valid ? exp2f(s[j][e] - ((e & 1) ? lse2.y : lse2.x)) : 0.f;
        float pd = pv, dpv = dp[j][e];
        if (DROP) {
          const bool kept = dropout_hash_finish(hbh ^ dropout_hash_row(p.row_off + q0 + col) ^
                                                hcol[e >> 1]) >= p.threshold;
          pd = kept ? pv * inv_keep : 0.f;
          dpv = kept ? dpv * inv_keep : 0.f;
        }
        s[j][e] = pv * (dpv - ((e & 1) ? del2.y : del2.x));  // ds^T
        dp[j][e] = pd;                                        // pd^T
      }
    }
    unsigned fa[BQ / 16][4];
    tc::to_a<BQ>(fa, dp);
    tc::mma_pb<BQ, D>(dva, fa, doss, lo, hi);
    tc::to_a<BQ>(fa, s);
    tc::mma_pb<BQ, D>(dka, fa, qss, lo, hi);
    __syncthreads();  // this stage is consumed before the next copy into it
  }

  // q carried scale = log2(e) / sqrt(D), so ds^T q_s is log2(e) times dk.
  tc::store_rows<D>(dk + b * st.dk[0] + h * st.dk[1], st.dk[2], dka, k0 + wk, p.Tc, LN2);
  tc::store_rows<D>(dv + b * st.dv[0] + h * st.dv[1], st.dv[2], dva, k0 + wk, p.Tc, 1.f);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(NT) flash_block_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, Strides st, Block p) {
  constexpr int LD = D + tc::PAD;
  constexpr int NJ = BK / 8;  // n8 tiles of keys a warp
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  bf16* qs = reinterpret_cast<bf16*>(smem_bwd);  // [BQ][LD] bf16(q * scale)
  bf16* dos = qs + BQ * LD;                        // [BQ][LD]
  bf16* ks = dos + BQ * LD;                        // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                     // [2][BK][LD]
  float* lses = reinterpret_cast<float*>(vs + 2 * BK * LD);  // [BQ]
  float* deltas = lses + BQ;                                  // [BQ]

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = warp * 16 + g;  // the thread's first row in the tile; the other is wr + 8
  const float scale = LOG2E * rsqrtf((float)D);  // the forward's
  const float inv_keep = 1.f / p.keep;
  unsigned hrow[2];
  if (DROP) {
    const unsigned hbh = dropout_hash_bh(p.seed, p.b_off + b, p.h_off + h);
    hrow[0] = hbh ^ dropout_hash_row(p.row_off + q0 + wr);
    hrow[1] = hbh ^ dropout_hash_row(p.row_off + q0 + wr + 8);
  }
  const long long bh = (long long)b * p.H + h;
  const int nk = needed_key_tiles(p, q0);

  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  if (nk > 0) {
    tc::load_rows<BQ, D, NT>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, p.Tq);
    tc::load_rows<BQ, D, NT>(dos, d_o + b * st.d_o[0] + h * st.d_o[1], st.d_o[2], q0, p.Tq);
    tc::load_stats<BQ, NT>(lses, deltas, lse + bh * p.Tq, delta + bh * p.Tq, q0, p.Tq);
    tc::load_rows<BK, D, NT>(ks, kb, st.k[2], 0, p.Tc);
    tc::load_rows<BK, D, NT>(vs, vb, st.v[2], 0, p.Tc);
    tc::cp_async_commit();
  }

  float dqa[D / 8][4];  // rows wr, wr + 8 in C fragments
  tc::zero(dqa);
  float lse_r[2], delta_r[2];

  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < nk) {
      tc::load_rows<BK, D, NT>(ks + (stage ^ 1) * BK * LD, kb, st.k[2], (kt + 1) * BK, p.Tc);
      tc::load_rows<BK, D, NT>(vs + (stage ^ 1) * BK * LD, vb, st.v[2], (kt + 1) * BK, p.Tc);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // everything but the tile just requested has landed
    if (kt == 0) tc::scale_own_rows<BQ, D, NT>(qs, scale);
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
    const int k0 = kt * BK;
    const bool masked = tile_masked(p, q0, k0);
    const int hi = needed_key_groups(p, q0 + warp * 16, k0);
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
        const bool valid = !masked || attends(p, q0 + wr + 8 * i, k0 + col);
        const float pv = valid ? exp2f(s[j][e] - lse_r[i]) : 0.f;
        float dpv = dp[j][e];
        if (DROP) {
          const bool kept = dropout_hash_finish(hrow[i] ^
                                                dropout_hash_col(p.col_off + k0 + col)) >=
                            p.threshold;
          dpv = kept ? dpv * inv_keep : 0.f;
        }
        s[j][e] = pv * (dpv - delta_r[i]);  // ds
      }
    unsigned fa[BK / 16][4];
    tc::to_a<BK>(fa, s);
    tc::mma_pb<BK, D>(dqa, fa, kss, 0, hi);
    __syncthreads();  // this stage is consumed before the next copy into it
  }

  tc::store_rows<D>(dq + b * st.dq[0] + h * st.dq[1], st.dq[2], dqa, q0 + wr, p.Tq,
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
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, const Strides& st, const Block& p,
               cudaStream_t stream) {
  // Q once, two stages of K and V.
  constexpr size_t smem = sizeof(bf16) * (BQ + 4 * BK) * (D + tc::PAD);
  static bool configured = false;
  cudaError_t e = set_smem(flash_block_fwd_kernel<D, DROP>, smem, configured);
  if (e != cudaSuccess) return (int)e;
  flash_block_fwd_kernel<D, DROP>
      <<<dim3(B * p.H, (p.Tq + BQ - 1) / BQ), NT, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse), st, p);
  return (int)cudaGetLastError();
}

template <int D, bool DROP>
int launch_bwd(const void* q, const void* k, const void* v, const void* d_o,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int B, const Strides& st, const Block& p,
               cudaStream_t stream) {
  constexpr int LD = D + tc::PAD;
  // dk/dv: K, V once, two stages of Q, dO, lse, delta; dq: Q, dO, lse,
  // delta once, two stages of K, V.
  constexpr size_t smem_dkdv = sizeof(bf16) * 6 * 64 * LD + sizeof(float) * 4 * BQ;
  constexpr size_t smem_dq = sizeof(bf16) * 6 * 64 * LD + sizeof(float) * 2 * BQ;
  static bool conf_dkdv = false, conf_dq = false;
  cudaError_t e =
      set_smem(flash_block_bwd_dkdv_kernel<D, DROP>, smem_dkdv, conf_dkdv);
  if (e != cudaSuccess) return (int)e;
  e = set_smem(flash_block_bwd_dq_kernel<D, DROP>, smem_dq, conf_dq);
  if (e != cudaSuccess) return (int)e;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* dop = static_cast<const bf16*>(d_o);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  flash_block_bwd_dkdv_kernel<D, DROP>
      <<<dim3(B * p.H, (p.Tc + BK - 1) / BK), NT, smem_dkdv, stream>>>(
          qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), st, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_block_bwd_dq_kernel<D, DROP>
      <<<dim3(B * p.H, (p.Tq + BQ - 1) / BQ), NT, smem_dq, stream>>>(
          qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dq), st, p);
  return (int)cudaGetLastError();
}

Block make_block(int H, int Tq, int Tc, int row_off, int col_off, int b_off,
                 int h_off, unsigned seed, unsigned threshold, float keep) {
  return Block{H, Tq, Tc, row_off, col_off, b_off, h_off, seed, threshold, keep};
}

// Whether every row of each of the n bf16 operands starts on a 16-byte
// boundary: 16-byte aligned pointers, (b, h, t) strides in `strides` (3 a
// operand) multiples of 8 elements.
bool rows_aligned(const void* const* ptrs, const long long* strides, int n) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] % 8 != 0) return false;
  }
  return true;
}

}  // namespace

// q, k, v, o: bf16 [B, H, Tq|Tc, D] with element strides (b, h, t) given
// in `strides` as 12 int64 (q, k, v, o in that order); the d stride is 1.
// lse: fp32 [B, H, Tq], contiguous. row_off / col_off are the global
// positions of q's first row and k's first column, b_off / h_off the
// global batch and head origins of the dropout hash. Dropout keeps hash
// bits >= threshold and divides the kept probabilities by `keep`;
// threshold 0 launches the kernel without dropout. Every row of q, k, v
// and o must start on a 16-byte boundary, else nothing is launched and
// cudaErrorInvalidValue is returned. Returns cudaGetLastError().
extern "C" int flash_block_fwd_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int H, int Tq, int Tc, int D,
                                    const long long* strides, int row_off,
                                    int col_off, int b_off, int h_off,
                                    unsigned seed, unsigned threshold,
                                    float keep, void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  if (!rows_aligned(ptrs, strides, 4)) return (int)cudaErrorInvalidValue;
  Strides st;
  long long* dst[4] = {st.q, st.k, st.v, st.o};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  const Block p = make_block(H, Tq, Tc, row_off, col_off, b_off, h_off, seed,
                             threshold, keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = threshold != 0u;
  switch (D) {
    case 32: return drop ? launch_fwd<32, true>(q, k, v, o, lse, B, st, p, s)
                         : launch_fwd<32, false>(q, k, v, o, lse, B, st, p, s);
    case 64: return drop ? launch_fwd<64, true>(q, k, v, o, lse, B, st, p, s)
                         : launch_fwd<64, false>(q, k, v, o, lse, B, st, p, s);
    case 128: return drop ? launch_fwd<128, true>(q, k, v, o, lse, B, st, p, s)
                          : launch_fwd<128, false>(q, k, v, o, lse, B, st, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, do, dq, dk, dv: bf16 with element strides (b, h, t) given in
// `strides` as 21 int64 (in that order); the d stride is 1. lse (the
// forward's, base 2) and delta (rowsum(do * o) - dlse * log2(e)): fp32
// [B, H, Tq], contiguous. Offsets and dropout as in flash_block_fwd_bf16.
// Every row of the bf16 operands must start on a 16-byte boundary, else
// nothing is launched and cudaErrorInvalidValue is returned. Launches the
// dk/dv kernel, then the dq kernel, on `stream`. Returns
// cudaGetLastError().
extern "C" int flash_block_bwd_bf16(const void* q, const void* k,
                                    const void* v, const void* d_o,
                                    const void* lse, const void* delta,
                                    void* dq, void* dk, void* dv, int B, int H,
                                    int Tq, int Tc, int D,
                                    const long long* strides, int row_off,
                                    int col_off, int b_off, int h_off,
                                    unsigned seed, unsigned threshold,
                                    float keep, void* stream) {
  const void* ptrs[7] = {q, k, v, d_o, dq, dk, dv};
  if (!rows_aligned(ptrs, strides, 7)) return (int)cudaErrorInvalidValue;
  Strides st;
  long long* dst[7] = {st.q, st.k, st.v, st.d_o, st.dq, st.dk, st.dv};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  const Block p = make_block(H, Tq, Tc, row_off, col_off, b_off, h_off, seed,
                             threshold, keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = threshold != 0u;
#define FLASH_BLOCK_BWD(DD, DROP)                                              \
  launch_bwd<DD, DROP>(q, k, v, d_o, lse, delta, dq, dk, dv, B, st, p, s)
  switch (D) {
    case 32: return drop ? FLASH_BLOCK_BWD(32, true) : FLASH_BLOCK_BWD(32, false);
    case 64: return drop ? FLASH_BLOCK_BWD(64, true) : FLASH_BLOCK_BWD(64, false);
    case 128: return drop ? FLASH_BLOCK_BWD(128, true) : FLASH_BLOCK_BWD(128, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BLOCK_BWD
}
