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
//   o   = sum_c keep * exp2(s - m) / (1 - rate) * v / l
// o normalised over this block only, and the base-2 lse [B, H, Tq] in
// fp32, which is what the ring's block-level combine needs. A row with no
// attended column (a block wholly in the row's future) writes o = 0 and
// lse = NEG_INF (-1e30) exactly. keep is dropout_hash_bits(seed,
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
// What bounds it on the H100: one full [4, 12, 512, 64] block (sp = 2 at
// 124M) is ~3.2 GFLOP forward (~3.3 us on the bf16 tensor cores) and
// ~12.7 MB of operands (~3.8 us at 3.35 TB/s); what bounds THIS version is
// the fp32 arithmetic on the CUDA cores (no tensor cores yet) and the
// shared-memory traffic of its inner products, as in K1 and K2.
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
// every tile is skipped still writes its rows' o = 0 and lse = NEG_INF.
// 256 threads each own a 4x4 patch of the 64x64 score tile and a
// 4 x D/16 patch of the accumulators. Faster versions (wgmma, TMA) are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dropout_hash.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads: a 16 x 16 grid of 4x4 patches
constexpr int PP = BK + 1;
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

__device__ __forceinline__ float scaled_q(float x, float scale) {
  return __bfloat162float(__float2bfloat16(x * scale));
}

// Load rows [t0, t0 + 64) of one (b, h) slice of x into xs[64][D + 1] as
// fp32, zeros past T; with `q_scale` > 0 each value is bf16(x * q_scale).
template <int D>
__device__ __forceinline__ void load_tile(float* xs, const __nv_bfloat16* x,
                                          long long st, int t0, int T,
                                          float q_scale) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    const int t = t0 + r;
    float val = t < T ? __bfloat162float(x[t * st + c]) : 0.f;
    if (q_scale > 0.f) val = scaled_q(val, q_scale);
    xs[r * (D + 1) + c] = val;
  }
}

// s[r][c] = a[ty*4 + r] . b[tx*4 + c] over the D columns of two staged tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         float s[4][4], int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    float ar[4], bc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) ar[r] = a[(ty * 4 + r) * DP + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bc[c] = b[(tx * 4 + c) * DP + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(ar[r], bc[c], s[r][c]);
  }
}

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

template <int D, bool DROP>
__global__ void __launch_bounds__(NT) flash_block_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, Strides st, Block p) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;           // [BQ][DP] bf16(q * scale)
  float* ks = qs + BQ * DP;   // [BK][DP]
  float* vs = ks + BK * DP;   // [BK][DP]
  float* ps = vs + BK * DP;   // [BQ][PP]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = qt * BQ;
  const float scale = LOG2E * rsqrtf((float)D);
  unsigned hrow[4];
  if (DROP) {
    const unsigned hbh = dropout_hash_bh(p.seed, p.b_off + b, p.h_off + h);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      hrow[r] = hbh ^ dropout_hash_row(p.row_off + q0 + ty * 4 + r);
  }

  load_tile<D>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, p.Tq, scale);
  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[1];
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[1];

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.Tc && tile_needed(p, q0, k0); k0 += BK) {
    const bool masked = tile_masked(p, q0, k0);
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    load_tile<D>(ks, kb, st.k[2], k0, p.Tc, 0.f);
    load_tile<D>(vs, vb, st.v[2], k0, p.Tc, 0.f);
    __syncthreads();

    float s[4][4];
    tile_dot<D>(qs, ks, s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (masked && !attends(p, row, k0 + tx * 4 + c)) s[r][c] = -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      // The 16 threads of a row are lanes tx = 0..15 of one half-warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // A row may have no attended key yet (m_new = -inf): its l and acc
      // are still 0, and its masked p are forced to 0, never exp2(NaN).
      const float m_new = fmaxf(m[r], mx);
      const float alpha = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float pv = s[r][c] == -INFINITY ? 0.f : exp2f(s[r][c] - m_new);
        sum += pv;
        if (DROP) {
          const unsigned bits = dropout_hash_finish(
              hrow[r] ^ dropout_hash_col(p.col_off + k0 + tx * 4 + c));
          pv = bits >= p.threshold ? pv / p.keep : 0.f;
        }
        ps[(ty * 4 + r) * PP + tx * 4 + c] = pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float vj[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vj[c] = vs[j * DP + tx * DC + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pv = ps[(ty * 4 + r) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pv, vj[c], acc[r][c]);
      }
    }
  }

  __nv_bfloat16* ob = o + b * st.o[0] + h * st.o[1];
  float* lb = lse + ((long long)b * p.H + h) * p.Tq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= p.Tq) continue;
    const bool has = l[r] > 0.f;
    const float inv = has ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[row * st.o[2] + tx * DC + c] = __float2bfloat16(acc[r][c] * inv);
    if (tx == 0) lb[row] = has ? m[r] + log2f(l[r]) : NEG_INF;
  }
}

// From the score tile s and dpd = do . v of q rows q0 + ty*4 + r and keys
// k0 + tx*4 + c, write ds (and pd, when pds is given) into [64][PP] tiles.
template <bool DROP>
__device__ __forceinline__ void ds_tile(
    const Block& p, const float s[4][4], const float dpd[4][4],
    const float* lses, const float* deltas, float* dss, float* pds, int q0,
    int k0, int ty, int tx, unsigned hbh) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
    const int row = q0 + i;
    const float lse_r = lses[i], delta_r = deltas[i];
    const unsigned hr = DROP ? hbh ^ dropout_hash_row(p.row_off + row) : 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx * 4 + c;
      const int col = k0 + j;
      const float pv = attends(p, row, col) ? exp2f(s[r][c] - lse_r) : 0.f;
      float pd = pv, dp = dpd[r][c];
      if (DROP) {
        const bool kept = dropout_hash_finish(
                              hr ^ dropout_hash_col(p.col_off + col)) >=
                          p.threshold;
        pd = kept ? pv / p.keep : 0.f;
        dp = kept ? dp / p.keep : 0.f;
      }
      dss[i * PP + j] = pv * (dp - delta_r);
      if (pds != nullptr) pds[i * PP + j] = pd;
    }
  }
}

__device__ __forceinline__ void load_row_stats(float* lses, float* deltas,
                                               const float* lse,
                                               const float* delta, int t0,
                                               int T) {
  if (threadIdx.x < 64) {
    const int t = t0 + threadIdx.x;
    lses[threadIdx.x] = t < T ? lse[t] : 0.f;
    deltas[threadIdx.x] = t < T ? delta[t] : 0.f;
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(NT) flash_block_bwd_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    Strides st, Block p) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][DP] bf16(q * scale)
  float* dos = qs + BQ * DP;    // [BQ][DP]
  float* ks = dos + BQ * DP;    // [BK][DP]
  float* vs = ks + BK * DP;     // [BK][DP]
  float* pds = vs + BK * DP;    // [BQ][PP]
  float* dss = pds + BQ * PP;   // [BQ][PP]
  float* lses = dss + BQ * PP;  // [BQ]
  float* deltas = lses + BQ;    // [BQ]

  const int k0 = blockIdx.x * BK;  // tile 0 meets the most q-tiles: first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float scale = LOG2E * rsqrtf((float)D);
  const unsigned hbh =
      DROP ? dropout_hash_bh(p.seed, p.b_off + b, p.h_off + h) : 0u;
  const long long bh = (long long)b * p.H + h;

  load_tile<D>(ks, k + b * st.k[0] + h * st.k[1], st.k[2], k0, p.Tc, 0.f);
  load_tile<D>(vs, v + b * st.v[0] + h * st.v[1], st.v[2], k0, p.Tc, 0.f);

  float dka[4][DC], dva[4][DC];  // key rows ty*4 + r, columns tx*DC + c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[r][c] = dva[r][c] = 0.f;

  for (int q0 = 0; q0 < p.Tq; q0 += BQ) {
    if (!tile_needed(p, q0, k0)) continue;  // the same for the whole block
    __syncthreads();  // the previous tile's qs / dos / pds / dss are consumed
    load_tile<D>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, p.Tq, scale);
    load_tile<D>(dos, d_o + b * st.d_o[0] + h * st.d_o[1], st.d_o[2], q0, p.Tq,
                 0.f);
    load_row_stats(lses, deltas, lse + bh * p.Tq, delta + bh * p.Tq, q0, p.Tq);
    __syncthreads();

    float s[4][4], dpd[4][4];
    tile_dot<D>(qs, ks, s, ty, tx);
    tile_dot<D>(dos, vs, dpd, ty, tx);
    ds_tile<DROP>(p, s, dpd, lses, deltas, dss, pds, q0, k0, ty, tx, hbh);
    __syncthreads();

    for (int i = 0; i < BQ; ++i) {
      float dor[DC], qr[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dor[c] = dos[i * DP + tx * DC + c];
        qr[c] = qs[i * DP + tx * DC + c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pd = pds[i * PP + ty * 4 + r];
        const float ds = dss[i * PP + ty * 4 + r];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dva[r][c] = fmaf(pd, dor[c], dva[r][c]);
          dka[r][c] = fmaf(ds, qr[c], dka[r][c]);
        }
      }
    }
  }

  __nv_bfloat16* dkb = dk + b * st.dk[0] + h * st.dk[1];
  __nv_bfloat16* dvb = dv + b * st.dv[0] + h * st.dv[1];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = k0 + ty * 4 + r;
    if (t >= p.Tc) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      // q carried scale * log2(e), so ds^T q is log2(e) too large.
      dkb[t * st.dk[2] + tx * DC + c] = __float2bfloat16(dka[r][c] * LN2);
      dvb[t * st.dv[2] + tx * DC + c] = __float2bfloat16(dva[r][c]);
    }
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(NT) flash_block_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, Strides st, Block p) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][DP] bf16(q * scale)
  float* dos = qs + BQ * DP;    // [BQ][DP]
  float* ks = dos + BQ * DP;    // [BK][DP]
  float* vs = ks + BK * DP;     // [BK][DP]
  float* dss = vs + BK * DP;    // [BQ][PP]
  float* lses = dss + BQ * PP;  // [BQ]
  float* deltas = lses + BQ;    // [BQ]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = qt * BQ;
  const float scale = LOG2E * rsqrtf((float)D);
  const unsigned hbh =
      DROP ? dropout_hash_bh(p.seed, p.b_off + b, p.h_off + h) : 0u;
  const long long bh = (long long)b * p.H + h;

  load_tile<D>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, p.Tq, scale);
  load_tile<D>(dos, d_o + b * st.d_o[0] + h * st.d_o[1], st.d_o[2], q0, p.Tq,
               0.f);
  load_row_stats(lses, deltas, lse + bh * p.Tq, delta + bh * p.Tq, q0, p.Tq);

  float dqa[4][DC];  // q rows ty*4 + r, columns tx*DC + c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dqa[r][c] = 0.f;

  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[1];
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[1];
  for (int k0 = 0; k0 < p.Tc && tile_needed(p, q0, k0); k0 += BK) {
    __syncthreads();  // the previous tile's ks / vs / dss are consumed
    load_tile<D>(ks, kb, st.k[2], k0, p.Tc, 0.f);
    load_tile<D>(vs, vb, st.v[2], k0, p.Tc, 0.f);
    __syncthreads();

    float s[4][4], dpd[4][4];
    tile_dot<D>(qs, ks, s, ty, tx);
    tile_dot<D>(dos, vs, dpd, ty, tx);
    ds_tile<DROP>(p, s, dpd, lses, deltas, dss, nullptr, q0, k0, ty, tx, hbh);
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float kr[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kr[c] = ks[j * DP + tx * DC + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = dss[(ty * 4 + r) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) dqa[r][c] = fmaf(ds, kr[c], dqa[r][c]);
      }
    }
  }

  __nv_bfloat16* dqb = dq + b * st.dq[0] + h * st.dq[1];
  const float inv_sqrt_d = rsqrtf((float)D);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + ty * 4 + r;
    if (t >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dqb[t * st.dq[2] + tx * DC + c] = __float2bfloat16(dqa[r][c] * inv_sqrt_d);
  }
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
  constexpr size_t smem = sizeof(float) * ((BQ + 2 * BK) * (D + 1) + BQ * PP);
  static bool configured = false;
  cudaError_t e = set_smem(flash_block_fwd_kernel<D, DROP>, smem, configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.Tq + BQ - 1) / BQ, p.H, B);
  flash_block_fwd_kernel<D, DROP><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), st, p);
  return (int)cudaGetLastError();
}

template <int D, bool DROP>
int launch_bwd(const void* q, const void* k, const void* v, const void* d_o,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int B, const Strides& st, const Block& p,
               cudaStream_t stream) {
  constexpr int DP = D + 1;
  constexpr size_t smem_dkdv =
      sizeof(float) * (4 * 64 * DP + 2 * BQ * PP + 2 * BQ);
  constexpr size_t smem_dq = sizeof(float) * (4 * 64 * DP + BQ * PP + 2 * BQ);
  static bool conf_dkdv = false, conf_dq = false;
  cudaError_t e =
      set_smem(flash_block_bwd_dkdv_kernel<D, DROP>, smem_dkdv, conf_dkdv);
  if (e != cudaSuccess) return (int)e;
  e = set_smem(flash_block_bwd_dq_kernel<D, DROP>, smem_dq, conf_dq);
  if (e != cudaSuccess) return (int)e;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(d_o);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  flash_block_bwd_dkdv_kernel<D, DROP>
      <<<dim3((p.Tc + BK - 1) / BK, p.H, B), NT, smem_dkdv, stream>>>(
          qp, kp, vp, dop, lp, dp, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), st, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_block_bwd_dq_kernel<D, DROP>
      <<<dim3((p.Tq + BQ - 1) / BQ, p.H, B), NT, smem_dq, stream>>>(
          qp, kp, vp, dop, lp, dp, static_cast<__nv_bfloat16*>(dq), st, p);
  return (int)cudaGetLastError();
}

Block make_block(int H, int Tq, int Tc, int row_off, int col_off, int b_off,
                 int h_off, unsigned seed, unsigned threshold, float keep) {
  return Block{H, Tq, Tc, row_off, col_off, b_off, h_off, seed, threshold, keep};
}

}  // namespace

// q, k, v, o: bf16 [B, H, Tq|Tc, D] with element strides (b, h, t) given
// in `strides` as 12 int64 (q, k, v, o in that order); the d stride is 1.
// lse: fp32 [B, H, Tq], contiguous. row_off / col_off are the global
// positions of q's first row and k's first column, b_off / h_off the
// global batch and head origins of the dropout hash. Dropout keeps hash
// bits >= threshold and divides the kept probabilities by `keep`;
// threshold 0 launches the kernel without dropout. Returns
// cudaGetLastError().
extern "C" int flash_block_fwd_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int H, int Tq, int Tc, int D,
                                    const long long* strides, int row_off,
                                    int col_off, int b_off, int h_off,
                                    unsigned seed, unsigned threshold,
                                    float keep, void* stream) {
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
// Launches the dk/dv kernel, then the dq kernel, on `stream`. Returns
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
