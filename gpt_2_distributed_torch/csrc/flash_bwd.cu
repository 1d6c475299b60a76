// Causal flash-attention backward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: gpt_2_distributed_tpu/ops/flash_attention.py::_bwd_kernel
// (the Pallas TPU kernel built in _build._raw_bwd), with its in-kernel
// dropout. The forward is csrc/flash_fwd.cu (K1).
//
// Computes, for every (b, h), from q, k, v, do (bf16 [B, H, T, D]), K1's
// base-2 lse and delta = rowsum(do * o) (fp32 [B, H, T], o the dropped
// output), with s = q . k * log2(e) / sqrt(D):
//   p   = exp2(s - lse)            the normalized, UNDROPPED probability
//   dpd = do . v
//   dp  = keep * dpd / kp,  pd = keep * p / kp     (kp = 1 - rate)
//   ds  = p * (dp - delta)
//   dq  = ds k / sqrt(D),  dk = ds^T q / sqrt(D),  dv = pd^T do
// keep[t, j] is dropout_hash_bits(seed, b, h, t, j) >= threshold on
// absolute coordinates, the mask K1 drew. Everything is fp32 in the
// kernel; dq, dk and dv are rounded to bf16 once, on write.
//
// What bounds it on the H100: at the training shape [4, 12, 1024, 64] the
// five causal products are ~16 GFLOP (~16 us on the bf16 tensor cores)
// and the operands ~50 MB (~15 us at 3.35 TB/s); what bounds THIS version
// is the fp32 arithmetic on the CUDA cores (no tensor cores yet) and the
// shared-memory traffic of its inner products.
//
// Design: the TPU kernel walks one (b, h) in order and accumulates dk/dv
// for the whole sequence in a VMEM-resident [T, D] output across its
// sequential q-block grid axis. On Hopper blocks run in no order, so the
// work is split into two kernels, each of which owns what it writes and
// needs no atomics (the same inputs give bit-identical grads):
//   * the dk/dv kernel: one block per (b, h, 64-key tile), looping over
//     the q-tiles from the diagonal to T with dk and dv in registers;
//   * the dq kernel: one block per (b, h, 64-row q-tile), looping over the
//     k-tiles up to the diagonal with dq in registers.
// Both rebuild p from lse and the mask from the hash, so nothing of size
// T x T is ever stored. Tiles are staged in shared memory as fp32 (q
// pre-scaled as in K1); 256 threads each own a 4x4 patch of the 64x64
// score tile and a 4 x D/16 patch of their accumulators. Rows and keys
// past T are masked in the kernels, so any T >= 1 is taken. Blocks are
// issued longest loop first. Faster versions (wgmma, TMA) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dropout_hash.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads: a 16 x 16 grid of 4x4 patches
constexpr int PP = BK + 1;
constexpr float LN2 = 0.6931471805599453f;  // 1 / log2(e)

struct Strides {  // element strides (b, h, t) of each [B, H, T, D] operand
  long long q[3], k[3], v[3], d_o[3], dq[3], dk[3], dv[3];
};

// Load rows [t0, t0 + 64) of one (b, h) slice of x into xs[64][D + 1] as
// fp32 times `mul`, zeros past T.
template <int D>
__device__ __forceinline__ void load_tile(float* xs, const __nv_bfloat16* x,
                                          long long st, int t0, int T,
                                          float mul) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    const int t = t0 + r;
    xs[r * (D + 1) + c] = t < T ? __bfloat162float(x[t * st + c]) * mul : 0.f;
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

// From the score tile s and dpd = do . v of q rows q0 + ty*4 + r and keys
// k0 + tx*4 + c, write ds (and pd, when pds is given) into [64][PP] tiles.
template <bool DROP>
__device__ __forceinline__ void ds_tile(
    const float s[4][4], const float dpd[4][4], const float* lses,
    const float* deltas, float* dss, float* pds, int q0, int k0, int T,
    int ty, int tx, unsigned hbh, unsigned threshold, float keep) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
    const int row = q0 + i;
    const float lse_r = lses[i], delta_r = deltas[i];
    const unsigned hr = DROP ? hbh ^ dropout_hash_row(row) : 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx * 4 + c;
      const int col = k0 + j;
      const float p = (col <= row && row < T) ? exp2f(s[r][c] - lse_r) : 0.f;
      float pd = p, dp = dpd[r][c];
      if (DROP) {
        const bool kept =
            dropout_hash_finish(hr ^ dropout_hash_col(col)) >= threshold;
        pd = kept ? p / keep : 0.f;
        dp = kept ? dp / keep : 0.f;
      }
      dss[i * PP + j] = p * (dp - delta_r);
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
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
    int T, Strides st, unsigned seed, unsigned threshold, float keep) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][DP] q * scale
  float* dos = qs + BQ * DP;    // [BQ][DP]
  float* ks = dos + BQ * DP;    // [BK][DP]
  float* vs = ks + BK * DP;     // [BK][DP]
  float* pds = vs + BK * DP;    // [BQ][PP]
  float* dss = pds + BQ * PP;   // [BQ][PP]
  float* lses = dss + BQ * PP;  // [BQ]
  float* deltas = lses + BQ;    // [BQ]

  const int kt = blockIdx.x;  // tile 0 loops over every q-tile: issued first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int k0 = kt * BK;
  const int nq = (T + BQ - 1) / BQ;
  const float scale = 1.4426950408889634f * rsqrtf((float)D);
  const unsigned hbh = DROP ? dropout_hash_bh(seed, b, h) : 0u;
  const long long bh = (long long)b * H + h;

  load_tile<D>(ks, k + b * st.k[0] + h * st.k[1], st.k[2], k0, T, 1.f);
  load_tile<D>(vs, v + b * st.v[0] + h * st.v[1], st.v[2], k0, T, 1.f);

  float dka[4][DC], dva[4][DC];  // key rows ty*4 + r, columns tx*DC + c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[r][c] = dva[r][c] = 0.f;

  // BQ == BK, so q-tile qt reaches key tile kt iff qt >= kt.
  for (int qt = kt; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's qs / dos / pds / dss are consumed
    load_tile<D>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, T, scale);
    load_tile<D>(dos, d_o + b * st.d_o[0] + h * st.d_o[1], st.d_o[2], q0, T, 1.f);
    load_row_stats(lses, deltas, lse + bh * T, delta + bh * T, q0, T);
    __syncthreads();

    float s[4][4], dpd[4][4];
    tile_dot<D>(qs, ks, s, ty, tx);
    tile_dot<D>(dos, vs, dpd, ty, tx);
    ds_tile<DROP>(s, dpd, lses, deltas, dss, pds, q0, k0, T, ty, tx, hbh,
                  threshold, keep);
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
    if (t >= T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      // q carried scale * log2(e), so ds^T q is log2(e) too large.
      dkb[t * st.dk[2] + tx * DC + c] = __float2bfloat16(dka[r][c] * LN2);
      dvb[t * st.dv[2] + tx * DC + c] = __float2bfloat16(dva[r][c]);
    }
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int H, int T, Strides st, unsigned seed,
    unsigned threshold, float keep) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][DP] q * scale
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
  const float scale = 1.4426950408889634f * rsqrtf((float)D);
  const unsigned hbh = DROP ? dropout_hash_bh(seed, b, h) : 0u;
  const long long bh = (long long)b * H + h;

  load_tile<D>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, T, scale);
  load_tile<D>(dos, d_o + b * st.d_o[0] + h * st.d_o[1], st.d_o[2], q0, T, 1.f);
  load_row_stats(lses, deltas, lse + bh * T, delta + bh * T, q0, T);

  float dqa[4][DC];  // q rows ty*4 + r, columns tx*DC + c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dqa[r][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's ks / vs / dss are consumed
    load_tile<D>(ks, k + b * st.k[0] + h * st.k[1], st.k[2], k0, T, 1.f);
    load_tile<D>(vs, v + b * st.v[0] + h * st.v[1], st.v[2], k0, T, 1.f);
    __syncthreads();

    float s[4][4], dpd[4][4];
    tile_dot<D>(qs, ks, s, ty, tx);
    tile_dot<D>(dos, vs, dpd, ty, tx);
    ds_tile<DROP>(s, dpd, lses, deltas, dss, nullptr, q0, k0, T, ty, tx, hbh,
                  threshold, keep);
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
    if (t >= T) continue;
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
int launch(const void* q, const void* k, const void* v, const void* d_o,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int B, int H, int T, const Strides& st, unsigned seed,
           unsigned threshold, float keep, cudaStream_t stream) {
  constexpr int DP = D + 1;
  constexpr size_t smem_dkdv =
      sizeof(float) * (4 * 64 * DP + 2 * BQ * PP + 2 * BQ);
  constexpr size_t smem_dq = sizeof(float) * (4 * 64 * DP + BQ * PP + 2 * BQ);
  static bool conf_dkdv = false, conf_dq = false;
  cudaError_t e = set_smem(flash_bwd_dkdv_kernel<D, DROP>, smem_dkdv, conf_dkdv);
  if (e != cudaSuccess) return (int)e;
  e = set_smem(flash_bwd_dq_kernel<D, DROP>, smem_dq, conf_dq);
  if (e != cudaSuccess) return (int)e;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(d_o);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  const int nt = (T + 63) / 64;
  flash_bwd_dkdv_kernel<D, DROP><<<dim3(nt, H, B), NT, smem_dkdv, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, T, st, seed, threshold, keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<D, DROP><<<dim3(nt, H, B), NT, smem_dq, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<__nv_bfloat16*>(dq), H, T, st,
      seed, threshold, keep);
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
// contiguous. Dropout as in flash_fwd_bf16 (threshold 0 = none). Launches
// the dk/dv kernel, then the dq kernel, on `stream`. Returns
// cudaGetLastError().
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* d_o, const void* lse,
                              const void* delta, void* dq, void* dk, void* dv,
                              int B, int H, int T, int D,
                              const long long* strides, unsigned seed,
                              unsigned threshold, float keep, void* stream) {
  Strides st;
  long long* dst[7] = {st.q, st.k, st.v, st.d_o, st.dq, st.dk, st.dv};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_d<32>(q, k, v, d_o, lse, delta, dq, dk, dv, B, H, T, st, seed, threshold, keep, s);
    case 64: return launch_d<64>(q, k, v, d_o, lse, delta, dq, dk, dv, B, H, T, st, seed, threshold, keep, s);
    case 128: return launch_d<128>(q, k, v, d_o, lse, delta, dq, dk, dv, B, H, T, st, seed, threshold, keep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
