// Causal flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: gpt_2_distributed_tpu/ops/flash_attention.py::_fwd_kernel
// (the Pallas TPU kernel built in _build._raw_fwd), forward only and
// without dropout: serving is deterministic; the backward and the
// in-kernel dropout come with the training slice.
//
// Computes, for every (b, h) and every query row t < T,
//   o[t]   = softmax_j<=t(q[t] . k[j] / sqrt(D)) @ v
//   lse[t] = log2(sum_j<=t exp2(q[t] . k[j] * log2(e) / sqrt(D)))
// with the scale folded into q in base 2, as the TPU kernel does, so a
// later backward kernel can rebuild the probabilities from lse.
//
// What bounds it on the H100: at the serving shapes (T <= 1024, D = 64)
// the inputs are a few MB, read in ~2 us at 3.35 TB/s, and the causal
// product is ~1.6 GFLOP per 12-head prefill, ~1.6 us on the bf16 tensor
// cores. Both are tiny; what bounds THIS version is the arithmetic on the
// fp32 CUDA cores (no tensor cores yet) and the shared-memory traffic of
// its inner products.
//
// Design: the TPU kernel carries m, l and acc across a sequential grid
// axis over k-blocks; here each thread block owns one (b, h, 64-row
// q-tile) and loops over the k-tiles up to its diagonal itself, so nothing
// carries between blocks. Q, K and V tiles are staged in shared memory as
// fp32; 256 threads each own a 4x4 patch of the 64x64 score tile and a
// 4 x D/16 patch of the output accumulator, all in fp32 registers. The
// online-softmax row max and row sum are reduced across the 16 threads
// that share a row with warp shuffles. Rows past T in the last q-tile and
// keys past T in the last k-tile are masked in the kernel, so any T >= 1
// is taken (the prefill bucket gives multiples of the block size). Every
// causal row keeps its diagonal, so each row's running sum is positive
// and the final divide needs no guard. Blocks are issued longest q-tile
// first so the causal imbalance does not leave a long tail.
// Faster versions (wgmma, TMA, a producer warp) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads: a 16 x 16 grid of 4x4 patches

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int T,
    long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost) {
  constexpr int DP = D + 1;   // padded rows spread column reads over banks
  constexpr int PP = BK + 1;
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;           // [BQ][DP]
  float* ks = qs + BQ * DP;   // [BK][DP]
  float* vs = ks + BK * DP;   // [BK][DP]
  float* ps = vs + BK * DP;   // [BQ][PP]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = qt * BQ;
  const float scale = 1.4426950408889634f * rsqrtf((float)D);

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int t = q0 + r;
    qs[r * DP + c] = t < T ? __bfloat162float(qb[t * qst + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  // BQ == BK, so q-tile qt's diagonal lies in k-tile qt.
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int t = k0 + r;
      const bool in = t < T;
      ks[r * DP + c] = in ? __bfloat162float(kb[t * kst + c]) : 0.f;
      vs[r * DP + c] = in ? __bfloat162float(vb[t * vst + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qr[4], kc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qr[r] = qs[(ty * 4 + r) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = ks[(tx * 4 + c) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx * 4 + c;
        if (col > row || col >= T) s[r][c] = -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      // The 16 threads of a row are lanes tx = 0..15 of one half-warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // Every row has an unmasked key in every tile it visits (column k0
      // is <= its row), so mx is finite here.
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[r][c] - m_new);
        sum += p;
        ps[(ty * 4 + r) * PP + tx * 4 + c] = p;
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
        const float p = ps[(ty * 4 + r) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p, vj[c], acc[r][c]);
      }
    }
  }

  __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= T) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[row * ost + tx * DC + c] = __float2bfloat16(acc[r][c] * inv);
    if (tx == 0) lse[((long long)b * H + h) * T + row] = m[r] + log2f(l[r]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int T, const long long* st, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, T,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: bf16 [B, H, T, D] with element strides (b, h, t) given in
// `strides` as 12 int64 (q, k, v, o in that order); the d stride is 1.
// lse: fp32 [B, H, T], contiguous. Returns cudaGetLastError().
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int T, int D,
                              const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, lse, B, H, T, strides, s);
    case 64: return launch<64>(q, k, v, o, lse, B, H, T, strides, s);
    case 128: return launch<128>(q, k, v, o, lse, B, H, T, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
