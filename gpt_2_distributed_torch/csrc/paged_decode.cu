// Paged decode attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces: gpt_2_distributed_tpu/ops/paged_attention.py::_paged_fwd_kernel
// (the Pallas TPU kernel built in paged_attention_pallas).
//
// Computes, for every sequence b and head h, one query row against the
// first lengths[b] cached positions of that sequence, which live in pool
// blocks block_table[b, 0 .. ceil(lengths[b] / bs) - 1]:
//   o[b, h] = softmax(q[b, h] . K[b, h]^T / sqrt(D)) @ V[b, h]
// lengths[b] == 0 marks an idle slot and writes exact zeros.
//
// What bounds it on the H100: bytes. Each cached K and V element is read
// once and used for two flops, so at the serving shape (8 sequences, 12
// heads, 1024 positions, D = 64) the ~25 MB of K/V take ~7.5 us at
// 3.35 TB/s, while the arithmetic is a few MFLOP.
//
// Design: one thread block per (h, b), eight warps. Each warp takes every
// eighth pool block of its sequence and walks its keys with its own
// online softmax (exp2, the scale folded into q in base 2 as on the TPU);
// lane i holds D/32 adjacent dims of q and of the accumulator, so each
// key's K row and V row are read by one warp as one coalesced 128-byte
// line at D = 64, and the q . k dot is a 5-step shuffle reduction. The
// block reads its own table row and length, visits only the blocks that
// hold data (table tails, which point at the null block 0, are never
// read), and reads every K/V row straight from its pool slot: no gathered
// [B, H, S, D] copy exists. The eight partial (m, l, acc) states merge in
// shared memory at the end. A later version keeps more loads in flight
// per warp (the per-key loop is latency-bound) and splits long sequences
// over more blocks than B * H.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NWARP = 8;

template <int D>
__global__ void __launch_bounds__(NWARP * 32) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, long long q_sb,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ block_table, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ o, int H, int bs, int M) {
  constexpr int DL = D / 32;  // dims per lane
  __shared__ float sm[NWARP];
  __shared__ float sl[NWARP];
  __shared__ float sacc[NWARP][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = lengths[b];
  const float scale = 1.4426950408889634f * rsqrtf((float)D);

  float qv[DL], acc[DL];
  const __nv_bfloat16* qrow = q + b * q_sb + h * D + lane * DL;
#pragma unroll
  for (int e = 0; e < DL; ++e) {
    qv[e] = __bfloat162float(qrow[e]) * scale;
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int nblk = (len + bs - 1) / bs;
  for (int j = warp; j < nblk; j += NWARP) {
    const long long slot = (long long)block_table[b * M + j] * H + h;
    const __nv_bfloat16* kb = k_pool + slot * bs * D + lane * DL;
    const __nv_bfloat16* vb = v_pool + slot * bs * D + lane * DL;
    const int n = min(bs, len - j * bs);
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      float kr[DL], vr[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        kr[e] = __bfloat162float(kb[i * D + e]);
        vr[e] = __bfloat162float(vb[i * D + e]);
      }
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) s = fmaf(qv[e], kr[e], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const float m_new = fmaxf(m, s);
      const float alpha = exp2f(m - m_new);  // 0 on the first key (m = -inf)
      const float p = exp2f(s - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[e] = fmaf(p, vr[e], acc[e] * alpha);
      m = m_new;
    }
  }

  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < DL; ++e) sacc[warp][lane * DL + e] = acc[e];
  __syncthreads();

  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mt = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) mt = fmaxf(mt, sm[w]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      if (sl[w] > 0.f) {  // a warp that saw no key holds m = -inf, l = 0
        const float a = exp2f(sm[w] - mt);
        lt += sl[w] * a;
        at += sacc[w][d] * a;
      }
    }
    o[((long long)b * H + h) * D + d] = __float2bfloat16(lt > 0.f ? at / lt : 0.f);
  }
}

template <int D>
int launch(const void* q, long long q_sb, const void* kp, const void* vp,
           const void* table, const void* lengths, void* o, int B, int H,
           int bs, int M, cudaStream_t stream) {
  dim3 grid(H, B);
  paged_decode_kernel<D><<<grid, NWARP * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), q_sb,
      static_cast<const __nv_bfloat16*>(kp), static_cast<const __nv_bfloat16*>(vp),
      static_cast<const int*>(table), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(o), H, bs, M);
  return (int)cudaGetLastError();
}

}  // namespace

// q: bf16 [B, H, D] with batch stride q_sb (head stride D, dim stride 1).
// k_pool, v_pool: bf16 [N, H, bs, D] contiguous (one layer's pool).
// block_table: int32 [B, M] contiguous; lengths: int32 [B].
// o: bf16 [B, H, D] contiguous. Returns cudaGetLastError().
extern "C" int paged_decode_bf16(const void* q, long long q_sb, const void* k_pool,
                                 const void* v_pool, const void* block_table,
                                 const void* lengths, void* o, int B, int H,
                                 int bs, int D, int M, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, q_sb, k_pool, v_pool, block_table, lengths, o, B, H, bs, M, s);
    case 64: return launch<64>(q, q_sb, k_pool, v_pool, block_table, lengths, o, B, H, bs, M, s);
    case 128: return launch<128>(q, q_sb, k_pool, v_pool, block_table, lengths, o, B, H, bs, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
