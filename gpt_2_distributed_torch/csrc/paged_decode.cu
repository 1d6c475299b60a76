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
// 3.35 TB/s, while the arithmetic is a few MFLOP. So the design keeps tens
// of KB of K/V in flight on every SM and spends few instructions a key.
//
// Design, two kernels launched together:
//   * paged_split_kernel: one block of 4 warps a (h, b, split). A split is
//     split_blocks whole pool blocks of the sequence (the wrapper's
//     split_blocks(bs), SPLIT_KEYS keys), so its boundaries are a function
//     of the sequence's length and bs alone: a row's bits do not depend on
//     the batch, the table width or the card. Splits at or past the length
//     exit at once, and only the table entries of blocks that hold data are
//     read, so table tails (the null block 0) are never followed. Each warp
//     takes every fourth tile of 32 keys of its split and copies each
//     tile's K and V rows into its own shared buffers with 16-byte cp.async
//     (rows past the length zero-filled, never read), two tiles in flight,
//     waiting on its own copies only. A lane a key, it forms the key's
//     score from q in registers (the scale folded into q in base 2 as on
//     the TPU) and the swizzled K row (row i's 16-byte chunk c at c ^
//     swizzle(i), so a quarter-warp's reads hit distinct banks); then one
//     max and one rescale a tile, p = exp2(s - m) in fp32, and P.V from
//     shared memory with each lane owning D/32 output dims. The warps'
//     (m, l, acc) merge in shared memory in a fixed order. A split that
//     holds the whole sequence (or none of it: an idle row) writes o;
//     otherwise it writes its fp32 partial (m, l, acc[D]) to the workspace.
//   * paged_combine_kernel: one block a (h, b) of a sequence with two or
//     more splits, which merges their partials in split order.
// No atomics: every sum has a fixed order, so two launches give the same
// bits. At D = 64 a block holds 67 KB of shared memory and 128 registers
// a thread, so three blocks an SM keep ~190 KB of K/V in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;                    // warps a block
constexpr int TK = 32;                   // keys a tile: a lane a key
constexpr int NBUF = 2;                  // tiles in flight a warp

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ int nsplits(int len, int bs, int split_blocks) {
  return ((len + bs - 1) / bs + split_blocks - 1) / split_blocks;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
struct Smem {
  static constexpr int CPR = D / 8;                 // 16-byte chunks a row
  static constexpr int TILE = TK * D;               // bf16 elements of a K (V) tile
  static constexpr int KV = NW * NBUF * TILE;       // bf16 elements of K (of V)
  static constexpr int BYTES = 2 * KV * 2 + NW * TK * 4 + NW * (D + 2) * 4;
  // Row i's chunk c lies at chunk c ^ swizzle(i): 8 neighbouring rows read
  // at one logical chunk touch 8 distinct 16-byte bank groups.
  __device__ static __forceinline__ int swizzle(int i) {
    return CPR >= 8 ? i % 8 : (i / (8 / CPR)) % CPR;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Warp `warp` of a split's block takes the split's tiles warp, warp + NW,
// ... (a tile is TK keys), with NBUF of them in flight: each lane finds the
// pool row of its own key of the tile (its table entry read straight from
// block_table; the split never reaches past the table's width), and the
// warp copies the tile's K and V rows into its own buffers, 16 bytes a
// cp.async, rows past the length zero-filled. No block barrier inside the
// loop: a warp waits for its own copies only.
template <int D>
__global__ void __launch_bounds__(NW * 32) paged_split_kernel(
    const bf16* __restrict__ q, long long q_sb, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ block_table,
    const int* __restrict__ lengths, bf16* __restrict__ o, float* __restrict__ ws,
    int H, int bs, int M, int split_blocks, int max_splits) {
  using S = Smem<D>;
  constexpr int CPR = S::CPR;
  constexpr int DL = D / 32;  // output dims a lane
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bf16* ks = reinterpret_cast<bf16*>(smem4) + warp * NBUF * S::TILE;
  bf16* vs = reinterpret_cast<bf16*>(smem4) + S::KV + warp * NBUF * S::TILE;
  float* pbuf = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem4) + 2 * S::KV) +
                warp * TK;
  float* mstate = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem4) + 2 * S::KV) +
                  NW * TK;  // [NW][D + 2]: m, l, acc

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int k0 = split * split_blocks * bs;  // the split's first key
  const int len = lengths[b];
  const int ns = nsplits(len, bs, split_blocks);
  if (split >= (ns > 1 ? ns : 1)) return;  // split 0 of an idle row writes zeros
  const int nkeys = max(0, min(len - k0, split_blocks * bs));
  const int ntiles = (nkeys + TK - 1) / TK;

  // Tile t's rows into buffer k % NBUF of this warp, k its index among the
  // warp's tiles.
  auto copy_tile = [&](int t, int k) {
    const int kk = t * TK + lane;  // this lane's key, within the split
    const bool mine = kk < nkeys;
    long long row = 0;
    if (mine) {
      const int j = kk / bs;
      row = ((long long)block_table[(long long)b * M + split * split_blocks + j] * H + h) * bs +
            (kk - j * bs);
    }
    bf16* kb = ks + (k % NBUF) * S::TILE;
    bf16* vb = vs + (k % NBUF) * S::TILE;
#pragma unroll
    for (int i = 0; i < CPR; ++i) {
      const int idx = lane + 32 * i;
      const int kl = idx / CPR, ch = idx % CPR;  // key within the tile, chunk
      const long long r = __shfl_sync(0xffffffffu, row, kl);
      const bool valid = t * TK + kl < nkeys;
      const int dst = kl * D + ((ch ^ S::swizzle(kl)) * 8);
      cp_async16(kb + dst, valid ? k_pool + r * D + ch * 8 : k_pool, valid ? 16 : 0);
      cp_async16(vb + dst, valid ? v_pool + r * D + ch * 8 : v_pool, valid ? 16 : 0);
    }
  };

#pragma unroll
  for (int k = 0; k < NBUF; ++k) {
    if (warp + k * NW < ntiles) copy_tile(warp + k * NW, k);
    cp_async_commit();
  }

  // q scaled to base 2, all D dims in every lane.
  const float scale = 1.4426950408889634f * rsqrtf((float)D);
  float qv[D];
  const bf16* qrow = q + b * q_sb + h * D;
#pragma unroll
  for (int e = 0; e < D; ++e) qv[e] = __bfloat162float(qrow[e]) * scale;

  float m = -INFINITY, l = 0.f, acc[DL];
#pragma unroll
  for (int e = 0; e < DL; ++e) acc[e] = 0.f;

  for (int t = warp, k = 0; t < ntiles; t += NW, ++k) {
    cp_async_wait<NBUF - 1>();
    __syncwarp();
    const bf16* kt = ks + (k % NBUF) * S::TILE;
    const bf16* vt = vs + (k % NBUF) * S::TILE;
    const int nvalid = min(TK, nkeys - t * TK);
    float s = -INFINITY;
    if (lane < nvalid) {
      const bf16* krow = kt + lane * D;
      const int sw = S::swizzle(lane);
      s = 0.f;
#pragma unroll
      for (int c = 0; c < CPR; ++c) {
        const uint4 u = *reinterpret_cast<const uint4*>(krow + ((c ^ sw) * 8));
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(k2[e]);
          s = fmaf(qv[c * 8 + 2 * e], f.x, s);
          s = fmaf(qv[c * 8 + 2 * e + 1], f.y, s);
        }
      }
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = exp2f(m - m_new);  // 0 on the first tile (m = -inf)
    const float p = exp2f(s - m_new);      // 0 past the length
    l = l * alpha + p;
    pbuf[lane] = p;
    __syncwarp();
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[e] *= alpha;
    const int d0 = lane * DL;  // this lane's dims: chunk d0 / 8, offset d0 % 8
#pragma unroll 8
    for (int kk = 0; kk < nvalid; ++kk) {
      const float pk = pbuf[kk];
      const bf16* vrow = vt + kk * D + (((d0 / 8) ^ S::swizzle(kk)) * 8) + d0 % 8;
      if constexpr (DL == 1) {
        acc[0] = fmaf(pk, __bfloat162float(vrow[0]), acc[0]);
      } else {
#pragma unroll
        for (int e = 0; e < DL; e += 2) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vrow + e));
          acc[e] = fmaf(pk, f.x, acc[e]);
          acc[e + 1] = fmaf(pk, f.y, acc[e + 1]);
        }
      }
    }
    m = m_new;
    __syncwarp();  // every lane is done with this buffer and with pbuf
    if (t + NBUF * NW < ntiles) copy_tile(t + NBUF * NW, k + NBUF);
    cp_async_commit();
  }

  // The warps' states, merged in warp order.
  l = warp_sum(l);
  float* st = mstate + warp * (D + 2);
  if (lane == 0) {
    st[0] = m;
    st[1] = l;
  }
#pragma unroll
  for (int e = 0; e < DL; ++e) st[2 + lane * DL + e] = acc[e];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += NW * 32) {
    float mt = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mt = fmaxf(mt, mstate[w * (D + 2)]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* sw = mstate + w * (D + 2);
      if (sw[1] > 0.f) {  // a warp that saw no key holds m = -inf, l = 0
        const float a = exp2f(sw[0] - mt);
        lt += sw[1] * a;
        at += sw[2 + d] * a;
      }
    }
    if (ns <= 1) {
      o[((long long)b * H + h) * D + d] = __float2bfloat16(lt > 0.f ? at / lt : 0.f);
    } else {
      float* part = ws + (((long long)b * H + h) * max_splits + split) * (D + 2);
      if (d == 0) {
        part[0] = mt;
        part[1] = lt;
      }
      part[2 + d] = at;
    }
  }
}

// The partials of a sequence with two or more splits, merged in split order.
template <int D>
__global__ void __launch_bounds__(D) paged_combine_kernel(
    const float* __restrict__ ws, const int* __restrict__ lengths,
    bf16* __restrict__ o, int H, int bs, int split_blocks, int max_splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int ns = nsplits(lengths[b], bs, split_blocks);
  if (ns <= 1) return;
  const float* part = ws + ((long long)b * H + h) * max_splits * (D + 2);
  float mt = -INFINITY;
  for (int s = 0; s < ns; ++s) mt = fmaxf(mt, part[s * (D + 2)]);
  float lt = 0.f, at = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float* st = part + s * (D + 2);
    const float a = exp2f(st[0] - mt);
    lt += st[1] * a;
    at += st[2 + d] * a;
  }
  o[((long long)b * H + h) * D + d] = __float2bfloat16(at / lt);
}

template <int D>
int launch(const void* q, long long q_sb, const void* kp, const void* vp,
           const void* table, const void* lengths, void* o, void* ws, int B, int H,
           int bs, int M, int split_blocks, cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int max_splits = (M + split_blocks - 1) / split_blocks;
  if (max_splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  paged_split_kernel<D><<<dim3(H, B, max_splits), NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), q_sb, static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<bf16*>(o), static_cast<float*>(ws),
      H, bs, M, split_blocks, max_splits);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || max_splits == 1) return (int)e;
  paged_combine_kernel<D><<<dim3(H, B), D, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(lengths),
      static_cast<bf16*>(o), H, bs, split_blocks, max_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// q: bf16 [B, H, D] with batch stride q_sb (head stride D, dim stride 1).
// k_pool, v_pool: bf16 [N, H, bs, D] contiguous (one layer's pool).
// block_table: int32 [B, M] contiguous; lengths: int32 [B].
// o: bf16 [B, H, D] contiguous. split_blocks: pool blocks a split; ws:
// fp32 [B, H, ceil(M / split_blocks), D + 2] (may be null when that is 1).
// Returns cudaGetLastError().
extern "C" int paged_decode_bf16(const void* q, long long q_sb, const void* k_pool,
                                 const void* v_pool, const void* block_table,
                                 const void* lengths, void* o, void* ws, int B, int H,
                                 int bs, int D, int M, int split_blocks, void* stream) {
  if (split_blocks < 1 || bs < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, q_sb, k_pool, v_pool, block_table, lengths, o, ws, B, H, bs, M, split_blocks, s);
    case 64: return launch<64>(q, q_sb, k_pool, v_pool, block_table, lengths, o, ws, B, H, bs, M, split_blocks, s);
    case 128: return launch<128>(q, q_sb, k_pool, v_pool, block_table, lengths, o, ws, B, H, bs, M, split_blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
