// The dropout stream of the port's kernels, in uint32 on the card.
//
// dropout_hash_bits(seed, b, h, row, col) of
// gpt_2_distributed_torch/ops/spmd.py (gpt_2_distributed_tpu/ops/spmd.py in
// the JAX package): a murmur3-finalizer hash of absolute coordinates mixed
// with the seed. It is split so the (b, h) part is formed once per block
// and the row and column parts once per row and column:
//   bits = dropout_hash_finish(dropout_hash_bh(seed, b, h)
//                              ^ dropout_hash_row(row) ^ dropout_hash_col(col))
// The flash kernels (K1, K2) hash (batch, head, query row, key); the layer
// epilogues (K4-K6, csrc/fused_layer.cu) and the fused matmuls (K7,
// csrc/fused_matmul.cu) hash (0, salt, flattened row, feature) through
// `Dropout` below. A position is kept when bits >= uint32(int(rate * 2^32)).
#pragma once

__host__ __device__ __forceinline__ unsigned dropout_hash_bh(unsigned seed,
                                                             unsigned b,
                                                             unsigned h) {
  return seed ^ (b * 0x9E3779B1u) ^ (h * 0x85EBCA77u);
}
__host__ __device__ __forceinline__ unsigned dropout_hash_row(unsigned row) {
  return row * 0xC2B2AE3Du;
}
__host__ __device__ __forceinline__ unsigned dropout_hash_col(unsigned col) {
  return col * 0x27D4EB2Fu;
}
__host__ __device__ __forceinline__ unsigned dropout_hash_finish(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// One epilogue dropout site: the (0, salt) part of the hash, the keep
// threshold and the keep probability divided by; `on` is false at rate 0.
struct Dropout {
  unsigned bh, threshold;
  float keep;
  bool on;
  __device__ __forceinline__ unsigned row_part(unsigned row) const {
    return bh ^ dropout_hash_row(row);
  }
  __device__ __forceinline__ bool kept(unsigned hr, unsigned col) const {
    return dropout_hash_finish(hr ^ dropout_hash_col(col)) >= threshold;
  }
};

inline Dropout make_dropout(unsigned seed, unsigned salt, unsigned threshold,
                            float keep) {
  return Dropout{dropout_hash_bh(seed, 0u, salt), threshold, keep, threshold != 0u};
}
