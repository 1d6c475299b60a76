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
// epilogues (K4-K6, csrc/fused_layer.cu) hash (0, salt, flattened row,
// feature). A position is kept when bits >= uint32(int(rate * 2^32)).
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
