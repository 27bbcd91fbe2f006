// Counter-based mask stream shared by every kernel of the port.
//
// Port of `_hash_uniform` / `_tile_mask_vals` in
// src/repro/kernels/masked_matmul.py: a splitmix32-style avalanche of the
// global uint32 element index, with the seed avalanched separately and
// injected twice.  All arithmetic is uint32 and wraps, exactly as the
// reference's jnp.uint32 pipeline, so a mask bit depends only on
// (seed, index) and never on how a kernel tiles the matrix.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace repro {

__device__ __forceinline__ uint32_t seed_mix(uint32_t seed) {
  uint32_t s = seed + 1u;
  s = (s ^ (s >> 16)) * 0x45D9F3B5u;
  return s ^ (s >> 11);
}

// u in [0, 1) on the 2^-24 grid; `smix` is seed_mix(seed).
__device__ __forceinline__ float hash_uniform(uint32_t idx, uint32_t smix) {
  uint32_t x = idx + 0x9E3779B9u * smix;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ smix ^ (x >> 13)) * 0xC2B2AE35u;
  x = x ^ (x >> 16);
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// mode 0: Bernoulli m = 1[u(idx) < sigmoid(s)]; mode 1: threshold
// m = 1[sigmoid(s) > tau] (FedMask; the index is unused).
__device__ __forceinline__ bool mask_bit(float s, uint32_t idx, uint32_t smix,
                                         int mode, float tau) {
  float theta = sigmoid(s);
  if (mode == 1) return theta > tau;
  return hash_uniform(idx, smix) < theta;
}

}  // namespace repro
