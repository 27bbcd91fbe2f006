// sample_and_pack: (C, n) scores -> (C, ceil(n/32)) packed mask words.
//
// Replaces the Pallas kernel `_sap_kernel` / `sample_and_pack` in
// src/repro/kernels/masked_matmul.py.
//
// Row c's bit i is m = 1[hash_u(seeds[c], i) < sigmoid(s[c, i])] (mode 0)
// or 1[sigmoid(s[c, i]) > tau] (mode 1); bit j of word k carries element
// 32k + j (little-endian), and bits at or past n are zero, as the
// reference's pad-then-pack produces.
//
// Design: one lane per element and one warp per word.  Each lane reads
// one score (a warp reads 128 contiguous bytes), forms its bit, and
// __ballot_sync gathers the warp's 32 bits into the word, which lane 0
// stores.  One launch covers all C rows (blockIdx.y) with per-row seeds.
// Element offsets are int64: a row of a layer-stacked leaf holds up to
// 24 * 2048 * 8192 = 402,653,184 scores.
//
// Bound on this card: the bytes of the scores (4 per element) read once;
// the words written are 1/32 of that.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WORDS_PER_BLOCK = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
sample_and_pack_kernel(const float* __restrict__ s,
                       const uint32_t* __restrict__ seeds,
                       uint32_t* __restrict__ words, int64_t n, int64_t W,
                       int mode, float tau) {
  const int64_t c = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int64_t word =
      (int64_t)blockIdx.x * WORDS_PER_BLOCK + threadIdx.x / 32;
  if (word >= W) return;  // uniform across the warp
  const int64_t i = word * 32 + lane;
  bool m = false;
  if (i < n) {
    const uint32_t smix = repro::seed_mix(seeds[c]);
    m = repro::mask_bit(s[c * n + i], (uint32_t)i, smix, mode, tau);
  }
  const uint32_t bits = __ballot_sync(0xffffffffu, m);
  if (lane == 0) words[c * W + word] = bits;
}

}  // namespace

extern "C" int sample_and_pack(const void* s, const void* seeds, void* words,
                               int C, int64_t n, int mode, float tau,
                               void* stream) {
  const int64_t W = (n + 31) / 32;
  const dim3 grid((unsigned)((W + WORDS_PER_BLOCK - 1) / WORDS_PER_BLOCK), C);
  sample_and_pack_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)s, (const uint32_t*)seeds, (uint32_t*)words, n, W, mode,
      tau);
  return (int)cudaGetLastError();
}
