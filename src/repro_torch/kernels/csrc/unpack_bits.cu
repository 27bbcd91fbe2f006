// unpack_bits: (R, W) uint32 words -> (R, n) uint8 {0,1} rows, n <= 32W.
//
// Replaces the Pallas kernel `_unpack_kernel` / `unpack_bits` in
// src/repro/kernels/bitpack.py.
//
// Element i of a row is bit i % 32 of word i / 32 (little-endian); bits
// at or past n are dropped.  The reference unpacks one (W,) word vector to
// a (W, 32) block and slices it to n, and vmaps that over a round's C rows
// (`repro.api.payloads.mean_from_words`); here one launch covers all R
// rows and writes the (R, n) result directly, with no (R, 32W)
// intermediate and no slice copy.  With R = 1 this is exactly the TPU
// kernel.
//
// Design: one thread per word, writing that word's <= 32 bytes.  The
// thread stores 16 bytes at a time where the piece lies inside the row
// and row bases are 16-byte aligned (output pointer aligned and
// n % 16 == 0: the wrapper decides), byte by byte otherwise; no byte
// at or past n is written.  Neighbouring threads write neighbouring
// 32-byte pieces.  Indices are int64 (rows of up to 402,653,184 bits).
//
// Bound on this card: the bytes (n/8 read, n written) over the memory
// rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint4 unpack16(uint32_t half) {
  // bits 0..15 of `half` -> 16 bytes, little-endian within each lane
  uint32_t lanes[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) v |= ((half >> (4 * q + b)) & 1u) << (8 * b);
    lanes[q] = v;
  }
  return make_uint4(lanes[0], lanes[1], lanes[2], lanes[3]);
}

__global__ void __launch_bounds__(THREADS)
unpack_bits_kernel(const uint32_t* __restrict__ words,
                   uint8_t* __restrict__ bits, int64_t R, int64_t n,
                   int64_t W, int aligned) {
  const int64_t Wn = (n + 31) / 32;  // words that hold elements below n
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= R * Wn) return;
  const int64_t r = t / Wn;
  const int64_t w = t - r * Wn;
  const uint32_t word = words[r * W + w];
  uint8_t* row = bits + r * n;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int64_t i = w * 32 + 16 * c;
    const uint32_t half = word >> (16 * c);
    if (aligned && i + 16 <= n) {
      *reinterpret_cast<uint4*>(row + i) = unpack16(half);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (i + j < n) row[i + j] = (uint8_t)((half >> j) & 1u);
      }
    }
  }
}

}  // namespace

extern "C" int unpack_bits(const void* words, void* bits, int64_t R,
                           int64_t W, int64_t n, int aligned, void* stream) {
  const int64_t Wn = (n + 31) / 32;
  const int64_t blocks = (R * Wn + THREADS - 1) / THREADS;
  unpack_bits_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint8_t*)bits, R, n, W, aligned);
  return (int)cudaGetLastError();
}
