// pack_bits: (R, n) uint8 {0,1} rows -> (R, ceil(n/32)) uint32 words.
//
// Replaces the Pallas kernel `_pack_kernel` / `pack_bits` in
// src/repro/kernels/bitpack.py.
//
// Bit j of word w of a row carries element 32w + j (little-endian); bits
// at or past n are zero, which is the reference's zero-pad-to-32 followed
// by its pack (`repro.kernels.ops.pack_bits`).  The word is the sum of
// (uint32_t)b << j in wrapping uint32, as the reference sums its shifted
// uint32 bits, so any byte values give the reference's word.  With R = 1
// and n % 32 == 0 this is exactly the TPU kernel.
//
// Design: one thread per word.  A thread reads its 32 bytes as two 16-byte
// loads when they lie inside the row and the row bases are 16-byte aligned
// (base pointer aligned and n % 16 == 0: the wrapper decides), and byte by
// byte otherwise (a ragged row length such as mamba2's w_in leaves every
// row start misaligned).  Neighbouring threads read neighbouring 32-byte
// pieces, so a warp reads 1 KiB contiguously.  Word and row indices are
// int64: one row of a layer-stacked leaf holds up to 402,653,184 bits.
//
// Bound on this card: the bytes (n read, n/8 written) over the memory
// rate; there is one shift-add per byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t pack16(uint4 v) {
  // the 16 bytes of v, little-endian within each 32-bit lane
  const uint32_t lanes[4] = {v.x, v.y, v.z, v.w};
  uint32_t out = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      out += ((lanes[q] >> (8 * b)) & 0xFFu) << (4 * q + b);
    }
  }
  return out;
}

__global__ void __launch_bounds__(THREADS)
pack_bits_kernel(const uint8_t* __restrict__ bits, uint32_t* __restrict__ words,
                 int64_t R, int64_t n, int64_t W, int aligned) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= R * W) return;
  const int64_t r = t / W;
  const int64_t w = t - r * W;
  const int64_t i0 = w * 32;
  const uint8_t* row = bits + r * n;
  uint32_t out = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int64_t i = i0 + 16 * c;
    if (aligned && i + 16 <= n) {
      out += pack16(*reinterpret_cast<const uint4*>(row + i)) << (16 * c);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (i + j < n) out += (uint32_t)row[i + j] << (16 * c + j);
      }
    }
  }
  words[t] = out;
}

}  // namespace

extern "C" int pack_bits(const void* bits, void* words, int64_t R, int64_t n,
                         int aligned, void* stream) {
  const int64_t W = (n + 31) / 32;
  const int64_t blocks = (R * W + THREADS - 1) / THREADS;
  pack_bits_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (uint32_t*)words, R, n, W, aligned);
  return (int)cudaGetLastError();
}
