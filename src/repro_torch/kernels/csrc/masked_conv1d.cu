// masked_conv1d: depthwise causal conv through the masked (W, C) kernel
// leaf, y[b, s, c] = sum_t x_pad[b, s + t, c] * (m * w)[t, c], f32 output.
//
// Replaces the Pallas kernel `_conv_kernel` / `masked_conv1d` in
// src/repro/kernels/masked_matmul.py.
//
// m = 1[hash_u(seed, off + t*n_logical + c) < sigmoid(s[t, c])] (mode 0),
// 1[sigmoid(s[t, c]) > tau] (mode 1), or no mask at all (mode 2, "plain":
// pre-materialized weights, s unread).  x_pad is x with W - 1 leading zeros
// on the time axis (the causal forward); with `flip` the taps run reversed
// (row W-1-t at shift t) over W - 1 trailing zeros, which is dL/dx of the
// causal conv with the same regenerated mask.  The padding is applied by
// index: no padded copy exists in memory.  x: (B, S, C) bf16 (the forward,
// whose input is the bf16 output of a masked projection) or f32 (the
// flipped pass over the f32 cotangent); w: (W, C) bf16; s: (W, C) f32.
//
// The taps accumulate in t order with separately rounded products and
// sums (__fmul_rn / __fadd_rn, no FMA contraction): the plain PyTorch
// version's arithmetic, so kernel and plain version agree bit for bit.
//
// Design: one thread per channel, a block per (128-channel tile, batch row,
// chunk of S).  Each thread forms its W gated taps once in registers (hash
// and sigmoid W times), then streams down its chunk of S; the W reads of
// one output hit L1, and a warp reads 32 neighbouring channels (64 or 128
// contiguous bytes).
//
// Bound on this card: the bytes of x (read) and y (written), ~6 (bf16 x)
// or 8 (f32 x) bytes per output against 2W flops per output; at the main
// paths' (B 2, S 128, C 2304..4096) a launch moves 1.8..3.1 MB, about 1 us
// at 3.35 TB/s, so launch latency sets its time.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int S_CHUNK = 16;   // time steps per block
constexpr int MAX_W = 8;      // taps held in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
masked_conv1d_kernel(const T* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ s, float* __restrict__ y,
                     int S, int C, int W, uint32_t seed, uint32_t off,
                     uint32_t n_logical, int mode, float tau, int flip) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const int64_t b = blockIdx.y;
  const uint32_t smix = repro::seed_mix(seed);
  // tap[t]: the gated weight applied at shift t (row W-1-t when flipped)
  float tap[MAX_W];
#pragma unroll
  for (int t = 0; t < MAX_W; ++t) {
    if (t >= W) break;
    const int row = flip ? W - 1 - t : t;
    const int64_t o = (int64_t)row * C + c;
    const bool keep =
        mode == 2 || repro::mask_bit(s[o],
                                     off + (uint32_t)row * n_logical +
                                         (uint32_t)c,
                                     smix, mode, tau);
    tap[t] = keep ? __bfloat162float(w[o]) : 0.0f;
  }
  const T* xb = x + b * S * C;
  float* yb = y + b * S * C;
  const int s0 = blockIdx.z * S_CHUNK;
  const int s1 = min(s0 + S_CHUNK, S);
  for (int i = s0; i < s1; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < MAX_W; ++t) {
      if (t >= W) break;
      // x_pad[i + t]: x[i + t - (W-1)] causally, x[i + t] flipped
      const int src = flip ? i + t : i + t - (W - 1);
      const float v =
          (src >= 0 && src < S) ? to_f32(xb[(int64_t)src * C + c]) : 0.0f;
      const float term = __fmul_rn(v, tap[t]);
      acc = t == 0 ? term : __fadd_rn(acc, term);
    }
    yb[(int64_t)i * C + c] = acc;
  }
}

}  // namespace

extern "C" int masked_conv1d(const void* x, const void* w, const void* s,
                             void* y, int B, int S, int C, int W,
                             uint32_t seed, uint32_t off, uint32_t n_logical,
                             int mode, float tau, int flip, int x_f32,
                             void* stream) {
  if (W < 1 || W > MAX_W) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + THREADS - 1) / THREADS, B,
                  (S + S_CHUNK - 1) / S_CHUNK);
  const cudaStream_t st = (cudaStream_t)stream;
  if (x_f32)
    masked_conv1d_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)x, (const __nv_bfloat16*)w, (const float*)s, (float*)y,
        S, C, W, seed, off, n_logical, mode, tau, flip);
  else
    masked_conv1d_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)s,
        (float*)y, S, C, W, seed, off, n_logical, mode, tau, flip);
  return (int)cudaGetLastError();
}
