// masked_conv1d_ds: the depthwise conv's score (or weight) gradient,
// ds[t, c] = (sum_{b,s} x_pad[b, s + t, c] * g[b, s, c]) * w * sigmoid'(s).
//
// Replaces the Pallas kernel `_conv_ds_kernel` / `masked_conv1d_ds` in
// src/repro/kernels/masked_matmul.py.
//
// Epilogue 0 ("ste") multiplies the f32 correlation by
// w * sigmoid(s) * (1 - sigmoid(s)), the straight-through score gradient;
// epilogue 1 ("dw") returns the raw correlation, the weight gradient of the
// plain conv (w and s unread).  x_pad is x with W - 1 leading zeros,
// applied by index.  x: (B, S, C) bf16 or f32; g: (B, S, C) f32 (the
// cotangent of the conv's f32 output); w: (W, C) bf16; s: (W, C) f32;
// ds: (W, C) f32.
//
// Design: a block owns a tile of 32 channels and reduces over all of B
// and S itself, so there are no atomics and no cross-block reduction.  Its
// 256 threads are 8 rows of 32 channels: row r walks the time steps
// s = r, r + 8, ... of every batch row and keeps W partial sums in
// registers; the 8 rows' sums then meet in shared memory, added in row
// order, and the epilogue is applied in registers.  A warp reads 32
// neighbouring channels of one time step.
//
// Bound on this card: the bytes of x and g, read once (6 bytes per
// element with bf16 x), against 2W flops per element; at the main paths'
// (B 2, S 128, C 2304..4096) a launch reads 1.8..3.1 MB, about 1 us at
// 3.35 TB/s, and with C / 32 = 72..128 blocks it fills under one wave of
// the card's 132 SMs, so launch latency and the serial walk over S set
// its time.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int CH = 32;    // channels per block (one warp's width)
constexpr int ROWS = 8;   // time-step lanes per channel
constexpr int MAX_W = 8;  // taps held in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(CH * ROWS)
masked_conv1d_ds_kernel(const T* __restrict__ x, const float* __restrict__ g,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ s, float* __restrict__ ds,
                        int B, int S, int C, int W, int epilogue) {
  __shared__ float part[ROWS][MAX_W][CH];
  const int lane = threadIdx.x % CH, r = threadIdx.x / CH;
  const int c = blockIdx.x * CH + lane;
  float acc[MAX_W] = {};
  if (c < C) {
    for (int b = 0; b < B; ++b) {
      const T* xb = x + (int64_t)b * S * C;
      const float* gb = g + (int64_t)b * S * C;
      for (int i = r; i < S; i += ROWS) {
        const float gv = gb[(int64_t)i * C + c];
#pragma unroll
        for (int t = 0; t < MAX_W; ++t) {
          if (t >= W) break;
          const int src = i + t - (W - 1);
          if (src >= 0) acc[t] = fmaf(to_f32(xb[(int64_t)src * C + c]), gv,
                                      acc[t]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < MAX_W; ++t) part[r][t][lane] = acc[t];
  __syncthreads();
  // threads t*CH + lane (t < W) finish tap t of channel c
  const int t = r;
  if (t >= W || c >= C) return;
  float sum = part[0][t][lane];
#pragma unroll
  for (int q = 1; q < ROWS; ++q) sum += part[q][t][lane];
  const int64_t o = (int64_t)t * C + c;
  if (epilogue == 0) {
    const float sig = repro::sigmoid(s[o]);
    sum = sum * __bfloat162float(w[o]) * sig * (1.0f - sig);
  }
  ds[o] = sum;
}

}  // namespace

extern "C" int masked_conv1d_ds(const void* x, const void* g, const void* w,
                                const void* s, void* ds, int B, int S, int C,
                                int W, int epilogue, int x_f32,
                                void* stream) {
  if (W < 1 || W > MAX_W || W > ROWS) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + CH - 1) / CH);
  const cudaStream_t st = (cudaStream_t)stream;
  if (x_f32)
    masked_conv1d_ds_kernel<float><<<grid, CH * ROWS, 0, st>>>(
        (const float*)x, (const float*)g, (const __nv_bfloat16*)w,
        (const float*)s, (float*)ds, B, S, C, W, epilogue);
  else
    masked_conv1d_ds_kernel<__nv_bfloat16><<<grid, CH * ROWS, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)g, (const __nv_bfloat16*)w,
        (const float*)s, (float*)ds, B, S, C, W, epilogue);
  return (int)cudaGetLastError();
}
