// masked_matmul_grouped_ds: ds[e] = (x[e]^T @ g[e]) * w[e] *
// sigmoid(s[e]) * (1 - sigmoid(s[e])), the STE score gradient of the
// grouped (MoE expert) projection.
//
// Replaces the Pallas kernel `_g_ds_kernel` / `masked_matmul_grouped_ds` in
// src/repro/kernels/masked_matmul.py.
//
// x: (E, M, K) f32, g: (E, M, N) f32, w: (E, K, N) bf16, s: (E, K, N) f32,
// ds: (E, K, N) f32 (the reference casts to s.dtype).
//
// Design: `ds_tile` in masked_matmul_tiles.cuh with the group on the
// grid's z axis: one block per (e, K-tile, N-tile), looping over all of M
// inside the block, the epilogue acc * w * sigmoid(s)(1 - sigmoid(s))
// applied in registers; no atomics, no second pass.
//
// Bound on this card: reading w (bf16) and s (f32) and writing ds (f32),
// 10 bytes per weight (1.85 GB, 0.55 ms at 3.35 TB/s at E = 64,
// K x N = 2048 x 1408), against 2*M = 60 f32 flops per weight at the
// capacity M = 30: bytes bind.
#include "masked_matmul_tiles.cuh"

namespace {

__global__ void __launch_bounds__(repro::THREADS)
masked_matmul_grouped_ds_kernel(const float* __restrict__ x,
                                const float* __restrict__ g,
                                const __nv_bfloat16* __restrict__ w,
                                const float* __restrict__ s,
                                float* __restrict__ ds, int M, int K,
                                int N) {
  const int64_t e = blockIdx.z;
  repro::ds_tile(x + e * M * K, g + e * M * N, w + e * K * N, s + e * K * N,
                 ds + e * K * N, M, K, N);
}

}  // namespace

extern "C" int masked_matmul_grouped_ds(const void* x, const void* g,
                                        const void* w, const void* s,
                                        void* ds, int E, int M, int K, int N,
                                        void* stream) {
  masked_matmul_grouped_ds_kernel<<<repro::tile_grid(K, N, E),
                                    repro::THREADS, 0,
                                    (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (const __nv_bfloat16*)w,
      (const float*)s, (float*)ds, M, K, N);
  return (int)cudaGetLastError();
}
