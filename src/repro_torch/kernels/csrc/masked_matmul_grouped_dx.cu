// masked_matmul_grouped_dx: dx[e] = g[e] @ (m[e] * w[e])^T, the STE input
// gradient of the grouped (MoE expert) projection.
//
// Replaces the Pallas kernel `_g_dx_kernel` / `masked_matmul_grouped_dx` in
// src/repro/kernels/masked_matmul.py.
//
// Group e regenerates the grouped forward's mask from the same
// (seeds[e], offs[e] + k*n_logical + n) stream, bit for bit.  g: (E, M, N)
// f32, w: (E, K, N) bf16, s: (E, K, N) f32, seeds/offs: (E,) uint32 device
// arrays, dx: (E, M, K) f32 (the reference casts to g.dtype).
//
// Design: the dense dx tile scheme (`dx_tile` in masked_matmul_tiles.cuh)
// with the group on the grid's z axis: each block owns a 64x64 tile of
// dx[e] over (M, K) and accumulates over N inside the block, so there is
// no reduction across blocks.
//
// Bound on this card: as the grouped forward, the 6 bytes per weight of w
// and s (1.1 GB, 0.34 ms at 3.35 TB/s at E = 64, K x N = 2048 x 1408),
// above the 2*M f32 flops per weight at the capacity M = 30.
#include "masked_matmul_tiles.cuh"

namespace {

__global__ void __launch_bounds__(repro::THREADS)
masked_matmul_grouped_dx_kernel(const float* __restrict__ g,
                                const __nv_bfloat16* __restrict__ w,
                                const float* __restrict__ s,
                                const uint32_t* __restrict__ seeds,
                                const uint32_t* __restrict__ offs,
                                float* __restrict__ dx, int M, int K, int N,
                                uint32_t n_logical, int mode, float tau) {
  const int64_t e = blockIdx.z;
  repro::dx_tile(g + e * M * N, w + e * K * N, s + e * K * N,
                 dx + e * M * K, M, K, N, seeds[e], offs[e], n_logical, mode,
                 tau);
}

}  // namespace

extern "C" int masked_matmul_grouped_dx(const void* g, const void* w,
                                        const void* s, const void* seeds,
                                        const void* offs, void* dx, int E,
                                        int M, int K, int N,
                                        uint32_t n_logical, int mode,
                                        float tau, void* stream) {
  masked_matmul_grouped_dx_kernel<<<repro::tile_grid(M, K, E),
                                    repro::THREADS, 0,
                                    (cudaStream_t)stream>>>(
      (const float*)g, (const __nv_bfloat16*)w, (const float*)s,
      (const uint32_t*)seeds, (const uint32_t*)offs, (float*)dx, M, K, N,
      n_logical, mode, tau);
  return (int)cudaGetLastError();
}
