// masked_matmul_grouped: y[e] = x[e] @ (m[e] * w[e]) for E stacked
// problems (the MoE expert projections), one launch for all groups.
//
// Replaces the Pallas kernel `_g_kernel` / `masked_matmul_grouped` in
// src/repro/kernels/masked_matmul.py.
//
// Group e's mask is drawn at flat index offs[e] + k*n_logical + n of
// seeds[e]'s stream (mode 0), or is 1[sigmoid(s) > tau] (mode 1); with
// offs[e] = (l*E + e)*K*N mod 2^32 the E masks are exactly layer l's slice
// of the (L, E, K, N) leaf's uplink stream.  seeds and offs are (E,)
// uint32 device arrays.  x: (E, M, K) f32 (the reference keeps the expert
// chain in f32), w: (E, K, N) bf16, s: (E, K, N) f32, y: (E, M, N) f32.
//
// Design: the dense forward's tiled SIMT GEMM (`fwd_tile` in
// masked_matmul_tiles.cuh) with the group on the grid's z axis; each block
// reads its group's seed and offset and offsets its pointers by the
// group.  Ragged M, K and N are masked in the loads and stores.
//
// Bound on this card: at the main path's expert shapes (E = 64, M = the
// capacity 30, K x N = 2048 x 1408) the bytes of w and s, 6 per weight
// (1.1 GB, 0.34 ms at 3.35 TB/s), against 2*M = 60 f32 flops per weight
// (0.17 ms on the CUDA cores).  A 64-row tile at M = 30 leaves half its
// rows idle, and each weight's hash and sigmoid are computed once per
// launch; the kernel's time is written beside the bound in PERF.md.
#include "masked_matmul_tiles.cuh"

namespace {

__global__ void __launch_bounds__(repro::THREADS)
masked_matmul_grouped_kernel(const float* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ s,
                             const uint32_t* __restrict__ seeds,
                             const uint32_t* __restrict__ offs,
                             float* __restrict__ y, int M, int K, int N,
                             uint32_t n_logical, int mode, float tau) {
  const int64_t e = blockIdx.z;
  repro::fwd_tile(x + e * M * K, w + e * K * N, s + e * K * N, y + e * M * N,
                  M, K, N, seeds[e], offs[e], n_logical, mode, tau);
}

}  // namespace

extern "C" int masked_matmul_grouped(const void* x, const void* w,
                                     const void* s, const void* seeds,
                                     const void* offs, void* y, int E, int M,
                                     int K, int N, uint32_t n_logical,
                                     int mode, float tau, void* stream) {
  masked_matmul_grouped_kernel<<<repro::tile_grid(M, N, E), repro::THREADS,
                                 0, (cudaStream_t)stream>>>(
      (const float*)x, (const __nv_bfloat16*)w, (const float*)s,
      (const uint32_t*)seeds, (const uint32_t*)offs, (float*)y, M, K, N,
      n_logical, mode, tau);
  return (int)cudaGetLastError();
}
