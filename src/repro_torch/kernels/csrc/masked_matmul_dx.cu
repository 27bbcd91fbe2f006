// masked_matmul_dx: dx = g @ (m * w)^T, the STE input gradient.
//
// Replaces the Pallas kernel `_dx_kernel` / `masked_matmul_dx` in
// src/repro/kernels/masked_matmul.py:227.
//
// The mask is regenerated from the same (seed, off + k*n_logical + n) hash
// stream as the forward, so it is bit-identical to the forward's.
// w: bf16, s: f32 or bf16 (widened exactly); g and dx: bf16, or f32 (the
// cotangent of an f32 forward); the reference casts to g.dtype.
//
// Bound on this card: as the forward's, 6 bytes a weight of w and s plus
// g and dx at M = 256: 0.120 ms per internlm2-1.8b layer at 3.35 TB/s.
//
// Design, bf16 g: the forward's tensor-core body (masked_matmul_wgmma.cuh)
// with the reduction over n: A = g is K-major over n as it lies, and the
// gating warps read each raw (k, n) tile of w and s along n and write the
// transposed m*w tile from registers, so the transposition is free.  Each
// weight is gated once per launch (per 256 rows), the N axis is split over
// a cluster of <= 8 blocks and reduced through distributed shared memory
// in a fixed order.  f32 g keeps the SIMT body of masked_matmul_tiles.cuh
// (`dx_tile`).
#include "masked_matmul_tiles.cuh"
#include "masked_matmul_wgmma.cuh"

namespace {

template <typename S>
__global__ void __launch_bounds__(repro::THREADS)
masked_matmul_dx_f32(const float* __restrict__ g,
                     const __nv_bfloat16* __restrict__ w,
                     const S* __restrict__ s, float* __restrict__ dx,
                     int M, int K, int N, uint32_t seed, uint32_t off,
                     uint32_t n_logical, int mode, float tau) {
  repro::dx_tile(g, w, s, dx, M, K, N, seed, off, n_logical, mode, tau);
}

}  // namespace

// s_bf16: the scores are bf16 (f32 otherwise); bc, split, w_stages, smem,
// tma: the bf16 body's launch plan (kernels.masked_matmul.wgmma_plan);
// unread for f32 g.
extern "C" int masked_matmul_dx(const void* g, const void* w, const void* s,
                               void* dx, int M, int K, int N, uint32_t seed,
                               uint32_t off, uint32_t n_logical, int mode,
                               float tau, int x_f32, int s_bf16, int bc,
                               int split, int w_stages, int smem, int tma,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!x_f32)
    return repro::wg::launch<true>(g, w, s, dx, M, K, N, seed, off,
                                   n_logical, mode, tau, s_bf16, bc, split,
                                   w_stages, smem, tma, st);
  const dim3 grid = repro::tile_grid(M, K);
  if (s_bf16)
    masked_matmul_dx_f32<<<grid, repro::THREADS, 0, st>>>(
        (const float*)g, (const __nv_bfloat16*)w, (const __nv_bfloat16*)s,
        (float*)dx, M, K, N, seed, off, n_logical, mode, tau);
  else
    masked_matmul_dx_f32<<<grid, repro::THREADS, 0, st>>>(
        (const float*)g, (const __nv_bfloat16*)w, (const float*)s,
        (float*)dx, M, K, N, seed, off, n_logical, mode, tau);
  return (int)cudaGetLastError();
}

// Blocks of the bf16 body at width bc and cluster size split (of its
// bf16-score build where s_bf16) that the card holds at once, for the
// launch plan; a negative cudaError on failure.
extern "C" int masked_matmul_dx_capacity(int bc, int split, int smem, int s_bf16) {
  return repro::wg::capacity<true>(bc, split, smem, s_bf16);
}
