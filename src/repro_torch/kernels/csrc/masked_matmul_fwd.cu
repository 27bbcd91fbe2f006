// masked_matmul_fwd: y = x @ (m * w), the mask regenerated in the kernel.
//
// Replaces the Pallas kernel `_kernel` / `masked_matmul` in
// src/repro/kernels/masked_matmul.py:153.
//
// m = 1[hash_u(seed, off + k*n_logical + n) < sigmoid(s[k, n])] (mode 0) or
// 1[sigmoid(s[k, n]) > tau] (mode 1).  w: bf16, s: f32 or bf16 (widened to
// f32 exactly before the gating, as the reference upcasts it); x and y: bf16, or
// f32 where the reference feeds an f32 activation (recurrentgemma's RG-LRU
// gate projections); the f32 accumulator is cast to x.dtype, as the
// reference casts it.
//
// Bound on this card: at the main path's M = 256 rows per cohort the work
// is bound by the bytes of w (bf16) and s (f32), 6 bytes a weight (4 with
// bf16 scores), plus x and y, against 2*M = 512 flops a weight: 0.120 ms
// (0.081 ms) per internlm2-1.8b layer at 3.35 TB/s, where its 32 GFLOP take
// 0.033 ms on the bf16 tensor
// cores.  The reference's own design goal is the same: stream w and s
// once and keep m*w out of device memory.
//
// Design, bf16 x (masked_matmul_wgmma.cuh): one block owns all 256 rows of
// an M block and BC columns of y, so each weight is hashed, gated and read
// once per launch (per 256 rows); warps 0-15 gate the raw (w, s) tile of
// stage i+1 into a swizzled bf16 m*w tile in shared memory while wgmma
// (bf16 in, f32 accumulators) runs stage i; two warps keep TMA loads in
// flight behind mbarriers (element loads where a row pitch is off the
// 16-byte grid); the K axis is split over a cluster of <= 8 blocks whose
// partials are added through distributed shared memory in a fixed order,
// so the card fills without partial sums in device memory or atomics.
// f32 x keeps the tiled SIMT body of masked_matmul_tiles.cuh (`fwd_tile`):
// the entry point picks the body from the activation type.
#include "masked_matmul_tiles.cuh"
#include "masked_matmul_wgmma.cuh"

namespace {

template <typename S>
__global__ void __launch_bounds__(repro::THREADS)
masked_matmul_fwd_f32(const float* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const S* __restrict__ s, float* __restrict__ y,
                      int M, int K, int N, uint32_t seed, uint32_t off,
                      uint32_t n_logical, int mode, float tau) {
  repro::fwd_tile(x, w, s, y, M, K, N, seed, off, n_logical, mode, tau);
}

}  // namespace

// s_bf16: the scores are bf16 (f32 otherwise); bc, split, w_stages, smem,
// tma: the bf16 body's launch plan (kernels.masked_matmul.wgmma_plan);
// unread for f32 x.
extern "C" int masked_matmul_fwd(const void* x, const void* w, const void* s,
                                void* y, int M, int K, int N, uint32_t seed,
                                uint32_t off, uint32_t n_logical, int mode,
                                float tau, int x_f32, int s_bf16, int bc,
                                int split, int w_stages, int smem, int tma,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!x_f32)
    return repro::wg::launch<false>(x, w, s, y, M, K, N, seed, off,
                                   n_logical, mode, tau, s_bf16, bc, split,
                                   w_stages, smem, tma, st);
  const dim3 grid = repro::tile_grid(M, N);
  if (s_bf16)
    masked_matmul_fwd_f32<<<grid, repro::THREADS, 0, st>>>(
        (const float*)x, (const __nv_bfloat16*)w, (const __nv_bfloat16*)s,
        (float*)y, M, K, N, seed, off, n_logical, mode, tau);
  else
    masked_matmul_fwd_f32<<<grid, repro::THREADS, 0, st>>>(
        (const float*)x, (const __nv_bfloat16*)w, (const float*)s,
        (float*)y, M, K, N, seed, off, n_logical, mode, tau);
  return (int)cudaGetLastError();
}

// Blocks of the bf16 body at width bc and cluster size split (of its
// bf16-score build where s_bf16) that the card holds at once, for the
// launch plan; a negative cudaError on failure.
extern "C" int masked_matmul_fwd_capacity(int bc, int split, int smem, int s_bf16) {
  return repro::wg::capacity<false>(bc, split, smem, s_bf16);
}
