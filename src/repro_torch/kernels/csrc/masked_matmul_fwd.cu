// masked_matmul_fwd: y = x @ (m * w), the mask regenerated per tile.
//
// Replaces the Pallas kernel `_kernel` / `masked_matmul` in
// src/repro/kernels/masked_matmul.py.
//
// m = 1[hash_u(seed, off + k*n_logical + n) < sigmoid(s[k, n])] (mode 0) or
// 1[sigmoid(s[k, n]) > tau] (mode 1).  x, w: bf16, s: f32, y: bf16 (the
// reference casts its f32 accumulator to x.dtype).
//
// Design: the tiled SIMT GEMM of masked_matmul_tiles.cuh (`fwd_tile`):
// 64x64 tiles of y, K walked in steps of 16, the gated m*w tile formed in
// shared memory, so neither the mask nor m*w ever reaches device memory.
//
// Bound on this card: at the main path's shapes (M = 256 tokens per
// cohort) the work is bound by the bytes of w (bf16) and s (f32), about
// 6 bytes per weight against 2*M = 512 flops per weight.  This simple
// kernel runs its flops on the CUDA cores in f32 and is limited by them,
// far above that bound.  Since m*w and x are bf16-exact, a later version
// can feed bf16 tensor cores (wgmma, f32 accumulation) with the same math
// up to summation order.
#include "masked_matmul_tiles.cuh"

namespace {

__global__ void __launch_bounds__(repro::THREADS)
masked_matmul_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ s,
                         __nv_bfloat16* __restrict__ y, int M, int K, int N,
                         uint32_t seed, uint32_t off, uint32_t n_logical,
                         int mode, float tau) {
  repro::fwd_tile(x, w, s, y, M, K, N, seed, off, n_logical, mode, tau);
}

}  // namespace

extern "C" int masked_matmul_fwd(const void* x, const void* w, const void* s,
                                 void* y, int M, int K, int N, uint32_t seed,
                                 uint32_t off, uint32_t n_logical, int mode,
                                 float tau, void* stream) {
  masked_matmul_fwd_kernel<<<repro::tile_grid(M, N), repro::THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)s,
      (__nv_bfloat16*)y, M, K, N, seed, off, n_logical, mode, tau);
  return (int)cudaGetLastError();
}
