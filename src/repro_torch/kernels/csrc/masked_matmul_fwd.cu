// masked_matmul_fwd: y = x @ (m * w), the mask regenerated per tile.
//
// Replaces the Pallas kernel `_kernel` / `masked_matmul` in
// src/repro/kernels/masked_matmul.py.
//
// m = 1[hash_u(seed, off + k*n_logical + n) < sigmoid(s[k, n])] (mode 0) or
// 1[sigmoid(s[k, n]) > tau] (mode 1).  w: bf16, s: f32; x and y: bf16, or
// f32 where the reference feeds an f32 activation (recurrentgemma's RG-LRU
// gate projections); the f32 accumulator is cast to x.dtype, as the
// reference casts it.
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

template <typename T>
__global__ void __launch_bounds__(repro::THREADS)
masked_matmul_fwd_kernel(const T* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ s, T* __restrict__ y,
                         int M, int K, int N, uint32_t seed, uint32_t off,
                         uint32_t n_logical, int mode, float tau) {
  repro::fwd_tile(x, w, s, y, M, K, N, seed, off, n_logical, mode, tau);
}

}  // namespace

extern "C" int masked_matmul_fwd(const void* x, const void* w, const void* s,
                                 void* y, int M, int K, int N, uint32_t seed,
                                 uint32_t off, uint32_t n_logical, int mode,
                                 float tau, int x_f32, void* stream) {
  const dim3 grid = repro::tile_grid(M, N);
  const cudaStream_t st = (cudaStream_t)stream;
  if (x_f32)
    masked_matmul_fwd_kernel<float><<<grid, repro::THREADS, 0, st>>>(
        (const float*)x, (const __nv_bfloat16*)w, (const float*)s, (float*)y,
        M, K, N, seed, off, n_logical, mode, tau);
  else
    masked_matmul_fwd_kernel<__nv_bfloat16><<<grid, repro::THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)s,
        (__nv_bfloat16*)y, M, K, N, seed, off, n_logical, mode, tau);
  return (int)cudaGetLastError();
}
