// masked_matmul_dx: dx = g @ (m * w)^T, the STE input gradient.
//
// Replaces the Pallas kernel `_dx_kernel` / `masked_matmul_dx` in
// src/repro/kernels/masked_matmul.py.
//
// The mask is regenerated from the same (seed, off + k*n_logical + n) hash
// stream as the forward, so it is bit-identical to the forward's.
// w: bf16, s: f32; g and dx: bf16, or f32 (the cotangent of an f32
// forward); the reference casts to g.dtype.
//
// Design: the forward's tile scheme, transposed (`dx_tile` in
// masked_matmul_tiles.cuh): each block owns a 64x64 tile of dx over (M, K)
// and accumulates over N inside the block in steps of 16, so there is no
// reduction across blocks.
//
// Bound on this card: like the forward, the bytes of w and s at M = 256;
// this SIMT kernel is limited by its f32 flops on the CUDA cores instead.
#include "masked_matmul_tiles.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(repro::THREADS)
masked_matmul_dx_kernel(const T* __restrict__ g,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ s, T* __restrict__ dx,
                        int M, int K, int N, uint32_t seed, uint32_t off,
                        uint32_t n_logical, int mode, float tau) {
  repro::dx_tile(g, w, s, dx, M, K, N, seed, off, n_logical, mode, tau);
}

}  // namespace

extern "C" int masked_matmul_dx(const void* g, const void* w, const void* s,
                                void* dx, int M, int K, int N, uint32_t seed,
                                uint32_t off, uint32_t n_logical, int mode,
                                float tau, int x_f32, void* stream) {
  const dim3 grid = repro::tile_grid(M, K);
  const cudaStream_t st = (cudaStream_t)stream;
  if (x_f32)
    masked_matmul_dx_kernel<float><<<grid, repro::THREADS, 0, st>>>(
        (const float*)g, (const __nv_bfloat16*)w, (const float*)s,
        (float*)dx, M, K, N, seed, off, n_logical, mode, tau);
  else
    masked_matmul_dx_kernel<__nv_bfloat16><<<grid, repro::THREADS, 0, st>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)w, (const float*)s,
        (__nv_bfloat16*)dx, M, K, N, seed, off, n_logical, mode, tau);
  return (int)cudaGetLastError();
}
