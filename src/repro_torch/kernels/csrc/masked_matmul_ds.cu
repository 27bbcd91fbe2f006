// masked_matmul_ds: ds = (x^T @ g) * w * sigmoid(s) * (1 - sigmoid(s)),
// the straight-through score gradient.
//
// Replaces the Pallas kernel `_ds_kernel` / `masked_matmul_ds` in
// src/repro/kernels/masked_matmul.py.
//
// w: bf16, s: f32, ds: f32 (the reference casts to s.dtype); x and g:
// both bf16, or both f32 (an f32 forward and its cotangent).
//
// Design: `ds_tile` in masked_matmul_tiles.cuh: each block owns one 64x64
// tile of ds over (K, N) and loops over all of M inside the block, in
// steps of 16, so there are no atomics and no second pass.  The epilogue
// multiplies the f32 accumulator by w * sigmoid(s) * (1 - sigmoid(s)) in
// registers: neither x^T g nor the sigmoid is ever written to device
// memory.
//
// Bound on this card: reading w and s and writing ds, 10 bytes per weight
// against 2*M = 512 flops per weight at M = 256; this SIMT kernel is
// limited by its f32 flops on the CUDA cores instead.
#include "masked_matmul_tiles.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(repro::THREADS)
masked_matmul_ds_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ s, float* __restrict__ ds,
                        int M, int K, int N) {
  repro::ds_tile(x, g, w, s, ds, M, K, N);
}

}  // namespace

extern "C" int masked_matmul_ds(const void* x, const void* g, const void* w,
                                const void* s, void* ds, int M, int K, int N,
                                int x_f32, void* stream) {
  const dim3 grid = repro::tile_grid(K, N);
  const cudaStream_t st = (cudaStream_t)stream;
  if (x_f32)
    masked_matmul_ds_kernel<float><<<grid, repro::THREADS, 0, st>>>(
        (const float*)x, (const float*)g, (const __nv_bfloat16*)w,
        (const float*)s, (float*)ds, M, K, N);
  else
    masked_matmul_ds_kernel<__nv_bfloat16><<<grid, repro::THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g,
        (const __nv_bfloat16*)w, (const float*)s, (float*)ds, M, K, N);
  return (int)cudaGetLastError();
}
