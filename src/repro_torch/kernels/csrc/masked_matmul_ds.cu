// masked_matmul_ds: ds = (x^T @ g) * w * sigmoid(s) * (1 - sigmoid(s)),
// the straight-through score gradient.
//
// Replaces the Pallas kernel `_ds_kernel` / `masked_matmul_ds` in
// src/repro/kernels/masked_matmul.py.
//
// x, g, w: bf16, s: f32, ds: f32 (the reference casts to s.dtype).
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

__global__ void __launch_bounds__(repro::THREADS)
masked_matmul_ds_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ g,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ s, float* __restrict__ ds,
                        int M, int K, int N) {
  repro::ds_tile(x, g, w, s, ds, M, K, N);
}

}  // namespace

extern "C" int masked_matmul_ds(const void* x, const void* g, const void* w,
                                const void* s, void* ds, int M, int K, int N,
                                void* stream) {
  masked_matmul_ds_kernel<<<repro::tile_grid(K, N), repro::THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g,
      (const __nv_bfloat16*)w, (const float*)s, (float*)ds, M, K, N);
  return (int)cudaGetLastError();
}
