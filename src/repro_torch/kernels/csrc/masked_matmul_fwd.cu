// masked_matmul_fwd: y = x @ (m * w), the mask regenerated per tile.
//
// Replaces the Pallas kernel `_kernel` / `masked_matmul` in
// src/repro/kernels/masked_matmul.py.
//
// m = 1[hash_u(seed, off + k*n_logical + n) < sigmoid(s[k, n])] (mode 0) or
// 1[sigmoid(s[k, n]) > tau] (mode 1).  x, w: bf16, s: f32, y: bf16 (the
// reference casts its f32 accumulator to x.dtype).
//
// Design: a tiled SIMT GEMM.  Each block owns a 64x64 tile of y and walks
// K in steps of 16.  Per step it stages the x tile and the gated m*w tile
// in shared memory as f32; the mask is formed there from the hash and
// sigmoid(s), so neither the mask nor m*w ever reaches device memory.
// 256 threads each accumulate a 4x4 sub-tile in f32 registers.  Ragged
// edges are masked in the loads and the store: no padding copies.
//
// Bound on this card: at the main path's shapes (M = 256 tokens per
// cohort) the work is bound by the bytes of w (bf16) and s (f32), about
// 6 bytes per weight against 2*M = 512 flops per weight.  This simple
// kernel runs its flops on the CUDA cores in f32 and is limited by them,
// far above that bound.  Since m*w and x are bf16-exact, a later version
// can feed bf16 tensor cores (wgmma, f32 accumulation) with the same math
// up to summation order.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);

__global__ void __launch_bounds__(THREADS)
masked_matmul_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ s,
                         __nv_bfloat16* __restrict__ y, int M, int K, int N,
                         uint32_t seed, uint32_t off, uint32_t n_logical,
                         int mode, float tau) {
  __shared__ float xs[BK][BM];  // x tile, transposed
  __shared__ float ws[BK][BN];  // gated m*w tile
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const uint32_t smix = repro::seed_mix(seed);
  float acc[TM][TN] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int mm = e / BK, kk = e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K)
                       ? __bfloat162float(x[(int64_t)gm * K + gk])
                       : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      float v = 0.0f;
      if (gk < K && gn < N) {
        const int64_t o = (int64_t)gk * N + gn;
        const uint32_t idx = off + (uint32_t)gk * n_logical + (uint32_t)gn;
        if (repro::mask_bit(s[o], idx, smix, mode, tau))
          v = __bfloat162float(w[o]);
      }
      ws[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) y[(int64_t)gm * N + gn] = __float2bfloat16(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int masked_matmul_fwd(const void* x, const void* w, const void* s,
                                 void* y, int M, int K, int N, uint32_t seed,
                                 uint32_t off, uint32_t n_logical, int mode,
                                 float tau, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  masked_matmul_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)s,
      (__nv_bfloat16*)y, M, K, N, seed, off, n_logical, mode, tau);
  return (int)cudaGetLastError();
}
