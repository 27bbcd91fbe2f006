// masked_matmul_dx: dx = g @ (m * w)^T, the STE input gradient.
//
// Replaces the Pallas kernel `_dx_kernel` / `masked_matmul_dx` in
// src/repro/kernels/masked_matmul.py.
//
// The mask is regenerated from the same (seed, off + k*n_logical + n)
// hash stream as the forward, so it is bit-identical to the forward's.
// g, w: bf16, s: f32, dx: bf16 (the reference casts to g.dtype).
//
// Design: the forward's tile scheme, transposed.  Each block owns a 64x64
// tile of dx over (M, K) and accumulates over N inside the block in steps
// of 16, so there is no reduction across blocks.  Per step it stages the
// g tile and the gated (m*w)^T tile in shared memory as f32.
//
// Bound on this card: like the forward, the bytes of w and s at M = 256;
// this SIMT kernel is limited by its f32 flops on the CUDA cores instead.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int BM = 64, BK = 64, BN = 16, TM = 4, TK = 4;
constexpr int THREADS = (BM / TM) * (BK / TK);

__global__ void __launch_bounds__(THREADS)
masked_matmul_dx_kernel(const __nv_bfloat16* __restrict__ g,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ s,
                        __nv_bfloat16* __restrict__ dx, int M, int K, int N,
                        uint32_t seed, uint32_t off, uint32_t n_logical,
                        int mode, float tau) {
  __shared__ float gs[BN][BM];  // g tile, transposed
  __shared__ float ws[BN][BK];  // gated (m*w)^T tile
  const int tid = threadIdx.x;
  const int tx = tid % (BK / TK), ty = tid / (BK / TK);
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BK;
  const uint32_t smix = repro::seed_mix(seed);
  float acc[TM][TK] = {};

  for (int n0 = 0; n0 < N; n0 += BN) {
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int mm = e / BN, nn = e % BN;
      const int gm = m0 + mm, gn = n0 + nn;
      gs[nn][mm] = (gm < M && gn < N)
                       ? __bfloat162float(g[(int64_t)gm * N + gn])
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
      ws[nn][kk] = v;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < BN; ++nn) {
      float a[TM], b[TK];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = gs[nn][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TK; ++j) b[j] = ws[nn][tx * TK + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      const int gk = k0 + tx * TK + j;
      if (gk < K) dx[(int64_t)gm * K + gk] = __float2bfloat16(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int masked_matmul_dx(const void* g, const void* w, const void* s,
                                void* dx, int M, int K, int N, uint32_t seed,
                                uint32_t off, uint32_t n_logical, int mode,
                                float tau, void* stream) {
  const dim3 grid((K + BK - 1) / BK, (M + BM - 1) / BM);
  masked_matmul_dx_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)g, (const __nv_bfloat16*)w, (const float*)s,
      (__nv_bfloat16*)dx, M, K, N, seed, off, n_logical, mode, tau);
  return (int)cudaGetLastError();
}
