// masked_matmul_ds: ds = (x^T @ g) * w * sigmoid(s) * (1 - sigmoid(s)),
// the straight-through score gradient.
//
// Replaces the Pallas kernel `_ds_kernel` / `masked_matmul_ds` in
// src/repro/kernels/masked_matmul.py.
//
// x, g, w: bf16, s: f32, ds: f32 (the reference casts to s.dtype).
//
// Design: each block owns one 64x64 tile of ds over (K, N) and loops over
// all of M inside the block, in steps of 16, so there are no atomics and
// no second pass.  The epilogue multiplies the f32 accumulator by
// w * sigmoid(s) * (1 - sigmoid(s)) in registers: neither x^T g nor the
// sigmoid is ever written to device memory.
//
// Bound on this card: reading w and s and writing ds, 10 bytes per weight
// against 2*M = 512 flops per weight at M = 256; this SIMT kernel is
// limited by its f32 flops on the CUDA cores instead.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int BK = 64, BN = 64, BM = 16, TK = 4, TN = 4;
constexpr int THREADS = (BK / TK) * (BN / TN);

__global__ void __launch_bounds__(THREADS)
masked_matmul_ds_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ g,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ s, float* __restrict__ ds,
                        int M, int K, int N) {
  __shared__ float xs[BM][BK];
  __shared__ float gs[BM][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int k0 = blockIdx.y * BK, n0 = blockIdx.x * BN;
  float acc[TK][TN] = {};

  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int mm = e / BK, kk = e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[mm][kk] = (gm < M && gk < K)
                       ? __bfloat162float(x[(int64_t)gm * K + gk])
                       : 0.0f;
    }
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int mm = e / BN, nn = e % BN;
      const int gm = m0 + mm, gn = n0 + nn;
      gs[mm][nn] = (gm < M && gn < N)
                       ? __bfloat162float(g[(int64_t)gm * N + gn])
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < BM; ++mm) {
      float a[TK], b[TN];
#pragma unroll
      for (int i = 0; i < TK; ++i) a[i] = xs[mm][ty * TK + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = gs[mm][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int gk = k0 + ty * TK + i;
    if (gk >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      const int64_t o = (int64_t)gk * N + gn;
      const float sig = repro::sigmoid(s[o]);
      ds[o] = acc[i][j] * __bfloat162float(w[o]) * sig * (1.0f - sig);
    }
  }
}

}  // namespace

extern "C" int masked_matmul_ds(const void* x, const void* g, const void* w,
                                const void* s, void* ds, int M, int K, int N,
                                void* stream) {
  const dim3 grid((N + BN - 1) / BN, (K + BK - 1) / BK);
  masked_matmul_ds_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g,
      (const __nv_bfloat16*)w, (const float*)s, (float*)ds, M, K, N);
  return (int)cudaGetLastError();
}
