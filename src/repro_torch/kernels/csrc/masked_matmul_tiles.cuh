// Tile bodies of the dense masked-matmul kernels on f32 activations
// (masked_matmul_{fwd,dx}.cu, one (M,K)x(K,N) problem: fwd_tile,
// dx_tile), their only users: kernels 1-2 on bf16 activations run the
// tensor-core body of masked_matmul_wgmma.cuh, the grouped kernels and
// both score gradients (kernels 3 and 7) run tensor-core bodies of their
// own.
//
// Each body is a tiled SIMT GEMM: a block of THREADS threads owns one
// TILE x TILE output tile (its position in blockIdx.x / blockIdx.y) and
// walks the reduction dimension in STEP-deep stages through shared memory,
// every thread accumulating a SUB x SUB sub-tile in f32 registers.  The
// gated m*w tile is formed in shared memory from the hash and sigmoid(s),
// so neither the mask nor m*w ever reaches device memory, and the mask bit
// depends only on (seed, off + k*n_logical + n), never on the tiling.
// Ragged edges are masked in the loads and the stores: no padding copies.
//
// The bodies are templates over the activation type (the entry points
// instantiate f32) and the score type (f32 or bf16, widened to f32
// exactly before the gating); values are widened to f32 on load and the
// result is
// cast back to the activation type, as the reference casts its f32
// accumulator to x.dtype / g.dtype.
#pragma once

#include <cuda_runtime.h>

#include "hash.cuh"

namespace repro {

constexpr int TILE = 64;   // output tile edge
constexpr int STEP = 16;   // reduction depth of one shared-memory stage
constexpr int SUB = 4;     // per-thread output sub-tile edge
constexpr int THREADS = (TILE / SUB) * (TILE / SUB);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// a[r, c] of a row-major (R, C) matrix as f32, 0 outside it.
template <typename T>
__device__ __forceinline__ float load_or_zero(const T* __restrict__ a, int r,
                                              int c, int R, int C) {
  return (r < R && c < C) ? to_f32(a[(int64_t)r * C + c]) : 0.0f;
}

// (m * w)[k, n] of a (K, N) block, 0 outside it.
template <typename S>
__device__ __forceinline__ float gated_weight(
    const __nv_bfloat16* __restrict__ w, const S* __restrict__ s, int k,
    int n, int K, int N, uint32_t off, uint32_t n_logical, uint32_t smix,
    int mode, float tau) {
  if (k >= K || n >= N) return 0.0f;
  const int64_t o = (int64_t)k * N + n;
  const uint32_t idx = off + (uint32_t)k * n_logical + (uint32_t)n;
  return mask_bit(to_f32(s[o]), idx, smix, mode, tau) ? __bfloat162float(w[o])
                                              : 0.0f;
}

// y = x @ (m * w): x (M, K), y (M, N); tile (blockIdx.y, blockIdx.x) of y.
template <typename T, typename S>
__device__ __forceinline__ void fwd_tile(const T* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ w,
                                         const S* __restrict__ s,
                                         T* __restrict__ y, int M, int K,
                                         int N, uint32_t seed, uint32_t off,
                                         uint32_t n_logical, int mode,
                                         float tau) {
  __shared__ float xs[STEP][TILE];  // x tile, transposed
  __shared__ float ws[STEP][TILE];  // gated m*w tile
  const int tid = threadIdx.x;
  const int tx = tid % (TILE / SUB), ty = tid / (TILE / SUB);
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const uint32_t smix = seed_mix(seed);
  float acc[SUB][SUB] = {};

  for (int k0 = 0; k0 < K; k0 += STEP) {
    for (int e = tid; e < TILE * STEP; e += THREADS) {
      const int mm = e / STEP, kk = e % STEP;
      xs[kk][mm] = load_or_zero(x, m0 + mm, k0 + kk, M, K);
    }
    for (int e = tid; e < STEP * TILE; e += THREADS) {
      const int kk = e / TILE, nn = e % TILE;
      ws[kk][nn] = gated_weight(w, s, k0 + kk, n0 + nn, K, N, off,
                                n_logical, smix, mode, tau);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < STEP; ++kk) {
      float a[SUB], b[SUB];
#pragma unroll
      for (int i = 0; i < SUB; ++i) a[i] = xs[kk][ty * SUB + i];
#pragma unroll
      for (int j = 0; j < SUB; ++j) b[j] = ws[kk][tx * SUB + j];
#pragma unroll
      for (int i = 0; i < SUB; ++i)
#pragma unroll
        for (int j = 0; j < SUB; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int gm = m0 + ty * SUB + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int gn = n0 + tx * SUB + j;
      if (gn < N) store_f32(&y[(int64_t)gm * N + gn], acc[i][j]);
    }
  }
}

// dx = g @ (m * w)^T: g (M, N), dx (M, K); tile (blockIdx.y, blockIdx.x)
// of dx, accumulating over N inside the block (no cross-block reduction).
template <typename T, typename S>
__device__ __forceinline__ void dx_tile(const T* __restrict__ g,
                                        const __nv_bfloat16* __restrict__ w,
                                        const S* __restrict__ s,
                                        T* __restrict__ dx, int M, int K,
                                        int N, uint32_t seed, uint32_t off,
                                        uint32_t n_logical, int mode,
                                        float tau) {
  __shared__ float gs[STEP][TILE];  // g tile, transposed
  __shared__ float ws[STEP][TILE];  // gated (m*w)^T tile
  const int tid = threadIdx.x;
  const int tx = tid % (TILE / SUB), ty = tid / (TILE / SUB);
  const int m0 = blockIdx.y * TILE, k0 = blockIdx.x * TILE;
  const uint32_t smix = seed_mix(seed);
  float acc[SUB][SUB] = {};

  for (int n0 = 0; n0 < N; n0 += STEP) {
    for (int e = tid; e < TILE * STEP; e += THREADS) {
      const int mm = e / STEP, nn = e % STEP;
      gs[nn][mm] = load_or_zero(g, m0 + mm, n0 + nn, M, N);
    }
    for (int e = tid; e < TILE * STEP; e += THREADS) {
      const int kk = e / STEP, nn = e % STEP;
      ws[nn][kk] = gated_weight(w, s, k0 + kk, n0 + nn, K, N, off,
                                n_logical, smix, mode, tau);
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < STEP; ++nn) {
      float a[SUB], b[SUB];
#pragma unroll
      for (int i = 0; i < SUB; ++i) a[i] = gs[nn][ty * SUB + i];
#pragma unroll
      for (int j = 0; j < SUB; ++j) b[j] = ws[nn][tx * SUB + j];
#pragma unroll
      for (int i = 0; i < SUB; ++i)
#pragma unroll
        for (int j = 0; j < SUB; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int gm = m0 + ty * SUB + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int gk = k0 + tx * SUB + j;
      if (gk < K) store_f32(&dx[(int64_t)gm * K + gk], acc[i][j]);
    }
  }
}

// Grid of one problem's output tiles.
inline dim3 tile_grid(int rows, int cols) {
  return dim3((cols + TILE - 1) / TILE, (rows + TILE - 1) / TILE);
}

}  // namespace repro
