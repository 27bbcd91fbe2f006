// masked_matmul_grouped_dx: dx[e] = g[e] @ (m[e] * w[e])^T, the STE input
// gradient of the grouped (MoE expert) projection.
//
// Replaces the Pallas kernel `_g_dx_kernel` / `masked_matmul_grouped_dx` in
// src/repro/kernels/masked_matmul.py:513.
//
// Group e regenerates the grouped forward's mask from the same
// (seeds[e], offs[e] + k*n_logical + n) stream, bit for bit.  g: (E, M, N)
// f32, w: (E, K, N) bf16, s: (E, K, N) f32 or bf16 (read as it lies),
// seeds/offs: (E,) uint32 device arrays, dx: (E, M, K) f32 (the reference
// casts to g.dtype).
//
// Bound on this card: as the grouped forward's, the 6 bytes a weight of w
// and s (4 with bf16 scores): 1.015 ms (0.68) per deepseek-v2-lite MoE
// layer (E = 64, M = 30, 553.6 M weights) at 3.35 TB/s, against 0.22 ms
// of products on the tensor cores
// and ~0.7 ms of gating on the CUDA cores.
//
// Design: the grouped forward's tensor-core body
// (masked_matmul_grouped_wgmma.cuh) with the reduction over n: A = g[e]
// is K-major over n as it lies, and the gating warps read each raw (k, n)
// tile of w[e] and s[e] along n and write the transposed m*w tile from
// registers, so the transposition is free.  Three products of g's exact
// bf16 parts against the exact bf16 m*w are all of the f32 product.  All
// 16 consumer warps gate and split; the warpgroups holding g's rows (one
// at M = 30) run wgmma; one warp keeps TMA loads of w and s in flight; the
// N axis is split over a cluster of <= 8 blocks and reduced through
// distributed shared memory in rank order.
#include "masked_matmul_grouped_wgmma.cuh"

// s_bf16: the scores are bf16 (f32 otherwise); bc, split, w_stages,
// a_bufs, smem: the launch plan (kernels.masked_matmul.grouped_plan); tma:
// the wrapper's flags of which operands lie on the 16-byte grid.
extern "C" int masked_matmul_grouped_dx(const void* g, const void* w,
                                        const void* s, const void* seeds,
                                        const void* offs, void* dx, int E,
                                        int M, int K, int N,
                                        uint32_t n_logical, int mode,
                                        float tau, int s_bf16, int bc,
                                        int split, int w_stages, int a_bufs,
                                        int smem, int tma, void* stream) {
  return repro::gw::launch<true>(g, w, s, seeds, offs, dx, E, M, K, N,
                                 n_logical, mode, tau, s_bf16, bc, split,
                                 w_stages, a_bufs, smem, tma,
                                 (cudaStream_t)stream);
}

// Blocks of the body at width bc and cluster size split that the card
// holds at once (s_bf16: the bf16-score build), for the launch plan; a
// negative cudaError on failure.
extern "C" int masked_matmul_grouped_dx_capacity(int bc, int split, int smem,
                                                 int s_bf16) {
  return repro::gw::capacity<true>(bc, split, smem, s_bf16);
}
