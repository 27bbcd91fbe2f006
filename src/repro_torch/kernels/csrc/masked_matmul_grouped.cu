// masked_matmul_grouped: y[e] = x[e] @ (m[e] * w[e]) for E stacked
// problems (the MoE expert projections), one launch for all groups.
//
// Replaces the Pallas kernel `_g_kernel` / `masked_matmul_grouped` in
// src/repro/kernels/masked_matmul.py:443.
//
// Group e's mask is drawn at flat index offs[e] + k*n_logical + n of
// seeds[e]'s stream (mode 0), or is 1[sigmoid(s) > tau] (mode 1); with
// offs[e] = (l*E + e)*K*N mod 2^32 the E masks are exactly layer l's slice
// of the (L, E, K, N) leaf's uplink stream.  seeds and offs are (E,)
// uint32 device arrays.  x: (E, M, K) f32 (the reference keeps the expert
// chain in f32), w: (E, K, N) bf16, s: (E, K, N) f32 or bf16 (read as it
// lies, each score widened to f32 exactly before the gating), y: (E, M, N)
// f32.
//
// Bound on this card: at the main path's expert shapes (E = 64, M = the
// capacity 30, K x N = 2048 x 1408 and 1408 x 2048) the bytes of w and s,
// 6 a weight: 1.015 ms per deepseek-v2-lite MoE layer (3 projections,
// 553.6 M weights, with x and y) at 3.35 TB/s.  The products, three bf16
// parts of x against m*w at wgmma's 64 rows, take 0.22 ms of it at
// 989 TFLOP/s, and gating each weight (hash, expf, division) ~0.7 ms on
// the CUDA cores, so gating, streaming and products must overlap.
//
// Design (masked_matmul_grouped_wgmma.cuh): one block owns all of group
// e's rows of an M block (64 rows at M = 30) and BC columns of y, so each
// weight is gated once per launch.  m*w is exact in bf16, so three
// products of the exact bf16 parts of x (hi + mid + lo = x) are all of the
// f32 product, on the tensor cores.  Warps 0-15 all gate stage i+1 of w[e]
// and s[e] into a swizzled bf16 tile and split x's next stage while the
// one warpgroup that holds rows runs wgmma on stage i; warp 16 keeps TMA
// loads of the raw (w, s) stages in flight.  The K axis is split over a
// cluster of <= 8 blocks, reduced through distributed shared memory in
// rank order: the same bits on every launch, no atomics.
#include "masked_matmul_grouped_wgmma.cuh"

// s_bf16: the scores are bf16 (f32 otherwise); bc, split, w_stages,
// a_bufs, smem: the launch plan (kernels.masked_matmul.grouped_plan); tma:
// the wrapper's flags of which operands lie on the 16-byte grid.
extern "C" int masked_matmul_grouped(const void* x, const void* w,
                                     const void* s, const void* seeds,
                                     const void* offs, void* y, int E, int M,
                                     int K, int N, uint32_t n_logical,
                                     int mode, float tau, int s_bf16, int bc,
                                     int split, int w_stages, int a_bufs,
                                     int smem, int tma, void* stream) {
  return repro::gw::launch<false>(x, w, s, seeds, offs, y, E, M, K, N,
                                  n_logical, mode, tau, s_bf16, bc, split,
                                  w_stages, a_bufs, smem, tma,
                                  (cudaStream_t)stream);
}

// Blocks of the body at width bc and cluster size split that the card
// holds at once (s_bf16: the bf16-score build), for the launch plan; a
// negative cudaError on failure.
extern "C" int masked_matmul_grouped_capacity(int bc, int split, int smem,
                                              int s_bf16) {
  return repro::gw::capacity<false>(bc, split, smem, s_bf16);
}
