// masked_matmul_ds: ds = (x^T @ g) * w * sigmoid(s) * (1 - sigmoid(s)),
// the straight-through score gradient.
//
// Replaces the Pallas kernel `_ds_kernel` / `masked_matmul_ds` in
// src/repro/kernels/masked_matmul.py:297.
//
// w: bf16, s and ds: f32, or both bf16 (ds computed in f32 and rounded
// once at the store, as the reference casts to s.dtype); x and g: both
// bf16, or both f32 (an f32 forward and its cotangent).
//
// Bound on this card: every weight costs 10 bytes of device memory (w
// bf16 2, s f32 4, ds f32 4), plus x and g read once, against 2*M flops:
// 0.195 ms per internlm2-1.8b layer (M = 256) at 3.35 TB/s (6 bytes a
// weight and 0.120 ms with bf16 s and ds), where its
// 32 GFLOP take 0.033 ms on the bf16 tensor cores (0.48 ms on the f32
// CUDA cores, which is why the product must leave them).  The reference
// keeps x^T g and sigmoid(s) out of device memory; so does this kernel.
//
// Design (masked_matmul_ds_wgmma.cuh, which kernel 7 runs on E groups;
// this is its E = 1 case): persistent blocks walk 128 x BN tiles of ds
// (BN 64 or 128), each tile's product over all of M on wgmma (bf16 in,
// f32 accumulators; f32 x and g split into three bf16 parts),
// then an epilogue that streams w and s in through shared memory by TMA
// and ds out from registers in 16-byte stores, while the load warps
// fetch the next tile's operands.  The 10 bytes a weight are the only
// traffic to device memory that scales with K*N; x and g (at most
// 8.4 MB, at recurrentgemma's ffn) stay in L2.
// L2 traffic of a tile: its x and g slices, 2*M*(128 + BN) bytes, against
// 10*128*BN bytes of device memory: 0.80x at BN = 128 and 1.20x at
// BN = 64 for M = 256, within the L2's bandwidth (a multiple of the
// device memory's); the plan takes BN = 128 wherever that still gives
// every SM a tile.  M is never split across blocks: no atomics, no
// partial sums in device memory, the same bits on every launch.
#include "masked_matmul_ds_wgmma.cuh"

// s_bf16: s and ds are bf16 (f32 otherwise); bn, stages, chunks, smem,
// grid, tma: the launch plan (kernels.masked_matmul.ds_plan and the
// wrapper's 16-byte-grid flags).
extern "C" int masked_matmul_ds(const void* x, const void* g, const void* w,
                                const void* s, void* ds, int M, int K, int N,
                                int x_f32, int s_bf16, int bn, int stages,
                                int chunks, int smem, int grid, int tma,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return s_bf16 ? repro::dsw::launch<true>(x, g, w, s, ds, 1, M, K, N, x_f32,
                                           bn, stages, chunks, smem, grid,
                                           tma, st)
                : repro::dsw::launch<false>(x, g, w, s, ds, 1, M, K, N, x_f32,
                                            bn, stages, chunks, smem, grid,
                                            tma, st);
}
