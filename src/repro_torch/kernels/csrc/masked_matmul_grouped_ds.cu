// masked_matmul_grouped_ds: ds[e] = (x[e]^T @ g[e]) * w[e] *
// sigmoid(s[e]) * (1 - sigmoid(s[e])), the STE score gradient of the
// grouped (MoE expert) projection.
//
// Replaces the Pallas kernel `_g_ds_kernel` / `masked_matmul_grouped_ds` in
// src/repro/kernels/masked_matmul.py:574.
//
// x: (E, M, K) f32, g: (E, M, N) f32, w: (E, K, N) bf16, s: (E, K, N) f32
// or bf16, ds: (E, K, N) in s's type (the reference's `.astype(s.dtype)`:
// a bf16 ds is the f32 value rounded once, to nearest even, at the store).
// A bf16 score block is read as it lies and each score widened to f32
// exactly before the sigmoid: no f32 copy of it exists.
//
// Bound on this card: reading w (bf16) and s (f32) and writing ds (f32),
// 10 bytes per weight (1.85 GB, 0.55 ms at 3.35 TB/s at E = 64,
// K x N = 2048 x 1408), 6 bytes with bf16 s and ds (0.33 ms), against
// 2*M = 60 flops per weight at the capacity M = 30: bytes bind, as long
// as the products leave the CUDA cores, whose issue slots the sigmoid
// epilogue needs.
//
// Design: kernel 3's persistent tensor-core body
// (masked_matmul_ds_wgmma.cuh) on E stacked problems, its f32 path: the
// tiles are numbered (group, K tile, N tile) with N fastest; each tile's
// x[e]^T g[e] over all of M runs on wgmma as six products of three exact
// bf16 parts of x and g (one 32-row stage at M = 30, loaded into
// registers while the tile before is in its epilogue), and the epilogue
// streams w and s in by TMA through a ring that runs up to a tile and a
// half ahead, and ds out in 16-byte stores.  At M = 30 the plan runs two
// blocks of 128 x 64 tiles an SM: the consumers' split, products and
// sigmoids run in series, and 16 warps hide their latency where 8 did
// not.  3-d tensor maps (E, K, N) and loads bounded by the group's rows
// keep every tile inside its group.  No atomics, no partial sums in
// device memory: the same bits on every launch.
#include "masked_matmul_ds_wgmma.cuh"

// s_bf16: s and ds are bf16 (f32 otherwise); bn, stages, chunks, smem,
// grid, tma: the launch plan (kernels.masked_matmul.ds_plan at E groups
// and the wrapper's 16-byte-grid flags).
extern "C" int masked_matmul_grouped_ds(const void* x, const void* g,
                                        const void* w, const void* s,
                                        void* ds, int E, int M, int K, int N,
                                        int s_bf16, int bn, int stages,
                                        int chunks, int smem, int grid,
                                        int tma, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return s_bf16 ? repro::dsw::launch<true>(x, g, w, s, ds, E, M, K, N, 1, bn,
                                           stages, chunks, smem, grid, tma,
                                           st)
                : repro::dsw::launch<false>(x, g, w, s, ds, E, M, K, N, 1,
                                            bn, stages, chunks, smem, grid,
                                            tma, st);
}
