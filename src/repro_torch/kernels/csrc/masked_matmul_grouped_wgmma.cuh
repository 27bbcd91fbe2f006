// Tensor-core body of the grouped masked-matmul kernels 5-6 for f32
// activations (masked_matmul_grouped.cu: y[e] = x[e] @ (m[e]*w[e]);
// masked_matmul_grouped_dx.cu: dx[e] = g[e] @ (m[e]*w[e])^T), one template
// over the orientation, as kernels 1-2's body (masked_matmul_wgmma.cuh).
//
// Both are E products  out[e] (M, C) = A[e] (M, R) @ B[e] (R, C)  with the
// reduction axis R contiguous in A:
//     forward   A = x[e] (M, K) f32, R = K, C = N, B[r][c] = (m*w)[e][r][c]
//     dx        A = g[e] (M, N) f32, R = N, C = K, B[r][c] = (m*w)[e][c][r]
// so only the gating differs, and it is kernels 1-2's: the raw (K, N)
// tile of w[e] and s[e] is gated straight into B's 128-byte-swizzled
// (BC x 64) bf16 tile, with group e's mask mask_bit() of hash.cuh at
// offs[e] + k*n_logical + n of seeds[e]'s stream, bit-identical to the
// plain version's and the reference's for any tiling.
//
// The scores come as f32 or bf16 (SB, the score type of the launch), as
// for kernels 1-2: a raw s stage holds them as they lie in device memory,
// 4 or 2 bytes an element, and gate_tile widens a bf16 score to f32
// exactly before mask_bit, so the mask of a bf16 score block is the mask
// of its f32 upcast, as the reference's kernel upcasts it.  2-byte scores
// make a raw stage 4 bytes a weight instead of 6, so the plan fits more
// of them beside the A buffers.
//
// f32 activations on the tensor cores: m*w is a bf16 weight or zero, so
// it is exact in bf16.  The threads split each f32 value of A into three
// bf16 parts (split3 of masked_matmul_wgmma.cuh, kernel 3's: hi + mid +
// lo = v, each part exact), written into three swizzled A tiles, and
// wgmma m64nBCk16 (bf16 in, f32 accumulators in registers) runs three
// products, lo, mid and hi, against the one gated B tile.  Each term is
// an exact product of two bf16 values, so three products are all of
// x @ (m*w): none is dropped (kernel 3 needs six because both of its
// operands are f32).
//
// A block owns all rows of its group's M block, 64*ceil(min(M, 256)/64)
// of them, and BC output columns, so each weight is hashed, gated and read
// once per launch and M block.  The grid is (cluster split of R, column
// tiles, E x M blocks), not persistent: the plan (below) picks the width
// and the cluster size so that the E x column-tile blocks fill whole waves
// (at the deepseek-v2-lite shapes 704 or 1024 (group, tile) pairs, 5.3
// and 7.8 waves of 132 blocks at split 1).  Its 16 warps (four
// warpgroups; 128 registers a thread, so the 64 accumulators of BC = 128
// do not spill):
//   - all gate: the raw tile of stage i+1 into the second B buffer while
//     the tensor cores multiply stage i, and all split A's next stage, the
//     warpgroups that do not multiply first.  Gating (the hash, the
//     accurate expf and an IEEE division, ~35-40 instructions a weight)
//     costs about as much as streaming w and s, so every warp does it and
//     it overlaps the loads and the products.
//   - only the warpgroups that hold rows of A issue wgmma: one at M <= 64
//     (the main path's M = 30 of 64 rows), four at M > 192.  Each runs the
//     whole loop in its own branch, so no wgmma waits at a join.
//   - thread 0 keeps a ring of raw (w, s) stages in flight behind full
//     mbarriers: once every thread has gated a stage (the barrier that
//     ends each step), it issues the TMA loads of the stage w_stages ahead
//     into that slot, over 3-d (E, K, N) tensor maps (zero fill past K and
//     N, never another group's rows).  Where a row pitch is off the
//     16-byte grid (the ragged cell's w pitch of 3000 bytes) every thread
//     loads its elements of the stage just before gating it instead.
// A (x or g, f32) stays in L2: each thread issues its vector loads of
// stage i+1 before it gates, and splits them after, so the latency hides
// behind the gating.  A is read by element where its pitch is off the
// 16-byte grid.  Rows of A past M are zero in shared memory, written once;
// A is never read past its group's M rows, and rows >= M are never stored.
// Two A buffers where they fit beside two raw stages (up to 128 rows), so
// the split of stage i+1 overlaps the products of stage i; one at 256 rows.
//
// The reduction axis is split over the blocks of a thread-block cluster
// (gridDim.x = cluster size <= 8): each block sums its range of 64-deep
// stages into f32 registers, parks them in its shared memory, and after a
// cluster barrier each block adds its share of the rows over the cluster's
// partials through distributed shared memory in rank order 0, 1, ... and
// stores f32.  No float atomics and no partial sums in device memory: the
// same inputs give the same bits on every launch.
//
// Bound on this card, per deepseek-v2-lite MoE layer (3 projections, E =
// 64, M = 30, 553.6 M weights): w (bf16) and s (f32) are 6 bytes a weight,
// 3.32 GB, 1.0 ms at 3.35 TB/s (1.015 ms with x and y; 4 bytes a weight
// and 0.68 ms with bf16 scores); the three products
// at wgmma's 64 rows are 0.22 ms at 989 TFLOP/s; gating at ~35-40
// instructions a weight is ~0.7 ms on 132 SMs x 128 lanes.
//
// The launch plan (BC, the cluster size, the raw stages, the A buffers,
// the shared-memory bytes and which operands go by TMA or 16-byte vectors)
// is computed by the Python wrapper (`kernels.masked_matmul.grouped_plan`)
// and passed in.
#pragma once

#include <type_traits>

#include "masked_matmul_wgmma.cuh"

namespace repro {
namespace gw {

using wg::BR;
using wg::cluster_rank;
using wg::cluster_size;
using wg::cluster_sync;
using wg::consumers_sync;
using wg::fence_async_smem;
using wg::ld_cluster;
using wg::mbar_arrive_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;
using wg::sw128_desc;
using wg::sw128_offset;

constexpr int MAX_ROWS = 256;    // rows of an M block: 4 warpgroups of 64
constexpr int THREADS = wg::CONSUMERS;   // 512, all gating: gate_tile's
constexpr int PAD = wg::PAD;
constexpr int PARTS = 3;         // bf16 parts of an f32 value of A
// The widths BC a block's output tile may take: gate_tile hands each of
// the 512 threads BC/64 chunks of 8 weights, so only multiples of 64 keep
// them even; at 128 a multiplying thread holds 64 accumulators of its 128
// registers.
#define REPRO_GW_WIDTHS(X) X(64) X(128)

struct Params {
  const float* a;          // x (forward) or g (dx): (E*M, R) f32
  const uint16_t* w;       // (E, K, N) bf16 bits
  const void* s;           // (E, K, N) f32, or bf16 bits (SB)
  const uint32_t* seeds;   // (E,)
  const uint32_t* offs;    // (E,)
  float* out;              // (E*M, C) f32
  int E, M, K, N;
  uint32_t n_logical;
  int mode;
  float tau;
  int rows;        // rows of A a block holds: 64*ceil(min(M, 256)/64)
  int w_stages;    // raw (w, s) stages in the ring
  int a_bufs;      // A buffers: 2 (split beside the products) or 1
  int tma;         // bit 0: A by 16-byte vectors, 1: w by TMA, 2: s by TMA,
                   // 3: out by 16-byte vectors
};

// 3-d TMA load of the box at (x = inner, y, z) into `dst`.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// Shared-memory layout, in bytes from the 1024-aligned base:
//   A buffers (a_bufs x 3 parts x rows*128: rows of 64 bf16, swizzled) |
//   B tiles (2 x BC*128) | raw w stages (w_stages x BR*BC*2) |
//   raw s stages (w_stages x BR*BC*4, or *2 for bf16 scores) |
//   mbarriers: full_w (w_stages)
// The partials of the cluster reduction (rows x (BC + PAD) f32) are parked
// over the start of it once the main loop is done.
template <int BC, bool SB>
struct Layout {
  static constexpr int B_BYTES = BC * BR * 2;
  static constexpr int W_BYTES = BR * BC * 2;
  static constexpr int S_BYTES = BR * BC * (SB ? 2 : 4);
  uint32_t base;
  int rows, a_bufs, ws;
  __device__ uint32_t a(int buf, int part) const {
    return base + static_cast<uint32_t>((buf * PARTS + part) * rows * 128);
  }
  __device__ uint32_t b(int i) const { return a(a_bufs, 0) + i * B_BYTES; }
  __device__ uint32_t w(int i) const { return b(2) + i * W_BYTES; }
  __device__ uint32_t s(int i) const { return w(ws) + i * S_BYTES; }
  __device__ uint32_t full_w(int i) const { return s(ws) + 8 * i; }
};

template <int BC, bool DX, bool SB>
__global__ void __launch_bounds__(THREADS, 1)
    grouped_gemm(const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_s, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  using S = typename std::conditional<SB, uint16_t, float>::type;
  const Layout<BC, SB> L{base, p.rows, p.a_bufs, p.w_stages};
  auto gen = [&](uint32_t addr) { return gbase + (addr - base); };

  const int R = DX ? p.N : p.K, C = DX ? p.K : p.N;
  const int steps = (R + BR - 1) / BR;
  const uint32_t q = cluster_rank(), split = cluster_size();
  const int j0 = static_cast<int>((int64_t)steps * q / split);
  const int n = static_cast<int>((int64_t)steps * (q + 1) / split) - j0;
  const int mblocks = (p.M + MAX_ROWS - 1) / MAX_ROWS;
  const int e = blockIdx.z / mblocks;
  const int m0 = (blockIdx.z % mblocks) * MAX_ROWS;
  const int rows = min(p.rows, p.M - m0);   // rows of A this block has
  const int mwg = (rows + 63) / 64;         // warpgroups that multiply
  const int c0 = blockIdx.y * BC;
  const int tid = threadIdx.x, wgi = tid >> 7, lane = tid & 31;
  const uint32_t smix = seed_mix(p.seeds[e]);

  if (tid == 0) {
    for (int i = 0; i < p.w_stages; ++i) mbar_init(L.full_w(i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // A's rows past M stay zero: clear every A buffer once
  for (int i = tid; i < p.a_bufs * PARTS * p.rows * 8; i += THREADS)
    reinterpret_cast<uint4*>(gbase)[i] = make_uint4(0, 0, 0, 0);
  fence_async_smem();
  __syncthreads();

  // ---- the raw (w, s) stages of group e.  The raw tile's rows and
  // columns in (K, N): BR x BC at (r0, c0) for the forward, BC x BR at
  // (c0, r0) for dx.
  const int64_t ge = (int64_t)e * p.K * p.N;
  const int nkr = DX ? BC : BR, nnc = DX ? BR : BC;
  const uint32_t w_tx = ((p.tma >> 1) & 1) * Layout<BC, SB>::W_BYTES +
                        ((p.tma >> 2) & 1) * Layout<BC, SB>::S_BYTES;
  // thread 0 issues stage i's TMA loads into its ring slot, once every
  // thread has gated the stage that held the slot before
  auto issue = [&](int i) {
    if (tid != 0 || i >= n) return;
    const int st = i % p.w_stages, r0 = (j0 + i) * BR;
    const int kr = DX ? c0 : r0, nc = DX ? r0 : c0;
    mbar_arrive_tx(L.full_w(st), w_tx);
    if (p.tma & 2) tma_load3(L.w(st), &map_w, nc, kr, e, L.full_w(st));
    if (p.tma & 4) tma_load3(L.s(st), &map_s, nc, kr, e, L.full_w(st));
  };
  // w or s off the 16-byte grid: every thread loads its elements of the
  // stage, zero past the matrix, just before it is gated
  auto load_by_element = [&](int i) {
    const int st = i % p.w_stages, r0 = (j0 + i) * BR;
    const int kr = DX ? c0 : r0, nc = DX ? r0 : c0;
    uint16_t* wd = reinterpret_cast<uint16_t*>(gen(L.w(st)));
    S* sd = reinterpret_cast<S*>(gen(L.s(st)));
    const S* se = static_cast<const S*>(p.s);
    for (int t = tid; t < nkr * nnc; t += THREADS) {
      const int k = kr + t / nnc, c = nc + t % nnc;
      const bool in = k < p.K && c < p.N;
      const int64_t o = ge + (int64_t)k * p.N + c;
      if (!(p.tma & 2)) wd[t] = in ? p.w[o] : uint16_t(0);
      if (!(p.tma & 4)) sd[t] = in ? se[o] : S(0);
    }
    consumers_sync();
  };
  // what gate_tile reads of kernels 1-2's parameters: group e's offset
  wg::Params gp{};
  gp.off = p.offs[e];
  gp.n_logical = p.n_logical;
  gp.tau = p.tau;
  auto gate = [&](int i) {
    const int st = i % p.w_stages;
    if ((p.tma & 6) != 6) load_by_element(i);
    mbar_wait(L.full_w(st), (i / p.w_stages) & 1);
    const uint16_t* wr = reinterpret_cast<const uint16_t*>(gen(L.w(st)));
    const S* sr = reinterpret_cast<const S*>(gen(L.s(st)));
    if (p.mode == 1)
      wg::gate_tile<BC, DX, 1>(gen(L.b(i & 1)), wr, sr, (j0 + i) * BR, c0,
                               smix, gp, tid);
    else
      wg::gate_tile<BC, DX, 0>(gen(L.b(i & 1)), wr, sr, (j0 + i) * BR, c0,
                               smix, gp, tid);
    fence_async_smem();
  };

  // ---- A: split tasks (a row's 8 values at a 16-byte chunk of a stage),
  // the warpgroups that do not multiply first
  const int stid = (tid + THREADS - 128 * mwg) % THREADS;
  const int tasks = rows * (BR / 8);
  const float* ab = p.a + ((int64_t)e * p.M + m0) * R;
  auto fetch = [&](int t, int i, float* v) {
    const int row = t >> 3, gc = (j0 + i) * BR + (t & 7) * 8;
    const float* src = ab + (int64_t)row * R + gc;
    if ((p.tma & 1) && gc + 8 <= R) {
      const float4 lo = reinterpret_cast<const float4*>(src)[0];
      const float4 hi = reinterpret_cast<const float4*>(src)[1];
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = gc + j < R ? src[j] : 0.0f;
    }
  };
  // stage i's A into buffer `buf` as three bf16 parts; `pre` holds this
  // thread's first task, fetched before the gating
  auto split_a = [&](int buf, int i, const float* pre) {
    for (int t = stid; t < tasks; t += THREADS) {
      float v[8];
      if (t == stid) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = pre[j];
      } else {
        fetch(t, i, v);
      }
      uint16_t parts[PARTS][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint16_t h[PARTS];
        wg::split3(v[j], h);
#pragma unroll
        for (int k = 0; k < PARTS; ++k) parts[k][j] = h[k];
      }
      const uint32_t o = sw128_offset(t >> 3, t & 7);
#pragma unroll
      for (int k = 0; k < PARTS; ++k)
        *reinterpret_cast<uint4*>(gen(L.a(buf, k)) + o) =
            *reinterpret_cast<const uint4*>(parts[k]);
    }
    fence_async_smem();
  };

  const bool two = p.a_bufs == 2;
  // The loop, once for the warpgroups that multiply (MULT) and once for
  // the others: the same gating, splitting and barriers, so that a
  // warpgroup's wgmma never sits under a branch inside the loop.
  auto run = [&](auto mult) {
    constexpr bool MULT = decltype(mult)::value;
    float acc[MULT ? BC / 2 : 1];
#pragma unroll
    for (int i = 0; i < (MULT ? BC / 2 : 1); ++i) acc[i] = 0.0f;
    float pre[8];
    for (int i = 0; i < p.w_stages; ++i) issue(i);
    if (n > 0) {
      if (stid < tasks) fetch(stid, 0, pre);
      gate(0);
      split_a(0, 0, pre);
    }
    consumers_sync();
    issue(p.w_stages);
    for (int i = 0; i < n; ++i) {
      const int buf = two ? (i & 1) : 0;
      if constexpr (MULT) {
        const uint64_t db = sw128_desc(L.b(i & 1));
        wg::fence_regs<BC / 2>(acc);
        wg::wgmma_fence();
        // the three parts against the one gated tile, smallest first
#pragma unroll
        for (int k = PARTS - 1; k >= 0; --k) {
          const uint64_t da = sw128_desc(L.a(buf, k) + wgi * 64 * 128);
#pragma unroll
          for (int kk = 0; kk < BR / 16; ++kk)   // +32 bytes along R each
            wg::wgmma_bf16<BC>(acc, da + 2 * kk, db + 2 * kk);
        }
        wg::wgmma_commit();
      }
      if (i + 1 < n) {
        if (stid < tasks) fetch(stid, i + 1, pre);
        gate(i + 1);
        if (two) split_a((i + 1) & 1, i + 1, pre);
      }
      if constexpr (MULT) {
        wg::wgmma_wait_all();
        wg::fence_regs<BC / 2>(acc);
      }
      consumers_sync();   // stage i+1 gated: its slot takes stage i+1+ws
      issue(i + 1 + p.w_stages);
      if (!two && i + 1 < n) {   // the one A buffer is free now
        split_a(0, i + 1, pre);
        consumers_sync();
      }
    }
    if constexpr (MULT) {
      // park the partial sums: thread (warp w4 of warpgroup wgi, lane)
      // holds rows wgi*64 + 16*w4 + lane/4 (+8), columns 8j + 2(lane%4)
      // (+1)
      float* part = reinterpret_cast<float*>(gbase);
      const int row = wgi * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
      const int col = (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
        *reinterpret_cast<float2*>(part + row * (BC + PAD) + 8 * j + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(part + (row + 8) * (BC + PAD) + 8 * j +
                                   col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  };
  if (wgi < mwg)
    run(std::true_type{});
  else
    run(std::false_type{});
  __syncwarp();
  cluster_sync();

  // ---- block q of the cluster sums its share of the rows over the
  // cluster's partials, in rank order, and stores f32
  const int lo = static_cast<int>((int64_t)rows * q / split);
  const int hi = static_cast<int>((int64_t)rows * (q + 1) / split);
  constexpr int V = BC / 4;
  for (int t = tid; t < (hi - lo) * V; t += THREADS) {
    const int row = lo + t / V, col = (t % V) * 4;
    const uint32_t at =
        base + static_cast<uint32_t>(row * (BC + PAD) + col) * 4;
    float4 sum = ld_cluster(at, 0);
    for (uint32_t r = 1; r < split; ++r) {
      const float4 v = ld_cluster(at, r);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    float* o = p.out + ((int64_t)e * p.M + m0 + row) * C + c0 + col;
    if ((p.tma & 8) && c0 + col + 4 <= C) {
      *reinterpret_cast<float4*>(o) = sum;
    } else {
      const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + col + u < C) o[u] = vals[u];
    }
  }
  __syncwarp();
  cluster_sync();   // no block leaves while another reads its partials
}

// ---- host side

// Map of a row-major (E, rows, cols) array in boxes of (1, box_r, box_c),
// no swizzle; false if the driver refuses it.
inline bool make_map3(CUtensorMap* map, CUtensorMapDataType type, int esize,
                      const void* ptr, int E, int rows, int cols, int box_r,
                      int box_c) {
  const wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * esize,
      static_cast<cuuint64_t>(rows) * static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_c),
                             static_cast<cuuint32_t>(box_r), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline cudaLaunchConfig_t cluster_config(dim3 grid, int split, int smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Lets kernel (BC, DX) take `smem` bytes of dynamic shared memory on the
// current device.  The allowance only grows: the plans of other row counts
// ask the occupancy query for other sizes, and a launch must never find
// the bytes of its plan taken back by a query for a smaller one.
template <int BC, bool DX, bool SB>
cudaError_t allow_smem(int smem) {
  static int allowed[64] = {};   // per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && smem <= allowed[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm<BC, DX, SB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess && dev < 64) allowed[dev] = smem;
  return err;
}

template <int BC, bool DX, bool SB>
int launch_bc(const Params& p, int split, int smem, cudaStream_t stream) {
  const int C = DX ? p.K : p.N;
  CUtensorMap maps[2] = {};
  // raw (w, s) boxes: BR rows of k by BC of n (forward), BC by BR (dx)
  const int box_k = DX ? BC : BR, box_n = DX ? BR : BC;
  if (((p.tma & 2) &&
       !make_map3(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.w, p.E,
                  p.K, p.N, box_k, box_n)) ||
      ((p.tma & 4) &&
       !make_map3(&maps[1],
                  SB ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  SB ? 2 : 4, p.s, p.E, p.K, p.N, box_k, box_n)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t allowed = allow_smem<BC, DX, SB>(smem);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(split, (C + BC - 1) / BC,
           p.E * ((p.M + MAX_ROWS - 1) / MAX_ROWS)),
      split, smem, stream, attr);
  Params args = p;
  void* kargs[3] = {&maps[0], &maps[1], &args};
  const cudaError_t err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(grouped_gemm<BC, DX, SB>), kargs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BC, bool DX, bool SB>
int capacity_bc(int split, int smem) {
  cudaError_t err = allow_smem<BC, DX, SB>(smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(split, 1, 1), split, smem, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(grouped_gemm<BC, DX, SB>),
      &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters * split;
}

// Blocks of a plan's width and cluster size that the card holds at once;
// a negative cudaError on failure.  s_bf16: the bf16-score build.
template <bool DX>
int capacity(int bc, int split, int smem, int s_bf16) {
  if (split < 1 || split > 8) return -static_cast<int>(cudaErrorInvalidValue);
  switch (bc) {
#define REPRO_GW_CASE(W)                                  \
  case W:                                                 \
    return s_bf16 ? capacity_bc<W, DX, true>(split, smem) \
                  : capacity_bc<W, DX, false>(split, smem);
    REPRO_GW_WIDTHS(REPRO_GW_CASE)
#undef REPRO_GW_CASE
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel 5 (DX false) or 6 (DX true) under the plan (bc, split, w_stages,
// a_bufs, smem) of `kernels.masked_matmul.grouped_plan` and the wrapper's
// flags `tma`; s_bf16: the scores are bf16 (f32 otherwise).
template <bool DX>
int launch(const void* a, const void* w, const void* s, const void* seeds,
           const void* offs, void* out, int E, int M, int K, int N,
           uint32_t n_logical, int mode, float tau, int s_bf16, int bc,
           int split, int w_stages, int a_bufs, int smem, int tma,
           cudaStream_t stream) {
  if (split < 1 || split > 8 || w_stages < 1 || a_bufs < 1 || a_bufs > 2 ||
      M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = 64 * ((min(M, MAX_ROWS) + 63) / 64);
  const Params p{static_cast<const float*>(a),
                 static_cast<const uint16_t*>(w),
                 s,
                 static_cast<const uint32_t*>(seeds),
                 static_cast<const uint32_t*>(offs),
                 static_cast<float*>(out),
                 E, M, K, N, n_logical, mode, tau, rows, w_stages, a_bufs,
                 tma};
  switch (bc) {
#define REPRO_GW_CASE(W)                                           \
  case W:                                                          \
    return s_bf16 ? launch_bc<W, DX, true>(p, split, smem, stream) \
                  : launch_bc<W, DX, false>(p, split, smem, stream);
    REPRO_GW_WIDTHS(REPRO_GW_CASE)
#undef REPRO_GW_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gw
}  // namespace repro
