// Tensor-core body of kernels 3 and 7 (masked_matmul_ds.cu,
// masked_matmul_grouped_ds.cu): for E stacked problems (kernel 3: E = 1)
//     ds[e] (K, N) = (x[e]^T g[e]) * w[e] * sigmoid'(s[e]),
//     sigmoid'(s) = sigmoid(s) * (1 - sigmoid(s)),
// for x (E, M, K) and g (E, M, N) both bf16 or both f32, w (E, K, N) bf16
// and s (E, K, N) f32, or bf16 (SB: kernel 3 on bf16 scores), with ds in
// s's type: a bf16 score is widened to f32 exactly, ds is computed in f32
// and rounded once to bf16 (to nearest even) at the store, as the
// reference casts its f32 result to s.dtype.
//
// A block owns a BK x BN tile of one group's ds (BK = 128 rows of K: two
// consumer warpgroups of 64; BN = 64 or 128 columns of N) and walks all
// of M for it, so the reduction is never split: no atomics, no partial
// sums in device memory, the same bits on every launch.  The blocks are
// persistent: block b takes tiles b, b + gridDim.x, ..., numbered (group,
// K tile, N tile) with the N tiles fastest, so that the blocks running
// together read whole rows of w and s (in device memory's pages) and
// share x[e]'s slice.  Every operand goes through 3-d tensor
// maps (E, rows, columns) or through loads bounded by the group's own
// rows, so a tile never reads another group's rows.
//
// The product x^T g runs on wgmma (f32 accumulators in registers) with
// both operands MN-major in shared memory (the transpose flags): A = x^T
// has K contiguous in x's rows, B = g has N contiguous, so x and g are
// copied as they lie, in 64-column boxes of 128-byte rows with the
// 128-byte swizzle.  bf16 activations: one load warp keeps a ring of
// 64-row stages of x and g in flight behind mbarriers (TMA, or element
// loads where a row pitch is off the 16-byte grid); rows past M are zero.
// f32 activations: the consumer warps load 32-row stages of x and g
// into registers one stage ahead (the next tile's first stage is in
// flight through this tile's epilogue), split each value into three bf16
// parts (v = v0 + v1 + v2, each part exact) and write them into a
// double-buffered stage, and six products (v0w0, v0w1, v1w0, v0w2, v1w1,
// v2w0; the three smallest terms dropped) accumulate on the tensor cores.
// The consumers' work is latency-bound (split, products and the sigmoid
// epilogue in series, 8 warps): where a tile has one stage (M <= BMF,
// kernel 7 at the MoE capacity) the stage has one buffer and the plan
// runs two blocks of width 64 an SM, each in half the shared memory and
// at most 96 registers a thread, so that 16 consumer warps hide it.
// Past LONG_ROWS rows of M (the LONG build: width 64, one block an SM,
// as `ds_plan` plans it), the tensor cores' partial sum is folded into a
// second set of f32 registers by IEEE adds every PROMOTE stages and
// restarted from zero: the tensor cores' f32 accumulation loses
// precision in one direction, so its error grows with the rows it sums
// (on an H100, 1.6e-4 of the scale at M = 32768 and 1.5e-6 at M = 256,
// against 3e-7 for an f32 matmul), and each partial of PROMOTE * BMF
// rows keeps it at the short sum's.  (At width 128 the second set of
// registers spills.)
//
// The epilogue streams: a second load warp keeps a ring of (w, s) chunks
// in flight by TMA, running up to two tiles ahead of the products.  A
// chunk is the 16 rows x BN columns of a tile that one consumer warp's
// accumulators cover, so that each TMA box reads rows of 128 contiguous
// bytes and each warp waits for its own rows only.  The warp computes
// acc * w * sigmoid(s) * (1 - sigmoid(s)) from its chunk in the
// reference's order (sigmoid of hash.cuh, no fast math), hands the chunk
// back, and stores ds from registers:
// neighbouring lanes swap halves so that each stores 16 bytes and a warp
// writes 8 rows of 64 contiguous bytes (element stores where ds's pitch
// is off the 16-byte grid).  The launch plan (BN, the stages, the
// chunks, the shared-memory bytes, the grid and which operands go by
// TMA) is computed by the Python wrapper (`kernels.masked_matmul.ds_plan`).
#pragma once

#include "masked_matmul_wgmma.cuh"

namespace repro {
namespace dsw {
// Kernels 3 and 7 are two libraries that instantiate the same kernels;
// loaded in one process, the second library's launches were refused
// (cudaErrorInvalidValue) while the symbols were shared, so each library
// keeps its own copy.
namespace {

using wg::fence_async_smem;
using wg::mbar_arrive;
using wg::mbar_arrive_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;
using wg::split3;
using wg::sw128_offset;

constexpr int BK = 128;          // rows of K in a tile: 2 warpgroups
constexpr int BMS = 64;          // rows of M in a bf16 stage
constexpr int BMF = 32;          // rows of M in an f32 stage
constexpr int WR = 16;           // rows of a (w, s) chunk: one warp's
constexpr int CONSUMERS = 256;   // the product + epilogue warps
constexpr int THREADS = CONSUMERS + 64;   // + the two load warps
constexpr int BAR_CONSUMERS = 1;
constexpr int PROMOTE = 4;       // f32 stages summed on the tensor cores
                                 // before an IEEE add folds them (LONG)
constexpr int LONG_ROWS = 512;   // f32 rows of M past which LONG runs
// the widths BN a tile may take (wgmma's N; the plan picks one per shape)
#define REPRO_DS_WIDTHS(X) X(64) X(128)

struct Params {
  const void* x;       // (E, M, K) bf16 or f32
  const void* g;       // (E, M, N) bf16 or f32
  const uint16_t* w;   // (E, K, N) bf16 bits
  const void* s;       // (E, K, N) f32, or bf16 bits (SB)
  void* ds;            // (E, K, N) in s's type
  int E, M, K, N;
  int stages;          // bf16: stages of BMS rows in the x/g ring; f32:
                       // split stages of BMF rows, 2 (one split while the
                       // other is multiplied) or 1 where M <= BMF
  int chunks;          // chunks of (w, s) in the epilogue ring
  int tma;             // bit 0 x, 1 g, 2 w, 3 s, 4 ds on the 16-byte grid
};

// A tile of ds: group e, rows k0.. of K, columns n0.. of N.  Tile t of
// the E * tiles_k * tiles_n, numbered with N fastest, then K, then E.
struct Tile {
  int e, k0, n0;
};
template <int BN>
__device__ __forceinline__ Tile tile_at(int t, int tiles_n, int per_group) {
  const int r = t % per_group;
  return Tile{t / per_group, r / tiles_n * BK, r % tiles_n * BN};
}

// 3-d TMA load of the box at (x = inner, y, z = group) into `dst`.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_CONSUMERS), "n"(CONSUMERS)
               : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma descriptor of an MN-major tile with the 128-byte swizzle: rows of
// 64 MN elements (128 bytes), 8-row groups along the reduction 1024 bytes
// apart, 64-element MN blocks `lbo` bytes apart (1024-byte aligned).
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Byte offset of element (row, col) of a (w, s) chunk of WR rows, each
// held in boxes of WR rows of 128 bytes with the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B on 1024-aligned boxes): w (and bf16 s) in
// boxes of 64 columns, f32 s in boxes of 32.  A warp reading 8 rows of 16
// or 32 bytes finds each row in other banks.
__device__ __forceinline__ uint32_t w_offset(int row, int col) {
  return static_cast<uint32_t>((col >> 6) * (WR * 128) + row * 128 +
                               ((((col >> 3) & 7) ^ (row & 7)) << 4) +
                               (col & 7) * 2);
}
__device__ __forceinline__ uint32_t s_offset(int row, int col) {
  return static_cast<uint32_t>((col >> 5) * (WR * 128) + row * 128 +
                               ((((col >> 2) & 7) ^ (row & 7)) << 4) +
                               (col & 3) * 4);
}

// An f32 value rounded to bf16 (to nearest even), as bits; two of them
// packed low first.
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(bf16_bits(lo)) |
         (static_cast<uint32_t>(bf16_bits(hi)) << 16);
}

// d (64 x BN per warpgroup, f32) += A (64 x 16) @ B (16 x BN), both
// bf16 and MN-major in shared memory (transpose flags 1, 1), scale-d = 1.
template <int BN>
__device__ __forceinline__ void wgmma_mn(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_mn<64>(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_mn<128>(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Shared memory, in bytes from the 1024-aligned base:
//   x/g stages: bf16, `stages` x (x: BK/64 boxes, g: BN/64 boxes, each
//     BMS rows of 128 bytes); f32, `stages` (2, or 1 where M <= BMF: the
//     tile before has finished its products) x (3 x-parts, 3 g-parts,
//     boxes of BMF rows) |
//   (w, s) chunks (chunks x CHUNK: WR rows of w, then of s) |
//   mbarriers: full_xg, empty_xg (stages each), full_ws, empty_ws (chunks)
template <int BN, bool F32, bool SB = false>
struct Layout {
  static constexpr int ROWS = F32 ? BMF : BMS;   // rows of a stage
  static constexpr int BOX = ROWS * 128;         // one 64-column box
  static constexpr int X_BYTES = BK / 64 * BOX;
  static constexpr int G_BYTES = BN / 64 * BOX;
  static constexpr int STAGE = (F32 ? 3 : 1) * (X_BYTES + G_BYTES);
  static constexpr int W_CHUNK = WR * BN * 2, S_CHUNK = WR * BN * (SB ? 2 : 4);
  static constexpr int CHUNK = W_CHUNK + S_CHUNK;
  uint32_t base;
  int stages, chunks;
  __device__ uint32_t x(int st, int part = 0) const {
    return base + st * STAGE + part * X_BYTES;
  }
  __device__ uint32_t g(int st, int part = 0) const {
    return base + st * STAGE + (F32 ? 3 : 1) * X_BYTES + part * G_BYTES;
  }
  __device__ uint32_t w(int c) const {
    return base + stages * STAGE + c * CHUNK;
  }
  __device__ uint32_t s(int c) const { return w(c) + W_CHUNK; }
  __device__ uint32_t bar(int i) const { return w(chunks) + 8 * i; }
  __device__ uint32_t full_xg(int i) const { return bar(i); }
  __device__ uint32_t empty_xg(int i) const { return bar(stages + i); }
  __device__ uint32_t full_ws(int i) const { return bar(2 * stages + i); }
  __device__ uint32_t empty_ws(int i) const {
    return bar(2 * stages + chunks + i);
  }
};

// The (rows x 64*boxes) bf16 tile of the (R, C) matrix at (r0, c0), in
// boxes of 64 columns of 128-byte swizzled rows, by element loads (zero
// past the matrix), for pitches TMA cannot take.
__device__ __forceinline__ void load_mn_tile(uint8_t* dst,
                                             const uint16_t* __restrict__ a,
                                             int R, int C, int r0, int c0,
                                             int rows, int boxes, int lane) {
  for (int e = lane; e < rows * 8 * boxes; e += 32) {
    const int box = e / (rows * 8), rem = e % (rows * 8);
    const int row = rem >> 3, chunk = rem & 7, gr = r0 + row;
    uint32_t v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t pair = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gc = c0 + box * 64 + chunk * 8 + 2 * t + h;
        if (gr < R && gc < C)
          pair |= static_cast<uint32_t>(a[(int64_t)gr * C + gc]) << (16 * h);
      }
      v[t] = pair;
    }
    *reinterpret_cast<uint4*>(dst + box * rows * 128 +
                              sw128_offset(row, chunk)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// f32 stage, in two halves so that the loads of the next stage are in
// flight while this one is multiplied: `load_stage` reads rows m0.. of
// x[e]'s columns k0.. and g[e]'s columns n0.. into registers (vector
// loads where a row lies on the 16-byte grid, element loads, zero past
// the group's matrix, elsewhere), `store_stage` splits them into three
// bf16 parts each and writes them into the stage's swizzled boxes.
template <int BN>
struct F32Stage {
  static constexpr int X_TASKS = BMF * BK / 8, TASKS = BMF * (BK + BN) / 8;
  static constexpr int PER = TASKS / CONSUMERS;
  static_assert(TASKS % CONSUMERS == 0, "whole tasks per thread");
  float v[PER][8];
};

template <int BN>
__device__ __forceinline__ void load_stage(F32Stage<BN>& f, const Params& p,
                                           const Tile& tl, int m0, int tid) {
  using F = F32Stage<BN>;
  const float* xe = static_cast<const float*>(p.x) + (int64_t)tl.e * p.M * p.K;
  const float* ge = static_cast<const float*>(p.g) + (int64_t)tl.e * p.M * p.N;
#pragma unroll
  for (int i = 0; i < F::PER; ++i) {
    const int e = tid + i * CONSUMERS;
    const bool is_x = e < F::X_TASKS;
    const int cols = is_x ? BK / 8 : BN / 8, t = is_x ? e : e - F::X_TASKS;
    const int row = t / cols, gm = m0 + row;
    const int C = is_x ? p.K : p.N;
    const int gc = (is_x ? tl.k0 : tl.n0) + (t % cols) * 8;
    const float* src = is_x ? xe : ge;
    const bool vec = (p.tma >> (is_x ? 0 : 1)) & 1;
    if (vec && gm < p.M && gc + 8 <= C) {
      const float4* q =
          reinterpret_cast<const float4*>(src + (int64_t)gm * C + gc);
      const float4 a = q[0], b = q[1];
      f.v[i][0] = a.x; f.v[i][1] = a.y; f.v[i][2] = a.z; f.v[i][3] = a.w;
      f.v[i][4] = b.x; f.v[i][5] = b.y; f.v[i][6] = b.z; f.v[i][7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f.v[i][j] = (gm < p.M && gc + j < C) ? src[(int64_t)gm * C + gc + j]
                                             : 0.0f;
    }
  }
}

template <int BN>
__device__ __forceinline__ void store_stage(const F32Stage<BN>& f,
                                            uint8_t* st_x, uint8_t* st_g,
                                            int tid) {
  using F = F32Stage<BN>;
  using L = Layout<BN, true>;
#pragma unroll
  for (int i = 0; i < F::PER; ++i) {
    const int e = tid + i * CONSUMERS;
    const bool is_x = e < F::X_TASKS;
    const int cols = is_x ? BK / 8 : BN / 8, t = is_x ? e : e - F::X_TASKS;
    const int row = t / cols, cg = t % cols;
    uint16_t parts[3][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint16_t q[3];
      split3(f.v[i][j], q);
      parts[0][j] = q[0]; parts[1][j] = q[1]; parts[2][j] = q[2];
    }
    uint8_t* dst = (is_x ? st_x : st_g) + (cg >> 3) * L::BOX +
                   sw128_offset(row, cg & 7);
    const int part_bytes = is_x ? L::X_BYTES : L::G_BYTES;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      *reinterpret_cast<uint4*>(dst + k * part_bytes) =
          *reinterpret_cast<const uint4*>(parts[k]);
  }
}

// Width 64 at f32 runs two blocks an SM (the plan of M <= BMF), so that
// 16 consumer warps hide the epilogue's latency: at most 96 registers.
// LONG (f32, M > LONG_ROWS, width 64: one block an SM) folds the
// partial sums.
template <int BN, bool F32, bool LONG, bool SB>
__global__ void __launch_bounds__(THREADS,
                                  (F32 && BN == 64 && !LONG) ? 2 : 1)
    ds_gemm(const __grid_constant__ CUtensorMap map_x,
            const __grid_constant__ CUtensorMap map_g,
            const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_s, const Params p) {
  using L = Layout<BN, F32, SB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const L lay{base, p.stages, p.chunks};
  auto gen = [&](uint32_t addr) { return gbase + (addr - base); };

  const int tiles_n = (p.N + BN - 1) / BN;
  const int per_group = (p.K + BK - 1) / BK * tiles_n;
  const int tiles = p.E * per_group;
  const int64_t wsize = (int64_t)p.K * p.N;   // w, s, ds of one group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(lay.full_xg(i), 32);
      mbar_init(lay.empty_xg(i), CONSUMERS / 32);
    }
    for (int i = 0; i < p.chunks; ++i) {
      mbar_init(lay.full_ws(i), 32);
      mbar_init(lay.empty_ws(i), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- load warp 8: the bf16 x/g stages, a ring across tiles
    if (F32) return;
    const uint32_t tx = (p.tma & 1) * L::X_BYTES + ((p.tma >> 1) & 1) *
                                                       L::G_BYTES;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Tile tl = tile_at<BN>(tile, tiles_n, per_group);
      const uint16_t* xe =
          static_cast<const uint16_t*>(p.x) + (int64_t)tl.e * p.M * p.K;
      const uint16_t* ge =
          static_cast<const uint16_t*>(p.g) + (int64_t)tl.e * p.M * p.N;
      for (int m0 = 0; m0 < p.M; m0 += BMS, ++it) {
        const int st = it % p.stages;
        mbar_wait(lay.empty_xg(st), ((it / p.stages) & 1) ^ 1);
        if (!(p.tma & 1))
          load_mn_tile(gen(lay.x(st)), xe, p.M, p.K, m0, tl.k0, BMS, BK / 64,
                       lane);
        if (!(p.tma & 2))
          load_mn_tile(gen(lay.g(st)), ge, p.M, p.N, m0, tl.n0, BMS, BN / 64,
                       lane);
        fence_async_smem();
        if (lane == 0) {
          mbar_arrive_tx(lay.full_xg(st), tx);
          if (p.tma & 1)
            for (int b = 0; b < BK / 64; ++b)
              tma_load3(lay.x(st) + b * L::BOX, &map_x, tl.k0 + 64 * b, m0,
                        tl.e, lay.full_xg(st));
          if (p.tma & 2)
            for (int b = 0; b < BN / 64; ++b)
              tma_load3(lay.g(st) + b * L::BOX, &map_g, tl.n0 + 64 * b, m0,
                        tl.e, lay.full_xg(st));
        } else {
          mbar_arrive(lay.full_xg(st));
        }
      }
    }
    return;
  }
  if (warp == CONSUMERS / 32 + 1) {
    // ---- load warp 9: the (w, s) chunks of the epilogue, WR rows of a
    // tile each, one for each consumer warp, in a ring across tiles that
    // runs ahead of the products.  Rows past K are not loaded (their ds
    // is not stored).
    const uint32_t tx = ((p.tma >> 2) & 1) * L::W_CHUNK +
                        ((p.tma >> 3) & 1) * L::S_CHUNK;
    int q = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Tile tl = tile_at<BN>(tile, tiles_n, per_group);
      const uint16_t* we = p.w + tl.e * wsize;
      const float* se = static_cast<const float*>(p.s) + tl.e * wsize;
      const uint16_t* se16 = static_cast<const uint16_t*>(p.s) + tl.e * wsize;
      for (int v = 0; v < CONSUMERS / 32; ++v, ++q) {
        const int st = q % p.chunks, r0 = tl.k0 + v * WR;
        mbar_wait(lay.empty_ws(st), ((q / p.chunks) & 1) ^ 1);
        const bool in_k = r0 < p.K;
        if (in_k && (p.tma & 12) != 12) {   // element loads, zero past N
          uint8_t* wd = gen(lay.w(st));
          uint8_t* sd = gen(lay.s(st));
          for (int e = lane; e < WR * BN; e += 32) {
            const int row = e / BN, col = e % BN;
            const int gk = r0 + row, gn = tl.n0 + col;
            const bool in = gk < p.K && gn < p.N;
            const int64_t o = (int64_t)gk * p.N + gn;
            if (!(p.tma & 4))
              *reinterpret_cast<uint16_t*>(wd + w_offset(row, col)) =
                  in ? we[o] : uint16_t(0);
            if (!(p.tma & 8) && SB)
              *reinterpret_cast<uint16_t*>(sd + w_offset(row, col)) =
                  in ? se16[o] : uint16_t(0);
            else if (!(p.tma & 8))
              *reinterpret_cast<float*>(sd + s_offset(row, col)) =
                  in ? se[o] : 0.0f;
          }
        }
        fence_async_smem();
        if (lane == 0) {
          mbar_arrive_tx(lay.full_ws(st), in_k ? tx : 0);
          if (in_k && (p.tma & 4))
            for (int b = 0; b < BN / 64; ++b)
              tma_load3(lay.w(st) + b * WR * 128, &map_w, tl.n0 + 64 * b, r0,
                        tl.e, lay.full_ws(st));
          if (in_k && (p.tma & 8))
            for (int b = 0; b < BN / (SB ? 64 : 32); ++b)
              tma_load3(lay.s(st) + b * WR * 128, &map_s,
                        tl.n0 + (SB ? 64 : 32) * b, r0, tl.e,
                        lay.full_ws(st));
        } else {
          mbar_arrive(lay.full_ws(st));
        }
      }
    }
    return;
  }

  // ---- warps 0-7: the products, then the epilogue, tile by tile.  Thread
  // (warp v of warpgroup wgi = v/4, lane) holds ds rows 16v + lane/4 (+8)
  // and columns 8j + 2(lane%4) (+1), j < BN/8.
  const int tid = threadIdx.x, wgi = tid >> 7;
  float acc[BN / 2];
  int it = 0, q = tid >> 5;   // q: this warp's (w, s) chunk
  // f32: the registers of the next stage to split, loaded one stage ahead
  F32Stage<BN> next;
  if (F32 && p.M > 0 && (int)blockIdx.x < tiles)
    load_stage<BN>(next, p, tile_at<BN>(blockIdx.x, tiles_n, per_group), 0,
                   tid);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_at<BN>(tile, tiles_n, per_group);
    if (!F32) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int m0 = 0; m0 < p.M; m0 += BMS, ++it) {
        const int st = it % p.stages;
        mbar_wait(lay.full_xg(st), (it / p.stages) & 1);
        const uint64_t da = mn_desc(lay.x(st) + wgi * L::BOX, L::BOX);
        const uint64_t db = mn_desc(lay.g(st), L::BOX);
        wg::fence_regs<BN / 2>(acc);
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BMS / 16; ++kk)   // 16 rows of 128 bytes
          wgmma_mn<BN>(acc, da + 128 * kk, db + 128 * kk);
        wg::wgmma_commit();
        if (m0 > 0) {   // the stage before is read: hand it back
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(lay.empty_xg((it - 1) % p.stages));
        }
      }
      wgmma_wait<0>();
      wg::fence_regs<BN / 2>(acc);
      __syncwarp();
      if (p.M > 0 && lane == 0) mbar_arrive(lay.empty_xg((it - 1) % p.stages));
    } else {
      // LONG: the folded partial sums (unused otherwise)
      float tot[LONG ? BN / 2 : 1];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      if (LONG) {
#pragma unroll
        for (int i = 0; i < (LONG ? BN / 2 : 1); ++i) tot[i] = 0.0f;
      }
      for (int m0 = 0, n_st = 1; m0 < p.M; m0 += BMF, ++it, ++n_st) {
        const int st = it % p.stages;
        wgmma_wait<1>();     // this warpgroup's products of stage it - 2
                             // (with one buffer, M <= BMF: of the tile
                             // before, which waited for all of them)
        consumers_sync();    // ... and the other's: the buffer is free
        store_stage<BN>(next, gen(lay.x(st)), gen(lay.g(st)), tid);
        fence_async_smem();
        consumers_sync();
        // the next stage's loads: this tile's next rows, or the first
        // rows of this block's next tile, in flight through the products
        // and the epilogue
        if (m0 + BMF < p.M)
          load_stage<BN>(next, p, tl, m0 + BMF, tid);
        else if (tile + (int)gridDim.x < tiles)
          load_stage<BN>(next, p,
                         tile_at<BN>(tile + gridDim.x, tiles_n, per_group), 0,
                         tid);
        wg::fence_regs<BN / 2>(acc);
        wg::wgmma_fence();
        // x part a times g part b: the six significant cross products,
        // smallest first
        auto mma = [&](int a, int b) {
#pragma unroll
          for (int kk = 0; kk < BMF / 16; ++kk)
            wgmma_mn<BN>(acc,
                         mn_desc(lay.x(st, a) + wgi * L::BOX, L::BOX) +
                             128 * kk,
                         mn_desc(lay.g(st, b), L::BOX) + 128 * kk);
        };
        mma(2, 0); mma(1, 1); mma(0, 2); mma(1, 0); mma(0, 1); mma(0, 0);
        wg::wgmma_commit();
        if (LONG && n_st % PROMOTE == 0 && m0 + BMF < p.M) {
          // fold this partial into tot and restart the tensor cores' sum
          wgmma_wait<0>();
          wg::fence_regs<BN / 2>(acc);
#pragma unroll
          for (int i = 0; i < (LONG ? BN / 2 : 1); ++i) {
            tot[i] += acc[i];
            acc[i] = 0.0f;
          }
        }
      }
      wgmma_wait<0>();
      wg::fence_regs<BN / 2>(acc);
      if (LONG) {
#pragma unroll
        for (int i = 0; i < (LONG ? BN / 2 : 1); ++i) acc[i] += tot[i];
      }
    }

    // ---- the epilogue: this warp's chunk of WR rows, handed back once
    // the warp's ds is computed; ds overwrites the accumulators
    {
      const int st = q % p.chunks;
      mbar_wait(lay.full_ws(st), (q / p.chunks) & 1);
      const uint8_t* wb = gen(lay.w(st));
      const uint8_t* sb = gen(lay.s(st));
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (lane >> 2) + 8 * h;
          float2 sv;
          if (SB) {   // two bf16 scores, widened exactly
            const uint32_t b2 =
                *reinterpret_cast<const uint32_t*>(sb + w_offset(row, col));
            sv = make_float2(__uint_as_float(b2 << 16),
                             __uint_as_float(b2 & 0xFFFF0000u));
          } else {
            sv = *reinterpret_cast<const float2*>(sb + s_offset(row, col));
          }
          const uint32_t wv =
              *reinterpret_cast<const uint32_t*>(wb + w_offset(row, col));
          const float sig0 = sigmoid(sv.x), sig1 = sigmoid(sv.y);
          acc[4 * j + 2 * h] = acc[4 * j + 2 * h] *
                               __uint_as_float((wv & 0xFFFFu) << 16) * sig0 *
                               (1.0f - sig0);
          acc[4 * j + 2 * h + 1] = acc[4 * j + 2 * h + 1] *
                                   __uint_as_float(wv & 0xFFFF0000u) * sig1 *
                                   (1.0f - sig1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(lay.empty_ws(st));
      q += CONSUMERS / 32;
    }
    const int odd = lane & 1;
    float* const dse = static_cast<float*>(p.ds) + tl.e * wsize;
    uint16_t* const dse16 = static_cast<uint16_t*>(p.ds) + tl.e * wsize;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gk = tl.k0 + (tid >> 5) * WR + (lane >> 2) + 8 * h;
      float* o = dse + (int64_t)gk * p.N + tl.n0;
      uint16_t* o16 = dse16 + (int64_t)gk * p.N + tl.n0;
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        const float2 dj =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        const float2 dk = make_float2(acc[4 * j + 4 + 2 * h],
                                      acc[4 * j + 4 + 2 * h + 1]);
        if (p.tma & 16) {
          // 16-byte stores: of two neighbouring lanes (two columns each of
          // groups j and j+1) the even one stores 4 columns of j, the odd
          // one 4 of j+1
          const float2 mine = odd ? dk : dj, theirs = odd ? dj : dk;
          const float2 got =
              make_float2(__shfl_xor_sync(0xFFFFFFFFu, theirs.x, 1),
                          __shfl_xor_sync(0xFFFFFFFFu, theirs.y, 1));
          const int gn = 8 * (j + odd) + 4 * ((lane & 3) >> 1);
          const float4 v = odd ? make_float4(got.x, got.y, mine.x, mine.y)
                               : make_float4(mine.x, mine.y, got.x, got.y);
          if (gk < p.K && tl.n0 + gn < p.N) {
            if (SB)   // 8 bytes: 4 columns in bf16
              *reinterpret_cast<uint2*>(o16 + gn) =
                  make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
            else
              *reinterpret_cast<float4*>(o + gn) = v;
          }
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float2 d = u ? dk : dj;
            const int gn = 8 * (j + u) + 2 * (lane & 3);
            if (SB) {
              if (gk < p.K && tl.n0 + gn < p.N) o16[gn] = bf16_bits(d.x);
              if (gk < p.K && tl.n0 + gn + 1 < p.N)
                o16[gn + 1] = bf16_bits(d.y);
            } else {
              if (gk < p.K && tl.n0 + gn < p.N) o[gn] = d.x;
              if (gk < p.K && tl.n0 + gn + 1 < p.N) o[gn + 1] = d.y;
            }
          }
        }
      }
    }
  }
}

// ---- host side

// Map of E stacked row-major (rows, cols) matrices in boxes of
// (1, box_r, box_c) with the 128-byte swizzle: a box past a group's rows
// or columns is filled with zeros, never with the next group's; false if
// cuTensorMapEncodeTiled refuses it.
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
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool F32, bool LONG, bool SB>
int launch_bn(const Params& p, int smem, int grid, cudaStream_t stream) {
  using L = Layout<BN, F32, SB>;
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr auto FP32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap maps[4] = {};
  if ((!F32 && (p.tma & 1) &&
       !make_map3(&maps[0], BF16, 2, p.x, p.E, p.M, p.K, L::ROWS, 64)) ||
      (!F32 && (p.tma & 2) &&
       !make_map3(&maps[1], BF16, 2, p.g, p.E, p.M, p.N, L::ROWS, 64)) ||
      ((p.tma & 4) &&
       !make_map3(&maps[2], BF16, 2, p.w, p.E, p.K, p.N, WR, 64)) ||
      ((p.tma & 8) &&
       !make_map3(&maps[3], SB ? BF16 : FP32, SB ? 2 : 4, p.s, p.E, p.K, p.N,
                  WR, SB ? 64 : 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = ds_gemm<BN, F32, LONG, SB>;
  static int smem_set[64] = {};   // largest size allowed, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || smem > smem_set[dev]) {
    // all of the SM's shared memory for blocks: two of width 64 at f32
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = smem;
  }
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                          p);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 3 (E = 1) or 7 under the plan (bn, stages, chunks, smem, grid,
// tma) of `kernels.masked_matmul.ds_plan`; SB: bf16 scores and ds.
template <bool SB>
inline int launch(const void* x, const void* g, const void* w, const void* s,
                  void* ds, int E, int M, int K, int N, int x_f32, int bn,
                  int stages, int chunks, int smem, int grid, int tma,
                  cudaStream_t stream) {
  // a ring of fewer chunks than consumer warps would let a warp wait on
  // a slot two phases ahead, which an mbarrier's parity cannot tell apart
  if (E < 1 || stages < (x_f32 ? 1 : 2) || chunks < CONSUMERS / 32 ||
      grid < 1 || (x_f32 && (stages > 2 || (stages == 1 && M > BMF))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, g, static_cast<const uint16_t*>(w), s, ds,
                 E, M, K, N, stages, chunks, tma};
  if (x_f32 && M > LONG_ROWS)
    return bn == 64 ? launch_bn<64, true, true, SB>(p, smem, grid, stream)
                    : static_cast<int>(cudaErrorInvalidValue);
  switch (bn) {
#define REPRO_DS_CASE(W)                                                \
  case W:                                                               \
    return x_f32 ? launch_bn<W, true, false, SB>(p, smem, grid, stream)  \
                 : launch_bn<W, false, false, SB>(p, smem, grid, stream);
    REPRO_DS_WIDTHS(REPRO_DS_CASE)
#undef REPRO_DS_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace dsw
}  // namespace repro
