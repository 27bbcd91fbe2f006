// Tensor-core body of the masked-matmul kernels 1-2 for bf16 activations
// (masked_matmul_fwd.cu: y = x @ (m*w); masked_matmul_dx.cu:
// dx = g @ (m*w)^T), one template over the orientation.
//
// Both are one product  out (M, C) = A (M, R) @ B (R, C)  with the
// reduction axis R contiguous in A:
//     forward   A = x (M, K), R = K, C = N, B[r][c] = (m*w)[r][c]
//     dx        A = g (M, N), R = N, C = K, B[r][c] = (m*w)[c][r]
// so only the gating differs: it reads the raw (K, N) tile of w and s and
// writes B's tile straight from registers in the layout wgmma reads, and
// the transposition dx needs costs nothing.
//
// One block owns all rows of an M block (ROWS = 256) and BC output
// columns, so every weight of its tile is hashed, gated and read once per
// launch and M block, not once per 64-row output tile.  Its warps:
//   - warps 0-15 (four warpgroups of 64 rows each) gate the raw tile of
//     stage i+1 into a 128-byte-swizzled (BC x 64) bf16 tile of m*w in
//     shared memory while the tensor cores run wgmma m64nBCk16 (bf16 in,
//     f32 accumulators in registers) on stage i;
//   - warps 16 and 17 keep the loads in flight, one per ring: a ring of
//     raw (w, s) stages and a ring of two A stages, each behind full/empty
//     mbarriers; TMA (cp.async.bulk.tensor, zero fill past the edges)
//     where a row pitch is a multiple of 16 bytes, element loads with
//     zero fill elsewhere.
// The reduction axis is split over the blocks of a thread-block cluster
// (gridDim.x = cluster size <= 8): each block sums its range of 64-deep
// stages into f32 registers, parks them in its shared memory, and after a
// cluster barrier each block adds its share of rows over the cluster's
// partials through distributed shared memory in rank order 0, 1, ... and
// stores bf16.  No float atomics and no partial sums in device memory:
// the same inputs give the same bits on every launch.
//
// The scores come as f32 or bf16 (SB, the score type of the launch): a
// raw s stage holds them as they lie in device memory, 4 or 2 bytes an
// element, and the gating widens a bf16 score to f32 exactly (its bits
// shifted up) before mask_bit, so the mask of a bf16 score block is the
// mask of its f32 upcast, as the reference's kernel upcasts it.
//
// The mask is mask_bit() of hash.cuh on the element's own index
// off + k*n_logical + n (uint32, wrapping), as in every kernel of the
// port, so it does not depend on this tiling.  The launch plan (BC, the
// cluster size, the number of raw stages, the shared-memory bytes and
// which operands go by TMA) is computed by the Python wrapper
// (`kernels.masked_matmul.wgmma_plan`) and passed in.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hash.cuh"

namespace repro {
namespace wg {

constexpr int ROWS = 256;        // rows of an M block: 4 warpgroups of 64
constexpr int BR = 64;           // reduction depth of a stage (128 bytes)
constexpr int CONSUMERS = 512;   // the gating + wgmma warps
constexpr int THREADS = CONSUMERS + 64;   // + two load warps
constexpr int A_STAGES = 2;
constexpr int A_BYTES = ROWS * BR * 2;
constexpr int PAD = 8;           // f32 pad of a row of parked partials
constexpr int BAR_CONSUMERS = 1; // named barrier of warps 0-15
// The widths BC a block's output tile may take (multiples of 16 up to
// 128, whose 64 accumulators a thread still holds in its 96 registers:
// wgmma's N, B's 8-row swizzle groups, 16-byte TMA rows); the
// launch plan picks one per shape, so that whole clusters fill the card.
#define REPRO_WG_WIDTHS(X) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

struct Params {
  const uint16_t* a;   // x (forward) or g (dx): (M, R) bf16 bits
  const uint16_t* w;   // (K, N) bf16 bits
  const void* s;       // (K, N) f32, or bf16 bits (SB)
  uint16_t* out;       // (M, C) bf16 bits
  int M, K, N;
  uint32_t seed, off, n_logical;
  int mode;
  float tau;
  int w_stages;        // raw (w, s) stages in the ring
  int tma;             // bit 0: A by TMA, bit 1: w, bit 2: s
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` of `bar` has completed.  A
// wait of 2^35 cycles (over 15 s) is a fault: trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

// Generic-proxy writes to shared memory, made visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_CONSUMERS), "n"(CONSUMERS)
               : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// f32x4 at the same shared offset in cluster block `rank`.
__device__ __forceinline__ float4 ld_cluster(uint32_t local, uint32_t rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// 2-d TMA load of the box at (x = inner, y = outer) into `dst`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle,
// 8-row groups 1024 bytes apart (the tile 1024-byte aligned).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Byte offset of the 16-byte chunk `chunk` (0-7) of row `row` in a tile of
// 128-byte rows with the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B).
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Three bf16 parts of v, each exact: v = p0 + p1 + p2 up to the last
// bits of the third.
__device__ __forceinline__ void split3(float v, uint16_t* p) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(h0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(r1);
  const float r2 = r1 - __bfloat162float(h1);
  p[0] = __bfloat16_as_ushort(h0);
  p[1] = __bfloat16_as_ushort(h1);
  p[2] = __bfloat16_as_ushort(__float2bfloat16_rn(r2));
}

// Keeps the compiler from touching accumulators across an async wgmma.
template <int NREG>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < NREG; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x BC per warpgroup, f32) += A (64 x 16) @ B (16 x BC), both
// K-major bf16 in shared memory, scale-d = 1.
template <int BC>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<48>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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
__device__ __forceinline__ void wgmma_bf16<80>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<112>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t da,
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// Shared-memory layout, in bytes from the 1024-aligned base:
//   A stages (A_STAGES x A_BYTES) | B tiles (2 x BC*128) |
//   raw w stages (w_stages x BR*BC*2) |
//   raw s stages (w_stages x BR*BC*4, or *2 for bf16 scores) |
//   mbarriers: full_a, empty_a (A_STAGES each), full_w, empty_w (w_stages)
// The partials of the cluster reduction (ROWS x (BC + PAD) f32) are parked
// over the start of it once the main loop is done.
template <int BC, bool SB>
struct Layout {
  static constexpr int B_BYTES = BC * BR * 2;
  static constexpr int W_BYTES = BR * BC * 2;
  static constexpr int S_BYTES = BR * BC * (SB ? 2 : 4);
  uint32_t base;
  int ws;
  __device__ uint32_t a(int i) const { return base + i * A_BYTES; }
  __device__ uint32_t b(int i) const {
    return base + A_STAGES * A_BYTES + i * B_BYTES;
  }
  __device__ uint32_t w(int i) const { return b(2) + i * W_BYTES; }
  __device__ uint32_t s(int i) const { return w(ws) + i * S_BYTES; }
  __device__ uint32_t bar(int i) const { return s(ws) + 8 * i; }
  __device__ uint32_t full_a(int i) const { return bar(i); }
  __device__ uint32_t empty_a(int i) const { return bar(A_STAGES + i); }
  __device__ uint32_t full_w(int i) const { return bar(2 * A_STAGES + i); }
  __device__ uint32_t empty_w(int i) const {
    return bar(2 * A_STAGES + ws + i);
  }
};

// The (ROWS x BR) A tile of rows m0.., columns r0.. in the swizzled layout,
// by element loads (zero past the matrix), for pitches TMA cannot take.
__device__ __forceinline__ void load_a_tile(uint8_t* dst,
                                            const uint16_t* __restrict__ a,
                                            int rows, int cols, int m0, int r0,
                                            int lane) {
  for (int e = lane; e < ROWS * 8; e += 32) {
    const int row = e >> 3, chunk = e & 7, gm = m0 + row;
    uint32_t v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t pair = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gc = r0 + chunk * 8 + 2 * t + h;
        if (gm < rows && gc < cols)
          pair |= static_cast<uint32_t>(a[(int64_t)gm * cols + gc]) << (16 * h);
      }
      v[t] = pair;
    }
    *reinterpret_cast<uint4*>(dst + sw128_offset(row, chunk)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// A dense row-major (nr x nc) tile of the (rows, cols) matrix at (r0, c0),
// zero past the matrix, by element loads.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int rows, int cols, int r0, int c0,
                                          int nr, int nc, int lane) {
  for (int e = lane; e < nr * nc; e += 32) {
    const int r = r0 + e / nc, c = c0 + e % nc;
    dst[e] = (r < rows && c < cols) ? src[(int64_t)r * cols + c] : T(0);
  }
}

// A score as f32: bf16 bits widened exactly, or the f32 itself.
__device__ __forceinline__ float score_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float score_f32(float v) { return v; }

// Eight consecutive scores of a raw s tile (16-byte aligned) as f32.
__device__ __forceinline__ void load8(const float* q, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  const float4 b = *reinterpret_cast<const float4*>(q + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const uint16_t* q, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(q);
  const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    v[2 * t] = __uint_as_float(u[t] << 16);
    v[2 * t + 1] = __uint_as_float(u[t] & 0xFFFF0000u);
  }
}

// Gate the raw (w, s) tile of the stage starting at reduction index r0 into
// B's (BC x BR) bf16 tile: B[c][r] = m*w of reduction element r0 + r and
// output column c0 + c, written 16 bytes (8 consecutive r) at a time.
// The raw tile is (BR x BC) [k][n] for the forward, (BC x BR) [k][n] for
// dx; its zero fill past the matrix makes B zero there.  MODE is the
// mask mode as a constant, so that mask_bit's mode test folds away.
template <int BC, bool DX, int MODE, typename S>
__device__ __forceinline__ void gate_tile(uint8_t* b, const uint16_t* wr,
                                          const S* sr, int r0, int c0,
                                          uint32_t smix, const Params& p,
                                          int tid) {
  for (int e = tid; e < BC * 8; e += CONSUMERS) {
    // consecutive threads: dx along a raw row (16-byte loads), the forward
    // along c (conflict-free strided loads); both store conflict-free
    const int c = DX ? e >> 3 : e % BC;
    const int rg = DX ? e & 7 : e / BC;
    uint16_t wv[8];
    float sv[8];
    if (DX) {
      const uint4 w4 = *reinterpret_cast<const uint4*>(wr + c * BR + rg * 8);
      const uint32_t wu[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int t = 0; t < 8; ++t)
        wv[t] = static_cast<uint16_t>(wu[t >> 1] >> (16 * (t & 1)));
      load8(sr + c * BR + rg * 8, sv);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        wv[t] = wr[(rg * 8 + t) * BC + c];
        sv[t] = score_f32(sr[(rg * 8 + t) * BC + c]);
      }
    }
    // element t is (k, n) = (c0 + c, r0 + 8rg + t) for dx and
    // (r0 + 8rg + t, c0 + c) for the forward
    const uint32_t k = DX ? c0 + c : r0 + rg * 8;
    const uint32_t n = DX ? r0 + rg * 8 : c0 + c;
    const uint32_t idx = p.off + k * p.n_logical + n;
    const uint32_t step = DX ? 1u : p.n_logical;
    uint32_t v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t lo =
          mask_bit(sv[2 * t], idx + (2 * t) * step, smix, MODE, p.tau)
              ? wv[2 * t] : 0u;
      const uint32_t hi = mask_bit(sv[2 * t + 1], idx + (2 * t + 1) * step,
                                   smix, MODE, p.tau)
                              ? wv[2 * t + 1] : 0u;
      v[t] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(b + sw128_offset(c, rg)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <int BC, bool DX, bool SB>
__global__ void __launch_bounds__(THREADS, 1)
    gated_gemm(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_s, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  using S = typename std::conditional<SB, uint16_t, float>::type;
  const Layout<BC, SB> L{base, p.w_stages};
  auto gen = [&](uint32_t addr) { return gbase + (addr - base); };

  const int R = DX ? p.N : p.K, C = DX ? p.K : p.N;
  const int steps = (R + BR - 1) / BR;
  const uint32_t q = cluster_rank(), split = cluster_size();
  const int j0 = static_cast<int>((int64_t)steps * q / split);
  const int n = static_cast<int>((int64_t)steps * (q + 1) / split) - j0;
  const int c0 = blockIdx.y * BC, m0 = blockIdx.z * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t smix = seed_mix(p.seed);

  if (threadIdx.x == 0) {
    for (int i = 0; i < A_STAGES; ++i) {
      mbar_init(L.full_a(i), 32);
      mbar_init(L.empty_a(i), CONSUMERS / 32);
    }
    for (int i = 0; i < p.w_stages; ++i) {
      mbar_init(L.full_w(i), 32);
      mbar_init(L.empty_w(i), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[BC / 2];
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) acc[i] = 0.0f;

  if (warp >= CONSUMERS / 32) {
    // ---- the load warps, one per ring, so that the raw stages run as far
    // ahead as their ring allows whatever the A ring waits for
    const uint32_t w_tx = ((p.tma >> 1) & 1) * Layout<BC, SB>::W_BYTES +
                          ((p.tma >> 2) & 1) * Layout<BC, SB>::S_BYTES;
    auto load_w = [&](int i) {
      const int st = i % p.w_stages, r0 = (j0 + i) * BR;
      mbar_wait(L.empty_w(st), ((i / p.w_stages) & 1) ^ 1);
      uint16_t* wd = reinterpret_cast<uint16_t*>(gen(L.w(st)));
      S* sd = reinterpret_cast<S*>(gen(L.s(st)));
      // the raw tile's rows and columns in (K, N)
      const int kr = DX ? c0 : r0, nc = DX ? r0 : c0;
      const int nkr = DX ? BC : BR, nnc = DX ? BR : BC;
      if (!(p.tma & 2)) load_tile(wd, p.w, p.K, p.N, kr, nc, nkr, nnc, lane);
      if (!(p.tma & 4))
        load_tile(sd, static_cast<const S*>(p.s), p.K, p.N, kr, nc, nkr, nnc,
                  lane);
      fence_async_smem();
      if (lane == 0) {
        mbar_arrive_tx(L.full_w(st), w_tx);
        if (p.tma & 2) tma_load(L.w(st), &map_w, nc, kr, L.full_w(st));
        if (p.tma & 4) tma_load(L.s(st), &map_s, nc, kr, L.full_w(st));
      } else {
        mbar_arrive(L.full_w(st));
      }
    };
    auto load_a = [&](int i) {
      const int st = i % A_STAGES, r0 = (j0 + i) * BR;
      mbar_wait(L.empty_a(st), ((i / A_STAGES) & 1) ^ 1);
      if (!(p.tma & 1)) load_a_tile(gen(L.a(st)), p.a, p.M, R, m0, r0, lane);
      fence_async_smem();
      if (lane == 0) {
        mbar_arrive_tx(L.full_a(st), (p.tma & 1) ? A_BYTES : 0);
        if (p.tma & 1) tma_load(L.a(st), &map_a, r0, m0, L.full_a(st));
      } else {
        mbar_arrive(L.full_a(st));
      }
    };
    for (int i = 0; i < n; ++i) {
      if (warp == CONSUMERS / 32)
        load_w(i);
      else
        load_a(i);
    }
  } else {
    // ---- warps 0-15: gate stage i+1 while the tensor cores run stage i
    const int tid = threadIdx.x, wgi = tid >> 7;
    auto gate = [&](int i) {
      const int st = i % p.w_stages;
      mbar_wait(L.full_w(st), (i / p.w_stages) & 1);
      const uint16_t* wr = reinterpret_cast<const uint16_t*>(gen(L.w(st)));
      const S* sr = reinterpret_cast<const S*>(gen(L.s(st)));
      if (p.mode == 1)
        gate_tile<BC, DX, 1>(gen(L.b(i & 1)), wr, sr, (j0 + i) * BR, c0, smix,
                             p, tid);
      else
        gate_tile<BC, DX, 0>(gen(L.b(i & 1)), wr, sr, (j0 + i) * BR, c0, smix,
                             p, tid);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(L.empty_w(st));
    };
    if (n > 0) gate(0);
    consumers_sync();
    for (int i = 0; i < n; ++i) {
      const int st = i % A_STAGES;
      mbar_wait(L.full_a(st), (i / A_STAGES) & 1);
      // every warpgroup multiplies, also on rows past M (zero-filled A):
      // a wgmma under a branch would make the compiler wait for it at
      // the join, before the gating below could run beside it
      const uint64_t da = sw128_desc(L.a(st) + wgi * 64 * 128);
      const uint64_t db = sw128_desc(L.b(i & 1));
      fence_regs<BC / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)   // +32 bytes along K each
        wgmma_bf16<BC>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      if (i + 1 < n) gate(i + 1);
      wgmma_wait_all();
      fence_regs<BC / 2>(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(L.empty_a(st));
      consumers_sync();
    }
    // park the partial sums: thread (warp w4 of warpgroup wgi, lane) holds
    // rows wgi*64 + 16*w4 + lane/4 (+8), columns 8j + 2(lane%4) (+1)
    float* part = reinterpret_cast<float*>(gbase);
    const int row = wgi * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int col = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      *reinterpret_cast<float2*>(part + row * (BC + PAD) + 8 * j + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(part + (row + 8) * (BC + PAD) + 8 * j +
                                 col) = make_float2(acc[4 * j + 2],
                                                    acc[4 * j + 3]);
    }
  }
  __syncwarp();
  cluster_sync();

  // ---- block q of the cluster sums its share of the rows over the
  // cluster's partials, in rank order, and stores bf16
  const int rows = min(ROWS, p.M - m0);
  const int lo = static_cast<int>((int64_t)rows * q / split);
  const int hi = static_cast<int>((int64_t)rows * (q + 1) / split);
  constexpr int V = BC / 4;
  for (int e = threadIdx.x; e < (hi - lo) * V; e += THREADS) {
    const int row = lo + e / V, col = (e % V) * 4;
    const uint32_t at =
        base + static_cast<uint32_t>(row * (BC + PAD) + col) * 4;
    float4 sum = ld_cluster(at, 0);
    for (uint32_t r = 1; r < split; ++r) {
      const float4 v = ld_cluster(at, r);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
    uint16_t* o = p.out + (int64_t)(m0 + row) * C;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (c0 + col + t < C)
        o[c0 + col + t] = __bfloat16_as_ushort(__float2bfloat16(vals[t]));
  }
  __syncwarp();
  cluster_sync();   // no block leaves while another reads its partials
}

// ---- host side

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// that the libraries need no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// Map of a row-major (rows, cols) matrix in boxes of (box_r, box_c);
// false if the driver refuses it.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int esize,
                     const void* ptr, int rows, int cols, int box_r, int box_c,
                     bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_c),
                             static_cast<cuuint32_t>(box_r)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BC, bool DX, bool SB>
int launch_bc(const Params& p, int split, int smem, cudaStream_t stream) {
  const int R = DX ? p.N : p.K, C = DX ? p.K : p.N;
  CUtensorMap maps[3] = {};
  // raw (w, s) boxes: BR rows of k by BC of n (forward), BC by BR (dx)
  const int box_k = DX ? BC : BR, box_n = DX ? BR : BC;
  if (((p.tma & 1) && !make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                p.a, p.M, R, ROWS, BR, true)) ||
      ((p.tma & 2) && !make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                p.w, p.K, p.N, box_k, box_n, false)) ||
      ((p.tma & 4) &&
       !make_map(&maps[2],
                 SB ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                 SB ? 2 : 4, p.s, p.K, p.N, box_k, box_n, false)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = gated_gemm<BC, DX, SB>;
  static int smem_set[64] = {};   // largest size allowed, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || smem > smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (C + BC - 1) / BC, (p.M + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  Params args = p;
  void* kargs[4] = {&maps[0], &maps[1], &maps[2], &args};
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), kargs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BC, bool DX, bool SB>
int capacity_bc(int split, int smem) {
  const auto kernel = gated_gemm<BC, DX, SB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters * split;
}

// Blocks of a plan's width and cluster size that the card holds at once
// (clusters must fit whole in a GPC, so this can be well under one block
// per SM); a negative cudaError on failure.  s_bf16: the bf16-score build.
template <bool DX>
int capacity(int bc, int split, int smem, int s_bf16) {
  if (split < 1 || split > 8) return -static_cast<int>(cudaErrorInvalidValue);
  switch (bc) {
#define REPRO_WG_CASE(W)                                  \
  case W:                                                 \
    return s_bf16 ? capacity_bc<W, DX, true>(split, smem) \
                  : capacity_bc<W, DX, false>(split, smem);
    REPRO_WG_WIDTHS(REPRO_WG_CASE)
#undef REPRO_WG_CASE
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 body of kernel 1 (DX false) or 2 (DX true) under the plan
// (bc, split, w_stages, smem, tma) of `kernels.masked_matmul.wgmma_plan`;
// s_bf16: the scores are bf16 (f32 otherwise).
template <bool DX>
int launch(const void* a, const void* w, const void* s, void* out, int M,
           int K, int N, uint32_t seed, uint32_t off, uint32_t n_logical,
           int mode, float tau, int s_bf16, int bc, int split, int w_stages,
           int smem, int tma, cudaStream_t stream) {
  if (split < 1 || split > 8 || w_stages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const uint16_t*>(a),
                 static_cast<const uint16_t*>(w),
                 s,
                 static_cast<uint16_t*>(out),
                 M, K, N, seed, off, n_logical, mode, tau,
                 w_stages, tma};
  switch (bc) {
#define REPRO_WG_CASE(W)                                            \
  case W:                                                           \
    return s_bf16 ? launch_bc<W, DX, true>(p, split, smem, stream)  \
                  : launch_bc<W, DX, false>(p, split, smem, stream);
    REPRO_WG_WIDTHS(REPRO_WG_CASE)
#undef REPRO_WG_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wg
}  // namespace repro
