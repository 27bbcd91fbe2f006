// masked_conv1d_ds: the depthwise conv's score (or weight) gradient,
// ds[t, c] = (sum_{b,s} x_pad[b, s + t, c] * g[b, s, c]) * w * sigmoid'(s).
//
// Replaces the Pallas kernel `_conv_ds_kernel` / `masked_conv1d_ds` in
// src/repro/kernels/masked_matmul.py:710.
//
// Epilogue 0 ("ste") multiplies the f32 correlation by
// w * sigmoid(s) * (1 - sigmoid(s)), the straight-through score gradient;
// epilogue 1 ("dw") returns the raw correlation, the weight gradient of the
// plain conv (w and s unread).  x_pad is x with W - 1 leading zeros,
// applied by index.  x: (B, S, C) bf16 or f32; g: (B, S, C) f32 (the
// cotangent of the conv's f32 output); w: (W, C) bf16; s: (W, C) f32 or
// bf16 (`s_bf16`: read as it lies, each score widened to f32 exactly);
// ds: (W, C) in s's type (the reference's `out_shape ... s.dtype`: a bf16
// ds is the f32 value rounded once, to nearest even, at the store), the
// "dw" epilogue's correlation f32.
//
// Bound on this card: the bytes of x and g, read once (6 bytes per
// element with bf16 x), against 2W flops per element; at the main paths'
// (B 2, S 128, C 2304..4096) a launch reads 1.8..3.1 MB, about 1 us at
// 3.35 TB/s: less than a launch costs, so the time is latency: one round
// trip to device memory, the reduction and the launch.
//
// Design: the B*S time rows are cut into chunks of RT rows of one batch
// row, and the chunks are split over the `cluster` blocks of a
// thread-block cluster (rank q takes chunks [q*n/P, (q+1)*n/P)); a block
// owns CB channels, and its threads are `lanes` row lanes of CB/4
// channel quads: lane r takes every lanes-th chunk of its rank's range.
// A thread issues all loads of a chunk at once, 16 bytes each (4
// channels of f32 g and f32 x, 8 bytes of bf16 x), the W - 1 rows of halo
// before the chunk included (zeros by index before the batch row's
// start), and keeps W x 4 partial sums in registers (the kernel is built
// for each W <= MAX_W).  The lanes' sums meet in shared memory, added in
// lane order; then rank 0 adds the cluster's partials in rank order
// through distributed shared memory and applies the epilogue, with w and
// s loaded before the sums.  No atomics: the same bits on every launch.
// The launch plan (cluster, lanes) is `kernels.masked_matmul.conv_ds_plan`.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int QUAD = 4;         // channels a thread owns
constexpr int CB = 64;          // channels a block owns
constexpr int QB = CB / QUAD;   // threads across a block's channels
constexpr int RT = 4;           // time rows of a chunk
constexpr int MAX_LANES = 8;    // row lanes of a block
constexpr int MAX_CLUSTER = 8;  // blocks of a cluster (the portable size)
constexpr int MAX_W = 8;        // taps (a build for each)

struct Params {
  const void* x;
  const float* g;
  const __nv_bfloat16* w;
  const void* s;   // f32, or bf16 bits (s_bf16)
  void* ds;        // f32, or bf16 bits (s_bf16, epilogue 0)
  int B, S, C, epilogue, s_bf16;
  int vec;   // x and g by vectors: C % 4 == 0 and bases on the 16-byte grid
};

// Score i as f32: a bf16 score widened exactly (its bits shifted up), or
// the f32 itself.
__device__ __forceinline__ float score_at(const void* s, int64_t i,
                                          bool bf16) {
  if (bf16)
    return __uint_as_float(
        static_cast<uint32_t>(__ldg(static_cast<const unsigned short*>(s) + i))
        << 16);
  return __ldg(static_cast<const float*>(s) + i);
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

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// f32x4 at the same shared address in cluster block `rank`.
__device__ __forceinline__ float4 ld_cluster(const float4* local,
                                             uint32_t rank) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// 4 channels c.. of row `row` (a flat (b, s) index) as f32: one vector
// load, or element loads (zero past C).
__device__ __forceinline__ float4 load4(const float* a, int64_t row, int c,
                                        int C, bool vec) {
  const float* p = a + row * C + c;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = c + j < C ? __ldg(p + j) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* a, int64_t row,
                                        int c, int C, bool vec) {
  const __nv_bfloat16* p = a + row * C + c;
  if (vec) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xFFFF0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xFFFF0000u));
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = c + j < C ? __bfloat162float(p[j]) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void fma4(float4& acc, const float4& a,
                                     const float4& b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4& a) {
  acc.x += a.x;
  acc.y += a.y;
  acc.z += a.z;
  acc.w += a.w;
}

// W taps: the registers hold no more x slots and sums than W needs, so
// that five blocks fit an SM and a launch's clusters one wave.
template <typename T, int W>
__global__ void __launch_bounds__(QB * MAX_LANES, 5)
masked_conv1d_ds_kernel(const Params p) {
  __shared__ float4 part[MAX_LANES][W][QB];   // the lanes' sums
  __shared__ float4 red[W][QB];               // the block's, for rank 0
  const int quad = threadIdx.x % QB, lane = threadIdx.x / QB;
  const int lanes = blockDim.x / QB;
  const int q = cluster_rank(), P = cluster_size();
  const int c = blockIdx.y * CB + quad * QUAD;
  const int per_row = (p.S + RT - 1) / RT;        // chunks of a batch row
  const int n = p.B * per_row;
  const int lo = n * q / P, hi = n * (q + 1) / P;
  const T* x = static_cast<const T*>(p.x);
  const bool vec = p.vec;

  // rank 0's epilogue operands of its first output (tap o / QB, quad
  // o % QB, o = threadIdx.x), loaded before the sums so that their round
  // trip to device memory overlaps that of x and g
  float wv[QUAD] = {}, sv[QUAD] = {};
  const int o0 = threadIdx.x, c00 = blockIdx.y * CB + (o0 % QB) * QUAD;
  if (q == 0 && p.epilogue == 0 && o0 < W * QB)
#pragma unroll
    for (int j = 0; j < QUAD; ++j)
      if (c00 + j < p.C) {
        const int64_t at = (int64_t)(o0 / QB) * p.C + c00 + j;
        wv[j] = __bfloat162float(p.w[at]);
        sv[j] = score_at(p.s, at, p.s_bf16);
      }

  float4 acc[W];
#pragma unroll
  for (int t = 0; t < W; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < p.C) {
    for (int k = lo + lane; k < hi; k += lanes) {
      const int b = k / per_row, s0 = (k % per_row) * RT;
      const int64_t row0 = (int64_t)b * p.S;
      // x rows s0 - (W - 1) .. s0 + RT - 1 (slot i: row s0 - (W-1) + i)
      // and g rows s0 .. s0 + RT - 1, all loads in flight together
      float4 xv[RT + W - 1], gv[RT];
#pragma unroll
      for (int i = 0; i < RT + W - 1; ++i) {
        const int sx = s0 - (W - 1) + i;
        xv[i] = (sx >= 0 && sx < p.S)
                    ? load4(x, row0 + sx, c, p.C, vec)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
        gv[i] = s0 + i < p.S ? load4(p.g, row0 + s0 + i, c, p.C, vec)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      // tap t of row s0 + i reads x_pad[s0 + i + t] = slot i + t
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int t = 0; t < W; ++t) fma4(acc[t], xv[i + t], gv[i]);
    }
  }
#pragma unroll
  for (int t = 0; t < W; ++t) part[lane][t][quad] = acc[t];
  __syncthreads();
  for (int o = threadIdx.x; o < W * QB; o += blockDim.x) {
    const int t = o / QB, qd = o % QB;
    float4 sum = part[0][t][qd];
    for (int r = 1; r < lanes; ++r) add4(sum, part[r][t][qd]);
    red[t][qd] = sum;
  }
  cluster_sync();   // every rank's partials are in its shared memory
  if (q == 0) {
    for (int o = threadIdx.x; o < W * QB; o += blockDim.x) {
      const int t = o / QB, qd = o % QB;
      float4 sum = red[t][qd];
      for (int r = 1; r < P; ++r) add4(sum, ld_cluster(&red[t][qd], r));
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
      const int c0 = blockIdx.y * CB + qd * QUAD;
#pragma unroll
      for (int j = 0; j < QUAD; ++j) {
        if (c0 + j >= p.C) break;
        const int64_t at = (int64_t)t * p.C + c0 + j;
        float d = v[j];
        if (p.epilogue == 0) {
          const bool pre = o == o0;
          const float sig =
              repro::sigmoid(pre ? sv[j] : score_at(p.s, at, p.s_bf16));
          d = d * (pre ? wv[j] : __bfloat162float(p.w[at])) * sig *
              (1.0f - sig);
        }
        if (p.epilogue == 0 && p.s_bf16)
          static_cast<__nv_bfloat16*>(p.ds)[at] = __float2bfloat16_rn(d);
        else
          static_cast<float*>(p.ds)[at] = d;
      }
    }
  }
  cluster_sync();   // no block leaves while rank 0 reads its partials
}

}  // namespace

// s_bf16: s and (epilogue 0) ds are bf16 (f32 otherwise); cluster, lanes:
// the launch plan (kernels.masked_matmul.conv_ds_plan); vec: x and g go by
// vectors (the wrapper's 16-byte-grid flag).
extern "C" int masked_conv1d_ds(const void* x, const void* g, const void* w,
                                const void* s, void* ds, int B, int S, int C,
                                int W, int epilogue, int x_f32, int s_bf16,
                                int cluster, int lanes, int vec,
                                void* stream) {
  if (W < 1 || W > MAX_W || cluster < 1 || cluster > MAX_CLUSTER ||
      lanes < 1 || lanes > MAX_LANES || (vec && C % QUAD))
    return (int)cudaErrorInvalidValue;
  const Params p{x, (const float*)g, (const __nv_bfloat16*)w, s, ds,
                 B, S, C, epilogue, s_bf16, vec};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (C + CB - 1) / CB);
  cfg.blockDim = dim3(QB * lanes);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (W) {
#define REPRO_CONV_W(N)                                                     \
  case N:                                                                   \
    err = x_f32 ? cudaLaunchKernelEx(&cfg,                                  \
                                     masked_conv1d_ds_kernel<float, N>, p)  \
                : cudaLaunchKernelEx(                                       \
                      &cfg, masked_conv1d_ds_kernel<__nv_bfloat16, N>, p);  \
    break;
    REPRO_CONV_W(1) REPRO_CONV_W(2) REPRO_CONV_W(3) REPRO_CONV_W(4)
    REPRO_CONV_W(5) REPRO_CONV_W(6) REPRO_CONV_W(7) REPRO_CONV_W(8)
#undef REPRO_CONV_W
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
