// masked_conv1d: depthwise causal conv through the masked (W, C) kernel
// leaf, y[b, s, c] = sum_t x_pad[b, s + t, c] * (m * w)[t, c], f32 output.
//
// Replaces the Pallas kernel `_conv_kernel` / `masked_conv1d` in
// src/repro/kernels/masked_matmul.py:621,649.
//
// m = 1[hash_u(seed, off + t*n_logical + c) < sigmoid(s[t, c])] (mode 0),
// 1[sigmoid(s[t, c]) > tau] (mode 1), or no mask at all (mode 2, "plain":
// pre-materialized weights, s unread).  x_pad is x with W - 1 leading zeros
// on the time axis (the causal forward); with `flip` the taps run reversed
// (row W-1-t at shift t) over W - 1 trailing zeros, which is dL/dx of the
// causal conv with the same regenerated mask.  The padding is applied by
// index: no padded copy exists in memory.  x: (B, S, C) bf16 (the forward,
// whose input is the bf16 output of a masked projection) or f32 (the
// flipped pass over the f32 cotangent); w: (W, C) bf16; s: (W, C) f32 or
// bf16 (`s_bf16`: read as it lies, each score widened to f32 exactly
// before the gating, as the reference's kernel upcasts it; no f32 copy).
//
// The taps accumulate in t order with separately rounded products and
// sums (__fmul_rn / __fadd_rn, no FMA contraction): the plain PyTorch
// version's arithmetic, so kernel and plain version agree bit for bit.
//
// Bound on this card: the bytes of x (read) and y (written), ~6 (bf16 x)
// or 8 (f32 x) bytes per output against 2W flops per output; at the main
// paths' (B 2, S 128, C 2304..4096) a launch moves 1.8..3.1 MB, about
// 1 us at 3.35 TB/s: less than a launch costs, so the time is latency:
// the launch, one round trip to device memory and the stores.
//
// Design: the B*S time rows are cut into chunks of RT rows of one batch
// row; a block owns CB channels and `lanes` consecutive chunks, one a
// row lane of CB/4 threads, each thread 4 neighbouring channels ("a
// quad") of its chunk's RT rows.  A thread first issues all of its
// RT + W - 1 input-row loads (the W - 1 rows of halo included, zeros by
// index outside the batch row), 8 bytes (bf16 x) or 16 bytes (f32 g)
// each; then the block gates its W x CB taps once into shared memory,
// row lane r the tap rows r, r + lanes, ... of its 4 channels (their s
// and w loads issued together), so that the hash and the sigmoid run
// while the x loads are in flight; one barrier, and each output quad is
// W products and sums in registers and one 16-byte store.  At the main
// paths' shapes every thread takes one chunk, so that all of a launch's
// loads are in flight at once (144 or 256 blocks of 256 threads, one
// wave).
// The kernel is built for each W <= MAX_W, so that its x slots and taps
// stay in registers.  Vector loads and stores where C % 4 == 0 and x and
// y lie on the 16-byte grid (`vec`); element by element otherwise, in
// the same kernel.  The launch plan (lanes) is
// `kernels.masked_matmul.conv_plan`.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int QUAD = 4;         // channels a thread owns
constexpr int CB = 128;         // channels a block owns
constexpr int QB = CB / QUAD;   // threads across a block's channels
constexpr int RT = 4;           // time rows of a chunk
constexpr int MAX_LANES = 8;    // row lanes (chunks) of a block
constexpr int MAX_W = 8;        // taps (a build for each)

struct Params {
  const void* x;
  const __nv_bfloat16* w;
  const void* s;   // f32, or bf16 bits (s_bf16)
  float* y;
  int B, S, C;
  uint32_t seed, off, n_logical;
  int mode;
  float tau;
  int flip;
  int s_bf16;
  int vec;   // x and y by vectors: C % 4 == 0 and bases on the 16-byte grid
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

__device__ __forceinline__ float4 mul4(const float4& a, const float4& b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

template <typename T, int W>
__global__ void __launch_bounds__(QB * MAX_LANES)
masked_conv1d_kernel(const Params p) {
  // tap[t][c]: the gated weight applied at shift t (row W-1-t flipped)
  __shared__ __align__(16) float tap[W][CB];
  const int quad = threadIdx.x % QB, lane = threadIdx.x / QB;
  const int lanes = blockDim.x / QB;
  const int c = blockIdx.y * CB + quad * QUAD;
  const int per_row = (p.S + RT - 1) / RT;         // chunks of a batch row
  const int k = blockIdx.x * lanes + lane;
  const bool live = k < p.B * per_row && c < p.C;
  const int b = live ? k / per_row : 0, s0 = live ? (k % per_row) * RT : 0;
  const int64_t row0 = (int64_t)b * p.S;
  const T* x = static_cast<const T*>(p.x);
  const bool vec = p.vec;

  // x_pad rows s0 .. s0 + RT - 1 + W - 1 of the chunk: slot i is x row
  // s0 - (W - 1) + i causally, s0 + i flipped; all loads in flight
  // before the gating
  const int base = p.flip ? s0 : s0 - (W - 1);
  float4 xv[RT + W - 1];
#pragma unroll
  for (int i = 0; i < RT + W - 1; ++i) {
    const int sx = base + i;
    xv[i] = live && sx >= 0 && sx < p.S ? load4(x, row0 + sx, c, p.C, vec)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // the block's W x CB taps, each gated once: lane r gates tap rows r,
  // r + lanes, ... of its quad's 4 channels, their s and w loaded before
  // any is gated
  const uint32_t smix = repro::seed_mix(p.seed);
  for (int t = lane; t < W; t += lanes) {   // uniform across the warp
    const int row = p.flip ? W - 1 - t : t;
    const int64_t at = (int64_t)row * p.C + c;
    float sv[QUAD], wv[QUAD], g[QUAD];
#pragma unroll
    for (int j = 0; j < QUAD; ++j) {
      const bool in = c + j < p.C;
      wv[j] = in ? __bfloat162float(p.w[at + j]) : 0.0f;
      sv[j] = in && p.mode != 2 ? score_at(p.s, at + j, p.s_bf16) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < QUAD; ++j)
      g[j] = p.mode == 2 ||
                     repro::mask_bit(sv[j],
                                     p.off + (uint32_t)row * p.n_logical +
                                         (uint32_t)(c + j),
                                     smix, p.mode, p.tau)
                 ? wv[j]
                 : 0.0f;
    *reinterpret_cast<float4*>(&tap[t][quad * QUAD]) =
        make_float4(g[0], g[1], g[2], g[3]);
  }
  __syncthreads();
  if (!live) return;

  float4 tv[W];
#pragma unroll
  for (int t = 0; t < W; ++t)
    tv[t] = *reinterpret_cast<const float4*>(&tap[t][quad * QUAD]);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (s0 + i >= p.S) break;
    // output row s0 + i, tap t: x_pad slot i + t
    float4 acc = mul4(xv[i], tv[0]);
#pragma unroll
    for (int t = 1; t < W; ++t) acc = add4(acc, mul4(xv[i + t], tv[t]));
    float* out = p.y + (row0 + s0 + i) * p.C + c;
    if (vec) {
      *reinterpret_cast<float4*>(out) = acc;
    } else {
      const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int j = 0; j < QUAD; ++j)
        if (c + j < p.C) out[j] = a[j];
    }
  }
}

}  // namespace

// s_bf16: the scores are bf16 (f32 otherwise); lanes: the launch plan
// (kernels.masked_matmul.conv_plan); vec: x and y go by vectors (the
// wrapper's 16-byte-grid flag).
extern "C" int masked_conv1d(const void* x, const void* w, const void* s,
                             void* y, int B, int S, int C, int W,
                             uint32_t seed, uint32_t off, uint32_t n_logical,
                             int mode, float tau, int flip, int x_f32,
                             int s_bf16, int lanes, int vec, void* stream) {
  if (W < 1 || W > MAX_W || lanes < 1 || lanes > MAX_LANES ||
      (vec && C % QUAD))
    return (int)cudaErrorInvalidValue;
  const Params p{x, (const __nv_bfloat16*)w, s, (float*)y,
                 B, S, C, seed, off, n_logical, mode, tau, flip, s_bf16, vec};
  const int chunks = B * ((S + RT - 1) / RT);
  const dim3 grid((chunks + lanes - 1) / lanes, (C + CB - 1) / CB);
  const dim3 block(QB * lanes);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
#define REPRO_CONV_W(N)                                                     \
  case N:                                                                   \
    if (x_f32)                                                              \
      masked_conv1d_kernel<float, N><<<grid, block, 0, st>>>(p);            \
    else                                                                    \
      masked_conv1d_kernel<__nv_bfloat16, N><<<grid, block, 0, st>>>(p);    \
    break;
    REPRO_CONV_W(1) REPRO_CONV_W(2) REPRO_CONV_W(3) REPRO_CONV_W(4)
    REPRO_CONV_W(5) REPRO_CONV_W(6) REPRO_CONV_W(7) REPRO_CONV_W(8)
#undef REPRO_CONV_W
  }
  return (int)cudaGetLastError();
}
