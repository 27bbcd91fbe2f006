// sample_and_pack: (C, n) scores -> (C, ceil(n/32)) packed mask words.
//
// Replaces the Pallas kernel `_sap_kernel` / `sample_and_pack` in
// src/repro/kernels/masked_matmul.py:333,356.
//
// Row c's bit i is m = 1[hash_u(seeds[c], i) < sigmoid(s[c, i])] (mode 0)
// or 1[sigmoid(s[c, i]) > tau] (mode 1); bit j of word k carries element
// 32k + j (little-endian), and bits at or past n are zero, as the
// reference's pad-then-pack produces.
//
// Bound on this card: the bytes of the scores (4 per element) read once;
// the words written are 1/32 of that.  Beside the stream, the exact
// gating (`repro::mask_bit`: the hash, the accurate expf and the IEEE
// division, ~43 instructions an element) issues longer than the bytes
// take: on one internlm2-1.8b round (C = 2, 3.0 G scores; bound 3.72 ms)
// the gating alone took 6.8 ms against the stream's 4.3 (`python -m
// repro_torch.kernels.probe_sap`, NVIDIA H100 80GB HBM3, 700 W).  With
// the filter below the gating alone takes 4.6 ms, the kernel 4.8.
//
// Design: a persistent grid (a few blocks an SM, `grid`) whose warps
// stride over the (row, piece) space, stepping row and piece without a
// division; a piece is `unroll` chunks of 128 elements (vector path) or
// `unroll` words of 32 (scalar path), and a warp issues all loads of its
// piece before it gates any element, so that unroll x 512 (or 128)
// bytes a warp are in flight.
//  - vector path (`vec`: n % 4 == 0 and the base on the 16-byte grid, so
//    that every row starts on it): lane l loads elements 4l..4l+3 of a
//    128-element chunk as one 16-byte vector and forms their 4-bit
//    nibble at bits 4(l % 8) of word l / 8; an OR across each group of 8
//    lanes (three __shfl_xor_sync) gives the chunk's 4 words, which
//    lanes 0, 8, 16 and 24 store (16 contiguous bytes).
//  - scalar path (the rest): lane l loads element 32k + l of word k, and
//    __ballot_sync gathers the warp's bits into the word, which lane 0
//    stores.
// The gating is a filter with the exact bits, without a branch an
// element.  Each element's margin d = sig~ - u (mode 0) or sig~ - tau
// (mode 1), with the sigmoid from the intrinsics, sig~ = __fdividef(1,
// 1 + __expf(-s)), gives the bit by its sign wherever |d| > EPS (the
// kernel keeps -d, whose sign bit is the mask bit, and gathers the sign
// bits by funnel shifts); a thread keeps, beside the bits, only the
// least |d| of its elements and their sum (NaN if any d is), and where
// that least |d| is within EPS or the sum is NaN (about 2 EPS of the
// elements: 2.2e-5 of a round's in mode "sample", 3.2e-5 in
// "threshold", by probe_sap; a thread's 16 elements then ~3.5e-4 of
// its pieces) a rare out-of-line pass re-derives those elements'
// margins and asks the exact repro::mask_bit for the ones in the band.
// EPS bounds |sig~ - sig|, sig being mask_bit's sigmoid, with a margin,
// for every finite s.  By the CUDA C Programming Guide's
// error bounds, __expf(x) is within 2 + floor(1.173 |x|) ulp of e^x and
// expf within 2 ulp, 1 + e is rounded once in both, __fdividef is
// within 2 ulp and the IEEE division within 0.5; a relative error r of
// e = e^-s moves 1 / (1 + e) by at most r e / (1 + e)^2 <= r e^-|s|,
// and (2 + 1.173 |s|) e^-|s| <= 2, so |sig~ - sig| <= 2 * 2^-23 +
// 2^-22 + 2^-24 (sig~) + 2 * 2^-23 * 2^-2 + 2^-23 (sig) < 9e-7 <
// EPS = 1e-5; where e overflows or underflows both sigmoids are 0 or 1
// within 2^-126.  So if d > EPS then sig - u > 0 and the bit is 1, and
// if d < -EPS it is 0; likewise with tau.  u is exact (hash_uniform).
// Element offsets are int64: a row of a layer-stacked leaf holds up to
// 24 * 2048 * 8192 = 402,653,184 scores, 1.6 GB.  The launch plan
// (vec, unroll, grid) is `kernels.masked_matmul.sap_plan`.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_SM = 4;   // blocks an SM, all resident: <= 64 registers
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* s;
  const uint32_t* seeds;
  uint32_t* words;
  int64_t n, nw;   // elements and words of a row
  int C;
  float tau;
};

constexpr float EPS = 1.0e-5f;    // > |sig~ - sig| (see above)

// The filter's negated margin of a score, u - sig~ (mode 0) or
// tau - sig~ (mode 1): its bit is 1 where this is < -EPS, 0 where it is
// > EPS, so that within the filter the bit is its sign bit.
template <int MODE>
__device__ __forceinline__ float margin(float s, uint32_t idx, uint32_t smix,
                                        float tau) {
  const float sig = __fdividef(1.0f, 1.0f + __expf(-s));
  return (MODE == 1 ? tau : repro::hash_uniform(idx, smix)) - sig;
}

// A thread's bits and the least |margin| of its elements, NaN if any
// margin is (a NaN score's).
struct Filter {
  uint32_t bits = 0;
  float least = 2.0f, sum = 0.0f;   // |margin| <= 1 + 2^-22
  // Elements are added last bit first: each shifts the bits up by one
  // and brings its margin's sign bit in at bit 0.
  __device__ void add(float d) {
    bits = __funnelshift_l(__float_as_uint(d), bits, 1);
    least = fminf(least, fabsf(d));
    sum += d;   // NaN if any margin is: fminf passes NaN by
  }
  __device__ bool sure() const { return least > EPS && sum == sum; }
};

// `bits` with bit `at` set to the bit of the score at q, element idx of
// its row: by its margin's sign, or by the exact repro::mask_bit where
// the margin lies within EPS (or is NaN); out of line, so that the rare
// call keeps the gating's loop short.
template <int MODE>
__device__ __noinline__ uint32_t settle(const float* q, uint32_t idx,
                                        uint32_t smix, float tau, int at,
                                        uint32_t bits) {
  const float s = __ldg(q);
  const float d = margin<MODE>(s, idx, smix, tau);
  const bool m = fabsf(d) > EPS ? d < 0.0f
                                : repro::mask_bit(s, idx, smix, MODE, tau);
  return (bits & ~(1u << at)) | (uint32_t)m << at;
}

__device__ __forceinline__ float4 load_vec(const float* q) {
  return __ldcs(reinterpret_cast<const float4*>(q));
}

__device__ __forceinline__ float load_one(const float* q) {
  return __ldcs(q);
}

// A warp's grid-stride walk over the C x per_row pieces: piece q = c *
// per_row + piece, from q = its warp index by steps of the grid's warps,
// row and piece advanced without a division.
struct Walk {
  int64_t per_row, c, piece, step_c, step_piece;
  __device__ explicit Walk(int64_t per_row_) : per_row(per_row_) {
    const int64_t q = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
    const int64_t warps = (int64_t)gridDim.x * (THREADS / 32);
    c = q / per_row;
    piece = q - c * per_row;
    step_c = warps / per_row;
    step_piece = warps - step_c * per_row;
  }
  __device__ void next() {
    c += step_c;
    piece += step_piece;
    if (piece >= per_row) {
      piece -= per_row;
      ++c;
    }
  }
};

template <int U, int MODE>
__global__ void __launch_bounds__(THREADS, PER_SM)
sample_and_pack_vec(const Params p) {
  constexpr int64_t PIECE = 128 * U;
  const int lane = threadIdx.x % 32;
  Walk w((p.n + PIECE - 1) / PIECE);
  for (; w.c < p.C; w.next()) {   // uniform across the warp
    const int64_t c = w.c;
    const int64_t e0 = w.piece * PIECE + 4 * lane;
    const float* row = p.s + c * p.n;
    float4 v[U];
#pragma unroll
    for (int j = 0; j < U; ++j)
      v[j] = e0 + 128 * j < p.n ? load_vec(row + e0 + 128 * j)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    const uint32_t smix = repro::seed_mix(p.seeds[c]);
    // bit 4j + i: element e0 + 128 j + i (U <= 8: 32 bits); a vector at
    // or past n is whole (n % 4 == 0), and its bits stay zero
    Filter f;
    uint32_t live = 0;
#pragma unroll
    for (int j = U - 1; j >= 0; --j) {
      const uint32_t e = (uint32_t)(e0 + 128 * j);
      f.add(margin<MODE>(v[j].w, e + 3u, smix, p.tau));
      f.add(margin<MODE>(v[j].z, e + 2u, smix, p.tau));
      f.add(margin<MODE>(v[j].y, e + 1u, smix, p.tau));
      f.add(margin<MODE>(v[j].x, e, smix, p.tau));
      live |= (e0 + 128 * j < p.n ? 0xFu : 0u) << 4 * j;
    }
    uint32_t bits = f.bits & live;
    if (!f.sure())   // rare: an element within the band
      for (int at = 0; at < 4 * U; ++at)
        if (live >> at & 1u) {
          const int64_t e = e0 + 128 * (at / 4) + at % 4;
          bits = settle<MODE>(row + e, (uint32_t)e, smix, p.tau, at, bits);
        }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t e = e0 + 128 * j;
      uint32_t word = ((bits >> 4 * j) & 0xFu) << (4 * (lane % 8));
      word |= __shfl_xor_sync(FULL, word, 1);
      word |= __shfl_xor_sync(FULL, word, 2);
      word |= __shfl_xor_sync(FULL, word, 4);
      const int64_t k = e / 32;   // lane / 8's word of chunk j
      if (lane % 8 == 0 && k < p.nw) p.words[c * p.nw + k] = word;
    }
  }
}

template <int U, int MODE>
__global__ void __launch_bounds__(THREADS, PER_SM)
sample_and_pack_scalar(const Params p) {
  const int lane = threadIdx.x % 32;
  Walk w((p.nw + U - 1) / U);
  for (; w.c < p.C; w.next()) {   // uniform across the warp
    const int64_t c = w.c;
    const int64_t k0 = w.piece * U;
    const float* row = p.s + c * p.n;
    float v[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t i = (k0 + j) * 32 + lane;
      v[j] = i < p.n ? load_one(row + i) : 0.0f;
    }
    const uint32_t smix = repro::seed_mix(p.seeds[c]);
    // bit j: element (k0 + j) * 32 + lane
    Filter f;
    uint32_t live = 0;
#pragma unroll
    for (int j = U - 1; j >= 0; --j) {
      const int64_t i = (k0 + j) * 32 + lane;
      f.add(margin<MODE>(v[j], (uint32_t)i, smix, p.tau));
      live |= (uint32_t)(i < p.n) << j;
    }
    uint32_t bits = f.bits & live;
    if (!f.sure())   // rare: an element within the band
      for (int at = 0; at < U; ++at)
        if (live >> at & 1u) {
          const int64_t i = (k0 + at) * 32 + lane;
          bits = settle<MODE>(row + i, (uint32_t)i, smix, p.tau, at, bits);
        }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const uint32_t word = __ballot_sync(FULL, (bits >> j) & 1u);
      if (lane == 0 && k0 + j < p.nw) p.words[c * p.nw + k0 + j] = word;
    }
  }
}

}  // namespace

// vec, unroll, grid: the launch plan (kernels.masked_matmul.sap_plan);
// vec also needs the scores' base on the 16-byte grid (the wrapper's
// flag).  unroll is 1, 2, 4 or 8.
extern "C" int sample_and_pack(const void* s, const void* seeds, void* words,
                               int C, int64_t n, int mode, float tau,
                               int vec, int unroll, int grid, void* stream) {
  if (grid < 1 || (vec && n % 4)) return (int)cudaErrorInvalidValue;
  const Params p{(const float*)s, (const uint32_t*)seeds, (uint32_t*)words,
                 n, (n + 31) / 32, C, tau};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (unroll) {
#define REPRO_SAP_U(U)                                                      \
  case U:                                                                   \
    if (vec && mode == 1)                                                   \
      sample_and_pack_vec<U, 1><<<grid, THREADS, 0, st>>>(p);               \
    else if (vec)                                                           \
      sample_and_pack_vec<U, 0><<<grid, THREADS, 0, st>>>(p);               \
    else if (mode == 1)                                                     \
      sample_and_pack_scalar<U, 1><<<grid, THREADS, 0, st>>>(p);            \
    else                                                                    \
      sample_and_pack_scalar<U, 0><<<grid, THREADS, 0, st>>>(p);            \
    break;
    REPRO_SAP_U(1) REPRO_SAP_U(2) REPRO_SAP_U(4) REPRO_SAP_U(8)
#undef REPRO_SAP_U
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
