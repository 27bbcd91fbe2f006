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
// The scores are f32 or bf16 (`s_bf16`); a bf16 score is widened to f32
// exactly (its bits shifted up) before the gating, so its bit is the bit
// of its f32 upcast, as the reference's kernel upcasts it.
//
// Bound on this card: the bytes of the scores (4 per element, 2 in bf16)
// read once; the words written are 1/32 (1/16) of that.  Beside the stream, the exact
// gating (`repro::mask_bit`: the hash, the accurate expf and the IEEE
// division, ~43 instructions an element) issues longer than the bytes
// take: on one internlm2-1.8b round (C = 2, 3.0 G scores; bound 3.72 ms)
// the gating alone took 6.8 ms against the stream's 4.3 (`python -m
// repro_torch.kernels.probe_sap`, NVIDIA H100 80GB HBM3, 700 W).  With
// the filter below the gating alone takes 4.6 ms, the kernel 4.8.
//
// Design: a persistent grid (a few blocks an SM, `grid`) whose warps
// stride over the (row, piece) space, stepping row and piece without a
// division; a piece is `unroll` chunks of 32 V elements (vector path; V
// = 4 f32 or 8 bf16 scores in 16 bytes) or `unroll` words of 32 (scalar
// path), and a warp issues all loads of its piece before it gates any
// element, so that unroll x 512 (or 128 / 64) bytes a warp are in flight.
//  - vector path (`vec`: n % V == 0 and the base on the 16-byte grid, so
//    that every row starts on it): lane l loads elements Vl..Vl+V-1 of a
//    32 V-element chunk as one 16-byte vector and forms their V bits at
//    bits V(l % (32/V)) of word l / (32/V); an OR across each group of
//    32/V lanes (__shfl_xor_sync) gives the chunk's V words, which every
//    (32/V)-th lane stores (16 or 32 contiguous bytes).
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
  const void* s;        // (C, n) f32, or bf16 bits
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

// A score as f32: bf16 bits widened exactly.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// `bits` with bit `at` set to the bit of the score at q, element idx of
// its row: by its margin's sign, or by the exact repro::mask_bit where
// the margin lies within EPS (or is NaN); out of line, so that the rare
// call keeps the gating's loop short.
template <int MODE, typename T>
__device__ __noinline__ uint32_t settle(const T* q, uint32_t idx,
                                        uint32_t smix, float tau, int at,
                                        uint32_t bits) {
  const float s = widen(__ldg(q));
  const float d = margin<MODE>(s, idx, smix, tau);
  const bool m = fabsf(d) > EPS ? d < 0.0f
                                : repro::mask_bit(s, idx, smix, MODE, tau);
  return (bits & ~(1u << at)) | (uint32_t)m << at;
}

// The V = 16 / sizeof(T) scores of a 16-byte vector at q, as f32.
__device__ __forceinline__ void load_vec(const float* q, float* v) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(q));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const uint16_t* q, float* v) {
  const uint4 a = __ldcs(reinterpret_cast<const uint4*>(q));
  const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    v[2 * t] = __uint_as_float(u[t] << 16);
    v[2 * t + 1] = __uint_as_float(u[t] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ float load_one(const float* q) {
  return __ldcs(q);
}
__device__ __forceinline__ float load_one(const uint16_t* q) {
  return widen(__ldcs(reinterpret_cast<const unsigned short*>(q)));
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

template <int U, int MODE, typename T>
__global__ void __launch_bounds__(THREADS, PER_SM)
sample_and_pack_vec(const Params p) {
  constexpr int V = 16 / sizeof(T);   // scores a 16-byte vector holds
  constexpr int LANES = 32 / V;       // lanes whose bits make one word
  constexpr int64_t CHUNK = 32 * V, PIECE = CHUNK * U;
  static_assert(U * V <= 32, "a thread's bits fit one word");
  const int lane = threadIdx.x % 32;
  Walk w((p.n + PIECE - 1) / PIECE);
  for (; w.c < p.C; w.next()) {   // uniform across the warp
    const int64_t c = w.c;
    const int64_t e0 = w.piece * PIECE + V * lane;
    const T* row = static_cast<const T*>(p.s) + c * p.n;
    float v[U][V];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (e0 + CHUNK * j < p.n) {
        load_vec(row + e0 + CHUNK * j, v[j]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[j][i] = 0.0f;
      }
    }
    const uint32_t smix = repro::seed_mix(p.seeds[c]);
    // bit V j + i: element e0 + CHUNK j + i; a vector at or past n is
    // whole (n % V == 0), and its bits stay zero
    Filter f;
    uint32_t live = 0;
#pragma unroll
    for (int j = U - 1; j >= 0; --j) {
      const uint32_t e = (uint32_t)(e0 + CHUNK * j);
#pragma unroll
      for (int i = V - 1; i >= 0; --i)
        f.add(margin<MODE>(v[j][i], e + (uint32_t)i, smix, p.tau));
      live |= (e0 + CHUNK * j < p.n ? (1u << V) - 1u : 0u) << V * j;
    }
    uint32_t bits = f.bits & live;
    if (!f.sure())   // rare: an element within the band
      for (int at = 0; at < V * U; ++at)
        if (live >> at & 1u) {
          const int64_t e = e0 + CHUNK * (at / V) + at % V;
          bits = settle<MODE>(row + e, (uint32_t)e, smix, p.tau, at, bits);
        }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t e = e0 + CHUNK * j;
      uint32_t word = ((bits >> V * j) & ((1u << V) - 1u)) << (V * (lane % LANES));
#pragma unroll
      for (int x = 1; x < LANES; x *= 2) word |= __shfl_xor_sync(FULL, word, x);
      const int64_t k = e / 32;   // lane / LANES's word of chunk j
      if (lane % LANES == 0 && k < p.nw) p.words[c * p.nw + k] = word;
    }
  }
}

template <int U, int MODE, typename T>
__global__ void __launch_bounds__(THREADS, PER_SM)
sample_and_pack_scalar(const Params p) {
  const int lane = threadIdx.x % 32;
  Walk w((p.nw + U - 1) / U);
  for (; w.c < p.C; w.next()) {   // uniform across the warp
    const int64_t c = w.c;
    const int64_t k0 = w.piece * U;
    const T* row = static_cast<const T*>(p.s) + c * p.n;
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

// s_bf16: the scores are bf16 (f32 otherwise); vec, unroll, grid: the
// launch plan (kernels.masked_matmul.sap_plan); vec also needs the
// scores' base on the 16-byte grid (the wrapper's flag).  unroll is 1, 2,
// 4 or 8 (at most 4 on the vector path of bf16 scores, whose 8 bits a
// vector fill a thread's word at 4).
extern "C" int sample_and_pack(const void* s, const void* seeds, void* words,
                               int C, int64_t n, int mode, float tau,
                               int s_bf16, int vec, int unroll, int grid,
                               void* stream) {
  if (grid < 1 || (vec && n % 4) || (vec && s_bf16 && (n % 8 || unroll > 4)))
    return (int)cudaErrorInvalidValue;
  const Params p{s, (const uint32_t*)seeds, (uint32_t*)words,
                 n, (n + 31) / 32, C, tau};
  const cudaStream_t st = (cudaStream_t)stream;
#define REPRO_SAP_LAUNCH(KIND, U, T)                                    \
  do {                                                                  \
    if (mode == 1)                                                      \
      sample_and_pack_##KIND<U, 1, T><<<grid, THREADS, 0, st>>>(p);     \
    else                                                                \
      sample_and_pack_##KIND<U, 0, T><<<grid, THREADS, 0, st>>>(p);     \
  } while (0)
  switch (unroll) {
#define REPRO_SAP_U(U)                                      \
  case U:                                                   \
    if (vec && s_bf16)                                      \
      REPRO_SAP_LAUNCH(vec, (U > 4 ? 4 : U), uint16_t);     \
    else if (vec)                                           \
      REPRO_SAP_LAUNCH(vec, U, float);                      \
    else if (s_bf16)                                        \
      REPRO_SAP_LAUNCH(scalar, U, uint16_t);                \
    else                                                    \
      REPRO_SAP_LAUNCH(scalar, U, float);                   \
    break;
    // (the bf16 vector path's unroll 8, refused above, builds as 4)
    REPRO_SAP_U(1) REPRO_SAP_U(2) REPRO_SAP_U(4) REPRO_SAP_U(8)
#undef REPRO_SAP_U
#undef REPRO_SAP_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
