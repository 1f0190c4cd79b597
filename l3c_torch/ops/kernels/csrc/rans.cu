// rANS32 encode and decode for the v8 codec, with the exact-integer coding
// CDF evaluated inside the kernels (int_cdf.cuh).
//
// Replaces, per kernel, one JAX program of the TPU package: the rANS
// lax.scan plus the CDF evaluation that l3c_tpu/codec/bitcoding2.py fuses
// into the same program:
//   rans_encode  <- l3c_tpu/ops/tpu_coder.py:305 rans_encode (+
//                   _divmod_by_freq :250, _compact_left :375), with the
//                   2-edge lookups of bitcoding2.py:320 enc_bn_unit and
//                   :417 enc_rgb_units (int_coder bn_lookup,
//                   rgb_coarse_lookup, rgb_fine_lookup; the uniform row)
//   rans_decode  <- l3c_tpu/ops/tpu_coder.py:481 rans_decode (+
//                   _decode_symbol :418, the word window :453), with the
//                   row builds of bitcoding2.py:344 dec_bn_unit and :361
//                   dec_rgb_channel (int_coder bn_rows, rgb_coarse_rows,
//                   rgb_fine_rows; the uniform row)
// The plain PyTorch versions are the int_coder rows/lookups followed by
// rans_encode_plain / rans_decode_plain (l3c_torch/ops/gpu_coder.py).
//
// Inputs are the per-scale IntParams, lane-major (C, K', N) f32 with the
// N = F n pixels of a channel minor, and the symbols as u8 planes; no CDF
// row and no (start, freq) pair is ever written to device memory.
//
// What bounds them on Hopper: operations, and the serial rANS chain. Every
// CDF edge costs K' exact-integer sigmoids (~88 f32 operations each, if
// evaluated) against ~50 bytes of IntParams per pixel; each stream's rANS
// chain is T dependent steps, so the walk is latency-bound. The design
// separates the two inside each block of 8 warps:
//   - every block first fills a table of int_sigmoid over its whole
//     integer domain (16384 u16, shared memory) from int_sigmoid itself,
//     so each sigmoid of the build is a table read (int_cdf.cuh);
//   - warps 1..7 build, for the block's streams, a tile of steps x streams
//     of CDF rows (decode: u16 row entries) or packed (start, freq)
//     pairs (encode) into shared memory, one pixel per thread, threads
//     running along a stream's pixels so IntParams reads are coalesced
//     and a pixel's K' parameters are loaded at once; an RGB encode block
//     walks the coarse and the fine streams of the same pixels, so one
//     builder computes both lookups from one read of the parameters;
//   - warp 0 walks the tile: one thread per encode stream; four lanes per
//     decode stream, each searching a quarter of the row, combined by
//     shuffles. The walk reads shared memory only (decode prefetches the
//     stream's next renorm word into a register through L1); the tiles
//     are double-buffered, so the walk of tile i overlaps the build of
//     tile i+1.
// Both are integer-exact: words and lengths byte-identical to the plain
// versions and the JAX scans, symbols identical; padding steps (past a
// channel's n pixels) are skipped and never move the state. The decoder's
// search is the reference's counts-and-extrema over the row, valid for
// any row of entries <= 65534 (the +2l spec's range). The encoder parks
// each renorm word at the end of its stream's word row and moves the run
// to the front once (decode order), so the JAX compaction pass is not
// needed.
//
// The tiles hold rows of at most 32 entries (L <= 33) and registers for
// at most kMaxK components. Beyond them the launchers run generic
// variants, up to K' <= 255 (the JAX package's u8 component rank) and L <=
// 256 (u8 symbols; the evaluator's products e a stay exact, below 2^24,
// for edges e <= 256), with the same exact-integer expressions, so the same
// words and symbols as the tiled kernels wherever both run:
//   - K3 generic (K' > 10) is the tiled encoder itself with each lookup a
//     loop over the components (a pixel's parameters loaded once each, no
//     register array of K' entries) and 2 streams a block, so a launch of
//     few streams still spreads over the SMs;
//   - K4 uniform (L > 33) walks one stream a thread by the closed-form
//     inverse of the row (edge e = floor(e 2^16 / L)): the symbol of cf is
//     ((cf + 1) L - 1) >> 16, its two edges come from a table of the L + 1
//     edges in shared memory; no row is built and no sigmoid evaluated; a
//     block is one warp, so the streams spread over the SMs;
//   - K4 bn, coarse and fine (K' > 10, or bn L > 33) give a block one
//     stream: 7 builder warps evaluate the stream's rows a tile ahead of
//     the walk into shared memory, a warp a row with lane j on edges
//     j + 1 + 32 i (fine: edges 0..16, whose 0 and 16 are the coarse bin's
//     bounds); the components come in chunks of 32, lane j loading
//     component j's parameters (one load a field for the chunk) and
//     staging them in shared memory, where every lane reads each with one
//     broadcast 16-byte load. Warp 0 walks, searching a row with the whole
//     warp (the reference's counts and extrema by __ballot_sync / __popc
//     and warp max / min reductions, the next row's entries read a step
//     ahead); the stream's renorm words come in coalesced windows of 32,
//     the next window loaded a window ahead and the next word shuffled out
//     a renorm ahead, so no load sits on the state's chain. The rows
//     depend on the IntParams, dec and asym alone, never on the state, so
//     building them ahead changes no result.
// What bounds the generic variants is the serial chain of each stream
// (T dependent steps; a few streams a launch), not bytes or operations:
// their times are read a step (ms / T) beside the bounds.
// A row entry sums its K' terms in k order, as int_coder does; each term
// is an integer <= 16384 held in f32, so a sum of up to 255 terms stays
// below 2^24 and is exact in any order (int_cdf.cuh).
#include <cstdint>
#include <cuda_runtime.h>

#include "int_cdf.cuh"

namespace {

using namespace l3c;

constexpr uint32_t kRansL = 1u << 16;
constexpr int kThreads = 256;               // warp 0 walks, 1..7 build
constexpr int kBuilders = kThreads - 32;
constexpr int kDecStreams = 8;              // streams per decode block
constexpr int kEncStreams = 16;             // streams per encode block
constexpr int kEncStreamsGeneric = 2;       // K3 generic's
constexpr int kMaxK = 10;                   // mixture components K'
constexpr int kMaxKGeneric = 255;           // K' of the generic variants
constexpr int kMaxLTile = 33;               // the tiles' symbols
constexpr int kMaxL = 256;                  // the generic variants'

enum DecMode { kDecUniform = 0, kDecBn = 1, kDecCoarse = 2, kDecFine = 3 };
enum EncMode { kEncUniform = 0, kEncBn = 1, kEncRgb = 2 };

// IntParams fields (C, K, N) f32; w: (3, K, N) lambda slots (RGB) or null
struct Params {
  const float* p;
  const float* a;
  const float* sc;
  const float* v;
  const float* w;
  int K;
  int N;
};

// Stream geometry: lane s codes pixels i = (s % ns_c) T + t, t < T, of
// group g = s / ns_c while i < n; group g is pixel block g % F of
// channel c0 + g / F, i.e. channel pixel (g % F) n + i of N = F n.
struct Geom {
  int n;
  int T;
  int ns_c;
  int lanes;
  int F;
  int c0;
};

// bytes of the sigmoid table at the start of dynamic shared memory (the
// uniform modes evaluate no sigmoid)
template <bool kUniform>
__host__ __device__ constexpr size_t table_bytes() {
  return kUniform ? 0 : kSigmoidTable * sizeof(uint16_t);
}

__device__ __forceinline__ size_t at(const Params& P, int c, int k,
                                     size_t pix) {
  return (static_cast<size_t>(c) * P.K + k) * P.N + pix;
}

// the K' values of one IntParams field at a pixel, all loads in flight
// at once (KMAX >= K' registers; entries k >= K' are not read)
template <int KMAX>
__device__ __forceinline__ void load_k(float (&dst)[KMAX], const float* f,
                                       const Params& P, int c, size_t pix) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    dst[k] = k < P.K ? __ldg(f + at(P, c, k, pix)) : 0.0f;
}

// channel c's v with the lambda chain on the channel symbols s0, s1 of
// channels 0 and 1 (w slot j is row j of P.w)
template <int KMAX>
__device__ __forceinline__ void load_chained_v(float (&v)[KMAX],
                                               const Params& P, int c,
                                               size_t pix, float s0,
                                               float s1) {
  load_k(v, P.v, P, c, pix);
  if (c == 0) return;
  float wa[KMAX], wb[KMAX];
  load_k(wa, P.w, P, c == 1 ? 0 : 1, pix);
  if (c == 2) load_k(wb, P.w, P, 2, pix);
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    v[k] = c == 1 ? apply_lambda_chain(v[k], 1, wa[k], 0.0f, 0.0f, s0, s1)
                  : apply_lambda_chain(v[k], 2, 0.0f, wa[k], wb[k], s0, s1);
}

__device__ __forceinline__ float uniform_edge(int l, int L) {
  return static_cast<float>((static_cast<uint32_t>(l) << 16) /
                            static_cast<uint32_t>(L));
}

// ------------------------------------------------------------- decode

// Row entries 1..LP of channel c's CDF row at pixel pix (entry 0 is 0 in
// every mode and is not stored); entries l >= L - 1 are padding, 0xFFFF.
template <int MODE, int LP, int KMAX>
__device__ __forceinline__ void build_row(const Params& P,
                                          const uint16_t* tab,
                                          const uint8_t* __restrict__ dec,
                                          const uint8_t* __restrict__ asym,
                                          int c, size_t pix, int L,
                                          uint16_t* row) {
  float q[LP];
  if (MODE == kDecUniform) {
#pragma unroll
    for (int l = 0; l < LP; ++l)
      q[l] = l + 1 < L ? uniform_edge(l + 1, L) : 65535.0f;
  } else {
    float s0 = 0.0f, s1 = 0.0f, af = 0.0f;
    if (MODE != kDecBn) {
      if (c > 0) s0 = static_cast<float>(__ldg(dec + pix));
      if (c > 1) s1 = static_cast<float>(__ldg(dec + P.N + pix));
      if (MODE == kDecFine) af = static_cast<float>(__ldg(asym + pix));
    }
    // p, the edge step (a: bn, fine; sc: coarse, fine) and v (with the
    // lambda chain for RGB)
    float p[KMAX], step[KMAX], sc[KMAX], v[KMAX];
    load_k(p, P.p, P, c, pix);
    load_k(step, MODE == kDecCoarse ? P.sc : P.a, P, c, pix);
    if (MODE == kDecFine) load_k(sc, P.sc, P, c, pix);
    if (MODE == kDecBn) {
      load_k(v, P.v, P, c, pix);
    } else {
      load_chained_v(v, P, c, pix, s0, s1);
    }
    float acc[LP];
    float c_lo = 0.0f, c_hi = 0.0f;
#pragma unroll
    for (int l = 0; l < LP; ++l) acc[l] = 0.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= P.K) break;
      if (MODE == kDecBn) {
#pragma unroll
        for (int l = 0; l < LP; ++l)
          if (l + 1 < L)
            acc[l] += table_term(tab, p[k], bn_z(l + 1.0f, step[k], v[k]));
      } else if (MODE == kDecCoarse) {
#pragma unroll
        for (int l = 0; l < LP; ++l)
          if (l + 1 < L)
            acc[l] += table_term(tab, p[k],
                                 coarse_z(l + 1.0f, step[k], v[k]));
      } else {
        const float z_a = fine_za(af, sc[k], v[k]);
        c_lo += table_term(tab, p[k], clip_z(z_a));
        c_hi += table_term(
            tab, p[k], fine_z(z_a, static_cast<float>(kFineBins), step[k]));
#pragma unroll
        for (int l = 0; l < LP; ++l)
          if (l + 1 < L)
            acc[l] += table_term(tab, p[k], fine_z(z_a, l + 1.0f, step[k]));
      }
    }
    float lo = 0.0f, d = 1.0f;
    if (MODE == kDecFine)
      cond_bounds(af, cdf_clamp(c_lo), cdf_clamp(c_hi), &lo, &d);
#pragma unroll
    for (int l = 0; l < LP; ++l) {
      float cq = cdf_clamp(acc[l]);
      if (MODE == kDecFine) cq = cond_norm(cq, lo, d);
      q[l] = l + 1 < L ? quantize_edge(cq, l + 1.0f, L) : 65535.0f;
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int j = 0; j < LP / 8; ++j) {
    uint32_t u[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      u[h] = static_cast<uint32_t>(q[8 * j + 2 * h]) |
             (static_cast<uint32_t>(q[8 * j + 2 * h + 1]) << 16);
    dst[j] = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// decode tile geometry: kG streams x kS steps of LP-entry u16 rows; warp 0
// walks them with kLanes lanes per stream, each lane searching LP / 8 of
// the row's u32 words (two entries each)
template <int LP>
struct DecTile {
  static constexpr int kG = kDecStreams;
  static constexpr int kLanes = 32 / kG;
  static constexpr int kWords = LP / 2 / kLanes;
  static constexpr int kS = kBuilders / kG;      // one pixel per builder
  static constexpr int kGStride = kS * LP + 8;   // +16 B: streams spread
  static constexpr size_t kRowBytes = 2 * kG * kGStride * sizeof(uint16_t);
};

// IntParams P; dec (>= c0 rows, N) u8 channel symbols for the lambda
// chain (RGB); asym (N,) u8 coarse symbols (fine); words (lanes, W) int32
// u16 values in decode order -> syms (lanes / ns_c, n) u8.
template <int MODE, int LP, int KMAX>
__global__ void __launch_bounds__(kThreads)
    rans_decode_kernel(Params P, const uint8_t* __restrict__ dec,
                       const uint8_t* __restrict__ asym,
                       const int32_t* __restrict__ words,
                       uint8_t* __restrict__ syms, Geom G, int W, int L) {
  using D = DecTile<LP>;
  constexpr int kG = D::kG, kS = D::kS, kGStride = D::kGStride;
  constexpr int kLanes = D::kLanes, kWords = D::kWords;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem);
  uint16_t* rows = reinterpret_cast<uint16_t*>(
      smem + table_bytes<MODE == kDecUniform>());     // [2][kG][kGStride]
  const int tid = threadIdx.x;
  const int s_first = blockIdx.x * kG;
  const int ntiles = (G.T + kS - 1) / kS;
  if (table_bytes<MODE == kDecUniform>()) {
    fill_sigmoid_table(tab, tid, kThreads);
    __syncthreads();
  }

  auto build = [&](int t0, int buf) {
    const int idx = tid - 32;
    const int gl = idx / kS, tt = idx % kS;
    const int s = s_first + gl, t = t0 + tt;
    if (s >= G.lanes || t >= G.T) return;
    const int g = s / G.ns_c;
    const int i = (s % G.ns_c) * G.T + t;
    if (i >= G.n) return;
    const size_t pix = static_cast<size_t>(g % G.F) * G.n + i;
    build_row<MODE, LP, KMAX>(P, tab, dec, asym, G.c0 + g / G.F, pix, L,
                              rows + (buf * kG + gl) * kGStride + tt * LP);
  };

  // warp 0: lanes [kLanes gl, kLanes (gl + 1)) walk stream s_first + gl
  // in step, each holding the stream's state
  const int gl = tid / kLanes, part = tid % kLanes;
  const unsigned group = ((1u << kLanes) - 1) << (kLanes * gl);
  const int s = s_first + gl;
  const bool walker = tid < 32 && s < G.lanes;
  const int32_t* wr = words + static_cast<size_t>(walker ? s : 0) * W;
  uint32_t x = 0;
  int cur = 2, nvalid = 0;
  size_t out = 0;
  if (walker) {
    x = static_cast<uint32_t>(wr[0]) | (static_cast<uint32_t>(wr[1]) << 16);
    const int i0 = (s % G.ns_c) * G.T;
    nvalid = min(G.T, G.n - i0);
    out = static_cast<size_t>(s / G.ns_c) * G.n + i0;
  }
  // which u16 halves of this lane's row words are entries 1..L-1
  uint32_t valid[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int e = 2 * (part * kWords + j) + 1;       // entry of the low half
    valid[j] = (e < L ? 0xFFFFu : 0u) | (e + 1 < L ? 0xFFFF0000u : 0u);
  }
  // the stream's next renorm word, prefetched through L1
  uint32_t wnext = walker && cur < W ? static_cast<uint32_t>(wr[cur]) : 0u;
  if (tid >= 32) build(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    __syncthreads();     // tile it is built; the walk of it - 1 is done
    const int buf = it & 1;
    if (tid < 32) {
      const int t0 = it * kS;
      const int steps = walker ? min(kS, nvalid - t0) : 0;
      const uint32_t* tile = reinterpret_cast<const uint32_t*>(
          rows + (buf * kG + gl) * kGStride) + part * kWords;
      for (int tt = 0; tt < steps; ++tt) {
        const uint32_t* r = tile + tt * (LP / 2);
        const uint32_t cf = x & 0xFFFFu;
        // searchsorted as counts and extrema over the row: this lane's
        // words, two u16 entries each, then over the stream's lanes;
        // entry 0 (= 0) is always <= cf
        const uint32_t cf2 = cf | (cf << 16);
        uint32_t cnt = 0, lo2 = 0, hi2 = 0xFFFFFFFFu;
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          const uint32_t u = r[j];
          const uint32_t m = __vcmpleu2(u, cf2) & valid[j];
          cnt += __popc(m);
          lo2 = __vmaxu2(lo2, u & m);
          hi2 = __vminu2(hi2, u | m);        // entries <= cf drop out
        }
        uint32_t lo = max(lo2 & 0xFFFFu, lo2 >> 16);
        uint32_t hi = min(hi2 & 0xFFFFu, hi2 >> 16);
#pragma unroll
        for (int o = 1; o < kLanes; o <<= 1) {
          cnt += __shfl_xor_sync(group, cnt, o);
          lo = max(lo, __shfl_xor_sync(group, lo, o));
          hi = min(hi, __shfl_xor_sync(group, hi, o));
        }
        const int sym = static_cast<int>(cnt >> 4);
        // no entry above cf (entries are <= 65534): the top is 65536
        if (sym == L - 1) hi = 65536;
        const uint32_t x1 = (hi - lo) * (x >> 16) + cf - lo;
        if (x1 < kRansL) {
          x = (x1 << 16) | wnext;
          ++cur;
          wnext = cur < W ? static_cast<uint32_t>(wr[cur]) : 0u;
        } else {
          x = x1;
        }
        if (part == 0) syms[out + t0 + tt] = static_cast<uint8_t>(sym);
      }
    } else if (it + 1 < ntiles) {
      build((it + 1) * kS, buf ^ 1);
    }
  }
}

// ------------------------------------------------------------- encode

// (freq << 16) | start from the quantized CDF at the symbol's two edges
__device__ __forceinline__ uint32_t pack_sf(float q0, float q1) {
  const uint32_t start = static_cast<uint32_t>(q0);
  return ((static_cast<uint32_t>(q1) - start) << 16) | start;
}

// packed (start, freq) of the uniform or bn symbol at channel pixel pix,
// from the two CDF edges around it
template <int MODE, int KMAX>
__device__ __forceinline__ uint32_t lookup(const Params& P,
                                           const uint16_t* tab,
                                           const uint8_t* __restrict__ sym,
                                           int c, size_t pix, int L) {
  const int t = __ldg(sym + static_cast<size_t>(c) * P.N + pix);
  if (MODE == kEncUniform) return pack_sf(uniform_edge(t, L),
                                          uniform_edge(t + 1, L));
  const float e = static_cast<float>(t);
  float p[KMAX], a[KMAX], v[KMAX];
  load_k(p, P.p, P, c, pix);
  load_k(a, P.a, P, c, pix);
  load_k(v, P.v, P, c, pix);
  float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= P.K) break;
    acc0 += table_term(tab, p[k], bn_z(e, a[k], v[k]));
    acc1 += table_term(tab, p[k], bn_z(e + 1.0f, a[k], v[k]));
  }
  return pack_sf(quantize_edge(cdf_clamp(acc0), e, L),
                 quantize_edge(cdf_clamp(acc1), e + 1.0f, L));
}

// packed (start, freq) of RGB channel c's coarse (.x) and fine (.y) symbol
// at pixel pix, the lambda chain on the true symbols of channels < c
template <int KMAX>
__device__ __forceinline__ uint2 lookup_rgb(const Params& P,
                                            const uint16_t* tab,
                                            const uint8_t* __restrict__ sym,
                                            int c, size_t pix) {
  const int t = __ldg(sym + static_cast<size_t>(c) * P.N + pix);
  const float s0 = c > 0 ? static_cast<float>(__ldg(sym + pix)) : 0.0f;
  const float s1 = c > 1 ? static_cast<float>(__ldg(sym + P.N + pix)) : 0.0f;
  const float af = static_cast<float>(t >> 4);
  const float bf = static_cast<float>(t & 15);
  float p[KMAX], a[KMAX], sc[KMAX], v[KMAX];
  load_k(p, P.p, P, c, pix);
  load_k(a, P.a, P, c, pix);
  load_k(sc, P.sc, P, c, pix);
  load_chained_v(v, P, c, pix, s0, s1);
  float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f, c_lo = 0.0f, c_hi = 0.0f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= P.K) break;
    a0 += table_term(tab, p[k], coarse_z(af, sc[k], v[k]));
    a1 += table_term(tab, p[k], coarse_z(af + 1.0f, sc[k], v[k]));
    const float z_a = fine_za(af, sc[k], v[k]);
    c_lo += table_term(tab, p[k], clip_z(z_a));
    c_hi += table_term(tab, p[k],
                       fine_z(z_a, static_cast<float>(kFineBins), a[k]));
    b0 += table_term(tab, p[k], fine_z(z_a, bf, a[k]));
    b1 += table_term(tab, p[k], fine_z(z_a, bf + 1.0f, a[k]));
  }
  float lo, d;
  cond_bounds(af, cdf_clamp(c_lo), cdf_clamp(c_hi), &lo, &d);
  return make_uint2(
      pack_sf(quantize_edge(cdf_clamp(a0), af, kCoarseBins),
              quantize_edge(cdf_clamp(a1), af + 1.0f, kCoarseBins)),
      pack_sf(quantize_edge(cond_norm(cdf_clamp(b0), lo, d), bf, kFineBins),
              quantize_edge(cond_norm(cdf_clamp(b1), lo, d), bf + 1.0f,
                            kFineBins)));
}

// ------------------------------------------------- generic lookups

// field f of channel c, component k at pixel pix, read where it lies
__device__ __forceinline__ float ldk(const float* f, const Params& P, int c,
                                     int k, size_t pix) {
  return __ldg(f + at(P, c, k, pix));
}

// channel c's v of component k with the lambda chain, as load_chained_v
__device__ __forceinline__ float chained_v(const Params& P, int c, int k,
                                           size_t pix, float s0, float s1) {
  const float v = ldk(P.v, P, c, k, pix);
  if (c == 0) return v;
  if (c == 1)
    return apply_lambda_chain(v, 1, ldk(P.w, P, 0, k, pix), 0.0f, 0.0f, s0,
                              s1);
  return apply_lambda_chain(v, 2, 0.0f, ldk(P.w, P, 1, k, pix),
                            ldk(P.w, P, 2, k, pix), s0, s1);
}

// lookup's packed (start, freq) for any K': a loop over the components,
// each one's parameters loaded once for both edges
template <int MODE>
__device__ __forceinline__ uint32_t lookup_generic(
    const Params& P, const uint16_t* tab, const uint8_t* __restrict__ sym,
    int c, size_t pix, int L) {
  const int t = __ldg(sym + static_cast<size_t>(c) * P.N + pix);
  if (MODE == kEncUniform) return pack_sf(uniform_edge(t, L),
                                          uniform_edge(t + 1, L));
  const float e = static_cast<float>(t);
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int k = 0; k < P.K; ++k) {
    const float p = ldk(P.p, P, c, k, pix), a = ldk(P.a, P, c, k, pix);
    const float v = ldk(P.v, P, c, k, pix);
    acc0 += table_term(tab, p, bn_z(e, a, v));
    acc1 += table_term(tab, p, bn_z(e + 1.0f, a, v));
  }
  return pack_sf(quantize_edge(cdf_clamp(acc0), e, L),
                 quantize_edge(cdf_clamp(acc1), e + 1.0f, L));
}

// lookup_rgb's coarse (.x) and fine (.y) pairs for any K'
__device__ __forceinline__ uint2 lookup_rgb_generic(
    const Params& P, const uint16_t* tab, const uint8_t* __restrict__ sym,
    int c, size_t pix) {
  const int t = __ldg(sym + static_cast<size_t>(c) * P.N + pix);
  const float s0 = c > 0 ? static_cast<float>(__ldg(sym + pix)) : 0.0f;
  const float s1 = c > 1 ? static_cast<float>(__ldg(sym + P.N + pix)) : 0.0f;
  const float af = static_cast<float>(t >> 4);
  const float bf = static_cast<float>(t & 15);
  float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f, c_lo = 0.0f, c_hi = 0.0f;
  for (int k = 0; k < P.K; ++k) {
    const float p = ldk(P.p, P, c, k, pix), a = ldk(P.a, P, c, k, pix);
    const float sc = ldk(P.sc, P, c, k, pix);
    const float v = chained_v(P, c, k, pix, s0, s1);
    a0 += table_term(tab, p, coarse_z(af, sc, v));
    a1 += table_term(tab, p, coarse_z(af + 1.0f, sc, v));
    const float z_a = fine_za(af, sc, v);
    c_lo += table_term(tab, p, clip_z(z_a));
    c_hi += table_term(tab, p, fine_z(z_a, static_cast<float>(kFineBins), a));
    b0 += table_term(tab, p, fine_z(z_a, bf, a));
    b1 += table_term(tab, p, fine_z(z_a, bf + 1.0f, a));
  }
  float lo, d;
  cond_bounds(af, cdf_clamp(c_lo), cdf_clamp(c_hi), &lo, &d);
  return make_uint2(
      pack_sf(quantize_edge(cdf_clamp(a0), af, kCoarseBins),
              quantize_edge(cdf_clamp(a1), af + 1.0f, kCoarseBins)),
      pack_sf(quantize_edge(cond_norm(cdf_clamp(b0), lo, d), bf, kFineBins),
              quantize_edge(cond_norm(cdf_clamp(b1), lo, d), bf + 1.0f,
                            kFineBins)));
}

// the encode builders' lookups: KMAX registers a parameter, or (KMAX = 0,
// K3 generic) the loops above
template <int MODE, int KMAX>
__device__ __forceinline__ uint32_t lookup_any(
    const Params& P, const uint16_t* tab, const uint8_t* __restrict__ sym,
    int c, size_t pix, int L) {
  if constexpr (KMAX == 0) {
    return lookup_generic<MODE>(P, tab, sym, c, pix, L);
  } else {
    return lookup<MODE, KMAX>(P, tab, sym, c, pix, L);
  }
}

template <int KMAX>
__device__ __forceinline__ uint2 lookup_rgb_any(
    const Params& P, const uint16_t* tab, const uint8_t* __restrict__ sym,
    int c, size_t pix) {
  if constexpr (KMAX == 0) {
    return lookup_rgb_generic(P, tab, sym, c, pix);
  } else {
    return lookup_rgb<KMAX>(P, tab, sym, c, pix);
  }
}

// encode tile geometry: kG streams x kS steps of packed (start, freq);
// RGB blocks walk the coarse and the fine streams of the same kPix pixel
// streams, whose lookups one builder computes from one read of the params
// (kG = kEncStreams in the tiled kernels, kEncStreamsGeneric in K3 generic)
template <int MODE, int NG = kEncStreams>
struct EncTile {
  static constexpr int kLevels = MODE == kEncRgb ? 2 : 1;
  static constexpr int kG = NG;
  static constexpr int kPix = kG / kLevels;
  static constexpr int kS = kBuilders / kPix;    // one pixel per builder
  static constexpr size_t kBufBytes = 2 * kG * kS * sizeof(uint32_t);
};

// IntParams P; sym (C, N) u8 symbol planes (RGB: the image's three
// channel planes) -> words (lanes, T + 2) int32 u16 values in decode
// order [state_lo, state_hi, renorm words...], slots past a stream's
// length left as they are; lengths (lanes,) int32 = renorm words + 2.
// RGB: lanes [0, lanes/2) code the coarse symbols of groups 0..3F-1
// (channel-major), lanes [lanes/2, lanes) the fine ones. KMAX = 0 is K3
// generic: any K', NG streams a block.
template <int MODE, int KMAX, int NG = kEncStreams>
__global__ void __launch_bounds__(kThreads)
    rans_encode_kernel(Params P, const uint8_t* __restrict__ sym,
                       int32_t* __restrict__ words,
                       int32_t* __restrict__ lengths, Geom G, int L) {
  using E = EncTile<MODE, NG>;
  constexpr int kG = E::kG, kPix = E::kPix, kS = E::kS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem);
  uint32_t* sf = reinterpret_cast<uint32_t*>(
      smem + table_bytes<MODE == kEncUniform>());     // [2][kG][kS]
  const int tid = threadIdx.x;
  const int pix_lanes = G.lanes / E::kLevels;
  const int s_first = blockIdx.x * kPix;
  const int ntiles = (G.T + kS - 1) / kS;
  if (table_bytes<MODE == kEncUniform>()) {
    fill_sigmoid_table(tab, tid, kThreads);
    __syncthreads();
  }

  auto build = [&](int t0, int buf) {
    const int idx = tid - 32;
    const int gl = idx / kS, tt = idx % kS;
    const int s = s_first + gl, t = t0 + tt;
    if (s >= pix_lanes || t >= G.T) return;
    const int g = s / G.ns_c;
    const int i = (s % G.ns_c) * G.T + t;
    if (i >= G.n) return;
    const size_t pix = static_cast<size_t>(g % G.F) * G.n + i;
    uint32_t* out = sf + (buf * kG + gl) * kS + tt;
    if (MODE == kEncRgb) {
      const uint2 q = lookup_rgb_any<KMAX>(P, tab, sym, g / G.F, pix);
      out[0] = q.x;
      out[kPix * kS] = q.y;                  // the fine stream's slot
    } else {
      out[0] = lookup_any<MODE, KMAX>(P, tab, sym, g / G.F, pix, L);
    }
  };

  // walker tid codes level tid / kPix of pixel stream s_first + tid % kPix
  const int ps = s_first + tid % kPix;
  const bool walker = tid < kG && ps < pix_lanes;
  const int s = (tid / kPix) * pix_lanes + ps;
  int32_t* row = words + static_cast<size_t>(walker ? s : 0) * (G.T + 2);
  const int nvalid = walker ? min(G.T, G.n - (ps % G.ns_c) * G.T) : 0;
  uint32_t x = kRansL;
  int nw = 0;                               // renorm words emitted so far
  if (tid >= 32) build((ntiles - 1) * kS, 0);
  for (int it = 0; it < ntiles; ++it) {     // rANS encodes in reverse
    __syncthreads();
    const int buf = it & 1;
    const int t0 = (ntiles - 1 - it) * kS;
    if (tid < 32) {
      const int steps = walker ? min(kS, nvalid - t0) : 0;
      const uint32_t* tile = sf + (buf * kG + tid) * kS;
      for (int tt = steps - 1; tt >= 0; --tt) {
        const uint32_t v = tile[tt];
        const uint32_t st = v & 0xFFFFu, f = v >> 16;
        if (x >= (f << 16)) {
          // the k-th emitted word is the (n_emit-1-k)-th in decode order:
          // park it at the row's end, counting down
          row[G.T + 1 - nw] = static_cast<int32_t>(x & 0xFFFFu);
          ++nw;
          x >>= 16;
        }
        const uint32_t fs = f > 0 ? f : 1u;
        x = ((x / fs) << 16) + (x % fs) + st;
      }
    } else if (it + 1 < ntiles) {
      build(t0 - kS, buf ^ 1);
    }
  }
  if (!walker) return;
  // move the nw parked words [T+2-nw, T+2) to [2, 2+nw): dst < src, so an
  // ascending copy never overwrites a word before it is read
  for (int i = 0; i < nw; ++i) row[2 + i] = row[G.T + 2 - nw + i];
  row[0] = static_cast<int32_t>(x & 0xFFFFu);
  row[1] = static_cast<int32_t>(x >> 16);
  lengths[s] = nw + 2;
}

// ------------------------------------------------------ generic decode

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kUniThreads = 32;               // K4 uniform: a warp a block
constexpr int kGenBuilders = kThreads / 32 - 1;   // K4 generic: warps 1..7
constexpr int kGenRows = 8;                   // rows a builder warp a tile
constexpr int kGenS = kGenBuilders * kGenRows;    // steps a tile
constexpr int kMaxEpl = (kMaxL - 1 + 31) / 32;    // row entries a lane

// edge e of the uniform row, floor(e 2^16 / L), for e = 0..L (edge L is
// 2^16, the top)
__device__ __forceinline__ uint32_t uniform_edge_u(uint32_t e, uint32_t L) {
  return (e << 16) / L;
}

// the uniform symbol of cf: the largest s < L whose edge is <= cf. Since
// floor(y) <= cf <=> y < cf + 1, edge(e) <= cf <=> e 2^16 < (cf + 1) L <=>
// e <= ((cf + 1) L - 1) / 2^16, so the symbol is that floor, exactly (the
// product is below 2^24), and it is at most L - 1 for every cf < 2^16
__device__ __forceinline__ uint32_t uniform_symbol(uint32_t cf, uint32_t L) {
  return ((cf + 1u) * L - 1u) >> 16;
}

// K4 uniform for any L: thread s walks stream s by the closed-form inverse
__global__ void __launch_bounds__(kUniThreads)
    rans_decode_uniform(const int32_t* __restrict__ words,
                        uint8_t* __restrict__ syms, Geom G, int W, int L) {
  __shared__ uint32_t edge[kMaxL + 1];
  for (int e = threadIdx.x; e <= L; e += kUniThreads)
    edge[e] = uniform_edge_u(e, L);
  __syncthreads();
  const int s = blockIdx.x * kUniThreads + threadIdx.x;
  if (s >= G.lanes) return;
  const int32_t* wr = words + static_cast<size_t>(s) * W;
  uint32_t x = static_cast<uint32_t>(wr[0]) |
               (static_cast<uint32_t>(wr[1]) << 16);
  int cur = 2;
  uint32_t wnext = cur < W ? static_cast<uint32_t>(wr[cur]) : 0u;
  const int g = s / G.ns_c, i0 = (s % G.ns_c) * G.T;
  const int nvalid = min(G.T, G.n - i0);
  uint8_t* out = syms + static_cast<size_t>(g) * G.n + i0;
  for (int t = 0; t < nvalid; ++t) {
    const uint32_t cf = x & 0xFFFFu;
    const uint32_t sym = uniform_symbol(cf, L);
    const uint32_t lo = edge[sym], hi = edge[sym + 1];
    const uint32_t x1 = (hi - lo) * (x >> 16) + cf - lo;
    if (x1 < kRansL) {
      x = (x1 << 16) | wnext;
      ++cur;
      wnext = cur < W ? static_cast<uint32_t>(wr[cur]) : 0u;
    } else {
      x = x1;
    }
    out[t] = static_cast<uint8_t>(sym);
  }
}

// One pixel's row built by a warp into row[e - 1], e = 1..L-1: lane j
// evaluates the edges e = j + e0 + 32 i, i < epl <= EPL, summing the K'
// components in k order. The components come in chunks of 32: lane j
// loads component k0 + j's parameters (one load a field for the chunk,
// all in flight at once), computes its v with the lambda chain (fine: its
// z_a) and stages (p, edge step, v) in the warp's `stage`; every lane then
// reads each component's values with one broadcast 16-byte load. e0 =
// 1, except in the fine mode, where e0 = 0 and lanes 0 and 16 evaluate
// edges 0 and 16: the coarse bin's bounds c_lo (clip_z(z_a) = fine_z(z_a,
// 0, a)) and c_hi (fine_z(z_a, 16, a)).
template <int MODE, int EPL>
__device__ __forceinline__ void build_row_warp(
    const Params& P, const uint16_t* tab, const uint8_t* __restrict__ dec,
    const uint8_t* __restrict__ asym, int c, size_t pix, int L, int epl,
    int lane, float4* stage, uint16_t* row) {
  constexpr int e0 = MODE == kDecFine ? 0 : 1;
  float s0 = 0.0f, s1 = 0.0f, af = 0.0f;
  if (MODE != kDecBn) {
    if (c > 0) s0 = static_cast<float>(__ldg(dec + pix));
    if (c > 1) s1 = static_cast<float>(__ldg(dec + P.N + pix));
    if (MODE == kDecFine) af = static_cast<float>(__ldg(asym + pix));
  }
  float acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < P.K; k0 += 32) {
    // lane j: component k0 + j's p, edge step (a: bn, fine; sc: coarse)
    // and v (fine: z_a)
    const int k = k0 + lane;
    float p_j = 0.0f, step_j = 0.0f, v_j = 0.0f;
    if (k < P.K) {
      p_j = ldk(P.p, P, c, k, pix);
      step_j = ldk(MODE == kDecCoarse ? P.sc : P.a, P, c, k, pix);
      if (MODE == kDecBn) {
        v_j = ldk(P.v, P, c, k, pix);
      } else {
        v_j = chained_v(P, c, k, pix, s0, s1);
        if (MODE == kDecFine) v_j = fine_za(af, ldk(P.sc, P, c, k, pix), v_j);
      }
    }
    __syncwarp(kFull);              // the last chunk's reads are done
    stage[lane] = make_float4(p_j, step_j, v_j, 0.0f);
    __syncwarp(kFull);
    const int nk = min(32, P.K - k0);
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float4 cp = stage[j];
      const float p = cp.x, step = cp.y, v = cp.z;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        if (i < epl) {
          const float ef = static_cast<float>(lane + e0 + 32 * i);
          const float z = MODE == kDecBn     ? bn_z(ef, step, v)
                          : MODE == kDecCoarse ? coarse_z(ef, step, v)
                                               : fine_z(v, ef, step);
          acc[i] += table_term(tab, p, z);
        }
      }
    }
  }
  float lo = 0.0f, d = 1.0f;
  if (MODE == kDecFine) {
    const float c_lo = __shfl_sync(kFull, acc[0], 0);
    const float c_hi = __shfl_sync(kFull, acc[0], kFineBins);
    cond_bounds(af, cdf_clamp(c_lo), cdf_clamp(c_hi), &lo, &d);
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int e = lane + e0 + 32 * i;
    if (i < epl && e >= 1 && e < L) {
      float cq = cdf_clamp(acc[i]);
      if (MODE == kDecFine) cq = cond_norm(cq, lo, d);
      row[e - 1] = static_cast<uint16_t>(
          quantize_edge(cq, static_cast<float>(e), L));
    }
  }
}

// K4 bn / coarse / fine for any K' and L (EPL = 1: L <= 33; 8: L <= 256):
// block b decodes stream b. Warps 1..7 build tiles of kGenS rows (row
// stride 32 epl u16, double-buffered in shared memory after the sigmoid
// table, then each builder warp's component stage); warp 0 walks them,
// every lane holding the state.
template <int MODE, int EPL>
__global__ void __launch_bounds__(kThreads)
    rans_decode_generic(Params P, const uint8_t* __restrict__ dec,
                        const uint8_t* __restrict__ asym,
                        const int32_t* __restrict__ words,
                        uint8_t* __restrict__ syms, Geom G, int W, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem);
  uint16_t* rows = reinterpret_cast<uint16_t*>(smem + table_bytes<false>());
  const int epl = MODE == kDecBn ? (L + 30) / 32 : 1;
  const int rs = 32 * epl;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float4* stage = reinterpret_cast<float4*>(rows + 2 * kGenS * rs) +
                  (warp > 0 ? warp - 1 : 0) * 32;
  fill_sigmoid_table(tab, tid, kThreads);
  __syncthreads();
  const int s = blockIdx.x;
  const int g = s / G.ns_c, i0 = (s % G.ns_c) * G.T;
  const int c = G.c0 + g / G.F;
  const int nvalid = min(G.T, G.n - i0);
  const size_t pix0 = static_cast<size_t>(g % G.F) * G.n + i0;
  const int ntiles = (nvalid + kGenS - 1) / kGenS;

  // builder warp w takes rows w - 1, w - 1 + 7, ... of the tile at t0
  auto build = [&](int t0, int buf) {
    for (int j = 0; j < kGenRows; ++j) {
      const int tt = j * kGenBuilders + warp - 1;
      if (t0 + tt >= nvalid) break;
      build_row_warp<MODE, EPL>(P, tab, dec, asym, c, pix0 + t0 + tt, L, epl,
                                lane, stage,
                                rows + (buf * kGenS + tt) * rs);
    }
  };

  // the walker's renorm words in windows of 32, lane j holding word
  // base + j of the current window (wa) and of the next (wb, loaded a
  // window ahead); the next word is shuffled out a renorm ahead, so
  // neither load nor shuffle sits on the state's chain
  const int32_t* wr = words + static_cast<size_t>(s) * W;
  auto word = [&](int i) {
    return i < W ? static_cast<uint32_t>(wr[i]) : 0u;
  };
  uint32_t x = 0, wa = 0, wb = 0, wnext = 0;
  int cur = 2, base = 2;
  if (warp == 0) {
    x = word(0) | (word(1) << 16);
    wa = word(base + lane);
    wb = word(base + 32 + lane);
    wnext = __shfl_sync(kFull, wa, 0);
  }
  uint8_t* out = syms + static_cast<size_t>(g) * G.n + i0;
  if (warp > 0) build(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    __syncthreads();     // tile it is built; the walk of it - 1 is done
    const int buf = it & 1;
    if (warp == 0) {
      const int t0 = it * kGenS;
      const int steps = min(kGenS, nvalid - t0);
      const uint16_t* tile = rows + buf * kGenS * rs;
      // this lane's entries of the step's row, read a step ahead
      uint32_t q[EPL], qn[EPL];
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        q[i] = i < epl && steps > 0 ? tile[lane + 32 * i] : 0u;
      for (int tt = 0; tt < steps; ++tt) {
        const uint16_t* rn = tile + (tt + 1) * rs;
#pragma unroll
        for (int i = 0; i < EPL; ++i)
          qn[i] = i < epl && tt + 1 < steps ? rn[lane + 32 * i] : 0u;
        const uint32_t cf = x & 0xFFFFu;
        // counts and extrema over entries 1..L-1 (entry 0 = 0 is always
        // <= cf; no entry above cf leaves the top, 65536)
        uint32_t cnt = 0, lo = 0, hi = 65536;
#pragma unroll
        for (int i = 0; i < EPL; ++i) {
          if (i < epl) {
            const bool valid = lane + 1 + 32 * i < L;
            const bool le = valid && q[i] <= cf;
            cnt += __popc(__ballot_sync(kFull, le));
            if (le) lo = max(lo, q[i]);
            if (valid && !le) hi = min(hi, q[i]);
          }
        }
        lo = __reduce_max_sync(kFull, lo);
        hi = __reduce_min_sync(kFull, hi);
        const uint32_t x1 = (hi - lo) * (x >> 16) + cf - lo;
        if (x1 < kRansL) {         // the same on every lane
          x = (x1 << 16) | wnext;
          if (++cur - base == 32) {
            base += 32;
            wa = wb;
            wb = word(base + 32 + lane);
          }
          wnext = __shfl_sync(kFull, wa, cur - base);
        } else {
          x = x1;
        }
        if (lane == 0) out[t0 + tt] = static_cast<uint8_t>(cnt);
#pragma unroll
        for (int i = 0; i < EPL; ++i) q[i] = qn[i];
      }
    } else if (it + 1 < ntiles) {
      build((it + 1) * kGenS, buf ^ 1);
    }
  }
}

// launch `blocks` blocks of `threads` with `smem` bytes of dynamic shared
// memory (above 48 KB only after raising the kernel's limit)
template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), int blocks, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int blocks_for(int items, int per_block) {
  return (items + per_block - 1) / per_block;
}

template <int MODE, int LP, int KMAX>
int decode(const Params& P, const void* dec, const void* asym,
           const void* words, void* syms, const Geom& G, int W, int L,
           cudaStream_t stream) {
  using D = DecTile<LP>;
  const size_t smem = table_bytes<MODE == kDecUniform>() + D::kRowBytes;
  return launch(rans_decode_kernel<MODE, LP, KMAX>, blocks_for(G.lanes, D::kG),
                kThreads, smem, stream, P, static_cast<const uint8_t*>(dec),
                static_cast<const uint8_t*>(asym),
                static_cast<const int32_t*>(words),
                static_cast<uint8_t*>(syms), G, W, L);
}

// K' <= 4 (the top-k mixtures) or <= 10 registers per parameter
template <int MODE, int LP>
int decode_k(const Params& P, const void* dec, const void* asym,
             const void* words, void* syms, const Geom& G, int W, int L,
             cudaStream_t stream) {
  if constexpr (MODE != kDecUniform) {
    if (P.K > 4)
      return decode<MODE, LP, kMaxK>(P, dec, asym, words, syms, G, W, L,
                                     stream);
  }
  return decode<MODE, LP, 4>(P, dec, asym, words, syms, G, W, L, stream);
}

// KMAX = 0: K3 generic
template <int MODE, int KMAX, int NG = kEncStreams>
int encode_with(const Params& P, const void* sym, void* words, void* lengths,
                const Geom& G, int L, cudaStream_t stream) {
  using E = EncTile<MODE, NG>;
  const size_t smem = table_bytes<MODE == kEncUniform>() + E::kBufBytes;
  return launch(rans_encode_kernel<MODE, KMAX, NG>,
                blocks_for(G.lanes / E::kLevels, E::kPix), kThreads, smem,
                stream, P, static_cast<const uint8_t*>(sym),
                static_cast<int32_t*>(words), static_cast<int32_t*>(lengths),
                G, L);
}

template <int MODE>
int encode(const Params& P, const void* sym, void* words, void* lengths,
           const Geom& G, int L, cudaStream_t stream) {
  if constexpr (MODE != kEncUniform) {
    if (P.K > 4)
      return encode_with<MODE, kMaxK>(P, sym, words, lengths, G, L, stream);
  }
  return encode_with<MODE, 4>(P, sym, words, lengths, G, L, stream);
}

template <int MODE>
int decode_rows(int L, const Params& P, const void* dec, const void* asym,
                const void* words, void* syms, const Geom& G, int W,
                cudaStream_t stream) {
  // row entries 1..L-1 rounded up to whole 16-byte vectors
  if (L <= 17) return decode_k<MODE, 16>(P, dec, asym, words, syms, G, W, L,
                                         stream);
  if (L <= 25) return decode_k<MODE, 24>(P, dec, asym, words, syms, G, W, L,
                                         stream);
  return decode_k<MODE, 32>(P, dec, asym, words, syms, G, W, L, stream);
}

template <int MODE, int EPL>
int decode_generic_mode(const Params& P, const void* dec, const void* asym,
                        const void* words, void* syms, const Geom& G, int W,
                        int L, cudaStream_t stream) {
  const int epl = MODE == kDecBn ? (L + 30) / 32 : 1;
  const size_t smem = table_bytes<false>() +
                      2 * kGenS * 32 * epl * sizeof(uint16_t) +
                      kGenBuilders * 32 * sizeof(float4);
  return launch(rans_decode_generic<MODE, EPL>, G.lanes, kThreads, smem,
                stream, P, static_cast<const uint8_t*>(dec),
                static_cast<const uint8_t*>(asym),
                static_cast<const int32_t*>(words),
                static_cast<uint8_t*>(syms), G, W, L);
}

int decode_generic(int mode, const Params& P, const void* dec,
                   const void* asym, const void* words, void* syms,
                   const Geom& G, int W, int L, cudaStream_t stream) {
  switch (mode) {
    case kDecUniform:
      return launch(rans_decode_uniform, blocks_for(G.lanes, kUniThreads),
                    kUniThreads, 0, stream,
                    static_cast<const int32_t*>(words),
                    static_cast<uint8_t*>(syms), G, W, L);
    case kDecBn:
      if (L <= kMaxLTile)
        return decode_generic_mode<kDecBn, 1>(P, dec, asym, words, syms, G,
                                              W, L, stream);
      return decode_generic_mode<kDecBn, kMaxEpl>(P, dec, asym, words, syms,
                                                  G, W, L, stream);
    case kDecCoarse:
      return decode_generic_mode<kDecCoarse, 1>(P, dec, asym, words, syms, G,
                                                W, kCoarseBins, stream);
    case kDecFine:
      return decode_generic_mode<kDecFine, 1>(P, dec, asym, words, syms, G,
                                              W, kFineBins, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int encode_generic(int mode, const Params& P, const void* sym, void* words,
                   void* lengths, const Geom& G, int L, cudaStream_t stream) {
  switch (mode) {
    case kEncUniform:
      return encode_with<kEncUniform, 0, kEncStreamsGeneric>(
          P, sym, words, lengths, G, L, stream);
    case kEncBn:
      return encode_with<kEncBn, 0, kEncStreamsGeneric>(P, sym, words,
                                                        lengths, G, L, stream);
    case kEncRgb:
      return encode_with<kEncRgb, 0, kEncStreamsGeneric>(
          P, sym, words, lengths, G, kFineBins, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Params params(const void* p, const void* a, const void* sc, const void* v,
              const void* w, int K, int N) {
  return Params{static_cast<const float*>(p), static_cast<const float*>(a),
                static_cast<const float*>(sc), static_cast<const float*>(v),
                static_cast<const float*>(w), K, N};
}

}  // namespace

// mode: 0 uniform (L <= 256), 1 bn (L <= 256), 2 RGB coarse, 3 RGB fine
// (L = 16); K' <= 255; channel c0 (RGB) or 0 (bn); F groups per channel.
extern "C" int l3c_rans_decode(const void* p, const void* a, const void* sc,
                               const void* v, const void* w, const void* dec,
                               const void* asym, const void* words,
                               void* syms, int mode, int K, int N, int n,
                               int T, int W, int lanes, int F, int c0, int L,
                               void* stream) {
  const Params P = params(p, a, sc, v, w, K, N);
  const Geom G{n, T, (n + T - 1) / T, lanes, F, c0};
  auto st = static_cast<cudaStream_t>(stream);
  if (L < 2 || L > kMaxL || K > kMaxKGeneric)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K > kMaxK || (mode <= kDecBn && L > kMaxLTile))
    return decode_generic(mode, P, dec, asym, words, syms, G, W, L, st);
  switch (mode) {
    case kDecUniform:
      return decode_rows<kDecUniform>(L, P, dec, asym, words, syms, G, W, st);
    case kDecBn:
      return decode_rows<kDecBn>(L, P, dec, asym, words, syms, G, W, st);
    case kDecCoarse:
      return decode_k<kDecCoarse, 16>(P, dec, asym, words, syms, G, W,
                                      kCoarseBins, st);
    case kDecFine:
      return decode_k<kDecFine, 16>(P, dec, asym, words, syms, G, W,
                                    kFineBins, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// mode: 0 uniform, 1 bn, 2 RGB (coarse and fine units stacked, L = 16);
// sym (C, N) u8 with N = F n; F groups per channel.
extern "C" int l3c_rans_encode(const void* p, const void* a, const void* sc,
                               const void* v, const void* w, const void* sym,
                               void* words, void* lengths, int mode, int K,
                               int N, int n, int T, int lanes, int F, int L,
                               void* stream) {
  const Params P = params(p, a, sc, v, w, K, N);
  const Geom G{n, T, (n + T - 1) / T, lanes, F, 0};
  auto st = static_cast<cudaStream_t>(stream);
  if (L < 2 || L > kMaxL || K > kMaxKGeneric)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K > kMaxK) return encode_generic(mode, P, sym, words, lengths, G, L, st);
  switch (mode) {
    case kEncUniform:
      return encode<kEncUniform>(P, sym, words, lengths, G, L, st);
    case kEncBn:
      return encode<kEncBn>(P, sym, words, lengths, G, L, st);
    case kEncRgb:
      return encode<kEncRgb>(P, sym, words, lengths, G, kFineBins, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
