// The format-v8 exact-integer coding CDF as device functions, shared by
// the rANS decode (row entries) and encode (2-edge lookups) kernels of
// rans.cu, so that both evaluate one expression per edge.
//
// Counterpart of l3c_torch/ops/int_coder.py (itself the port of
// l3c_tpu/ops/int_coder.py); every function keeps the name, the f32
// expressions and their order, and the floor-correction rounds:
//   int_sigmoid        int_coder.py int_sigmoid        (JAX :94)
//   mixture term/sum   int_coder.py mixture_cdf_q14    (JAX :130)
//   quantize_edge      int_coder.py quantize_edges     (JAX :146)
//   floor_div          int_coder.py _floor_div         (JAX :162)
//   apply_lambda_chain int_coder.py apply_lambda_chain (JAX :355)
//   cond_bounds/norm   int_coder.py _cond_bounds/_norm (JAX :496/:508)
//   clip_z, *_z        the bn, coarse and fine edge z's with _clip_z
// Every value is an integer held in f32 and every product is exact within
// 24 significand bits, so each operation is exact and the results equal
// the PyTorch (and JAX) evaluator's bit for bit on any IEEE device; the
// two true divisions are corrected to the exact floor whatever the
// divide's rounding. The file is compiled without fast math and with
// -fmad=false (build.py), though exact products make contraction
// harmless anyway.
#pragma once

#include <cstdint>

namespace l3c {

constexpr float kZSat = 16383.0f;         // Z_SAT: |z| saturates sigmoid
constexpr float kVClamp = 16777216.0f;    // V_CLAMP = 2^24
constexpr float kCOne = 16384.0f;         // C_ONE: CDF 1.0 in Q14
constexpr int kFineBins = 16;             // FINE
constexpr int kCoarseBins = 16;           // N_COARSE

// floor(x / 2^P), exact for integer-valued f32 x (int_coder._fdiv2)
template <int P>
__device__ __forceinline__ float fdiv2(float x) {
  return floorf(x * (1.0f / static_cast<float>(1 << P)));
}

// sigmoid(z / 2^10) in Q12 for integer z, exact-integer f32 in and out
__device__ __forceinline__ float int_sigmoid(float z) {
  const bool neg = z < 0.0f;
  const float za = fminf(fabsf(z), kZSat);
  const float i = fdiv2<10>(za);                  // 0..15
  const float f = za - i * 1024.0f;               // 0..1023
  // e^-f: Q14-internal Horner (f * p <= 2^24)
  float p = 419.0f;
  p = 2517.0f - fdiv2<10>(f * p);
  p = 8116.0f - fdiv2<10>(f * p);
  p = 16373.0f - fdiv2<10>(f * p);
  p = 16384.0f - fdiv2<10>(f * p);
  float e = fdiv2<2>(p);                          // Q12
  // e^-i: conditional multiplies on the bits of i
  const float cb[4] = {1507.0f, 554.0f, 75.0f, 1.0f};
  float ib = i;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float half = fdiv2<1>(ib);
    const float odd = ib - half * 2.0f;
    e = odd > 0.0f ? fdiv2<12>(e * cb[b]) : e;
    ib = half;
  }
  // floor(2^24 / (4096 + e)) with two exact correction rounds
  const float d = 4096.0f + e;
  const float num = 16777216.0f;
  float q = floorf(num / d);
  const float d_hi = fdiv2<6>(d);
  const float d_lo = d - d_hi * 64.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float rem = (num - q * d_hi * 64.0f) - q * d_lo;
    q = q + (rem >= d ? 1.0f : 0.0f) - (rem < 0.0f ? 1.0f : 0.0f);
  }
  return neg ? 4096.0f - q : q;
}

__device__ __forceinline__ float clip_z(float z) {
  return fminf(fmaxf(z, -kZSat), kZSat);
}

// int_sigmoid as a table: tab[i] = int_sigmoid(i) for i = 0..Z_SAT, filled
// by the block from int_sigmoid itself (fill_sigmoid_table); then for
// every integer z (all z of the evaluator are integers: integer IntParams,
// exact products, sums rounded only above 2^24 where floats are integers)
// sigmoid_from_table(z) == int_sigmoid(z), by int_sigmoid's own symmetry
// branch (z < 0 -> 4096 - s(|z|)) and its clamp to Z_SAT. A NaN z indexes
// the last entry (fminf drops NaN), so a table read never leaves it.
constexpr int kSigmoidTable = 16384;

__device__ __forceinline__ void fill_sigmoid_table(uint16_t* tab, int tid,
                                                   int nthreads) {
  for (int i = tid; i < kSigmoidTable; i += nthreads)
    tab[i] = static_cast<uint16_t>(int_sigmoid(static_cast<float>(i)));
}

__device__ __forceinline__ float sigmoid_from_table(float z,
                                                    const uint16_t* tab) {
  const float za = fminf(fabsf(z), kZSat);
  const float q = static_cast<float>(tab[static_cast<int>(za)]);
  return z < 0.0f ? 4096.0f - q : q;
}

// one component's term of mixture_cdf_q14 from its sigmoid value s:
// floor(p_q * s / 2^10); the K terms are summed in k order from 0 and
// clamped by cdf_clamp
__device__ __forceinline__ float cdf_term(float p, float s) {
  return fdiv2<10>(p * s);
}

// cdf_term with the sigmoid read from the block's table
__device__ __forceinline__ float table_term(const uint16_t* tab, float p,
                                            float z) {
  return cdf_term(p, sigmoid_from_table(z, tab));
}

__device__ __forceinline__ float cdf_clamp(float acc) {
  return fminf(fmaxf(acc, 0.0f), kCOne);
}

// edge z's (already clipped): bn z = e a_q - v, coarse z = e sc_q - v,
// fine z = z_a + e a_q with z_a = a_sym sc_q - v
__device__ __forceinline__ float bn_z(float e, float a, float v) {
  return clip_z(e * a - v);
}

__device__ __forceinline__ float coarse_z(float e, float sc, float v) {
  return clip_z(e * sc - v);
}

__device__ __forceinline__ float fine_za(float a_sym, float sc, float v) {
  return a_sym * sc - v;
}

__device__ __forceinline__ float fine_z(float z_a, float e, float a) {
  return clip_z(z_a + e * a);
}

// Q(l) of the +2l table spec from a Q14 CDF c, exact-int f32 in [0, 65536]
__device__ __forceinline__ float quantize_edge(float c, float l, int L) {
  const int M = 65536 - 2 * L;
  const float m_hi = static_cast<float>(M >> 7);
  const float m_lo = static_cast<float>(M & 127);
  float q = fdiv2<7>(c * m_hi) + fdiv2<14>(c * m_lo) + 2.0f * l;
  q = l <= 0.0f ? 0.0f : q;
  return l >= static_cast<float>(L) ? 65536.0f : q;
}

// exact floor(a / d) for integer-valued f32, 0 <= a < 2^28, 1 <= d <= 2^14
__device__ __forceinline__ float floor_div(float a, float d) {
  float q = floorf(a / d);
  const float d_hi = fdiv2<7>(d);
  const float d_lo = d - d_hi * 128.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float rem = (a - q * d_hi * 128.0f) - q * d_lo;
    q = q + (rem >= d ? 1.0f : 0.0f) - (rem < 0.0f ? 1.0f : 0.0f);
  }
  return q;
}

// v' = clip(v + sum_j w_j sym_j) for RGB channel c; s0, s1 are the known
// symbols of channels 0 and 1, w0..w2 the lambda slots 0..2
__device__ __forceinline__ float apply_lambda_chain(float v, int c, float w0,
                                                    float w1, float w2,
                                                    float s0, float s1) {
  if (c == 1) {
    v = v + w0 * s0;
  } else if (c == 2) {
    v = (v + w1 * s0) + w2 * s1;
  } else {
    return v;
  }
  return fminf(fmaxf(v, -kVClamp), kVClamp);
}

// tail-absorbed conditional bounds of coarse bin a_sym: lo and the
// denominator d, from the clamped CDFs at the bin's two edges
__device__ __forceinline__ void cond_bounds(float a_sym, float c_lo,
                                            float c_hi, float* lo, float* d) {
  *lo = a_sym == 0.0f ? 0.0f : c_lo;
  const float hi = a_sym == static_cast<float>(kCoarseBins - 1) ? kCOne : c_hi;
  *d = fmaxf(hi - *lo, 1.0f);
}

// conditional renormalisation floor((c_e - lo) * C_ONE / d), exact
__device__ __forceinline__ float cond_norm(float c_e, float lo, float d) {
  const float num = fmaxf(c_e - lo, 0.0f) * kCOne;
  return fminf(fmaxf(floor_div(num, d), 0.0f), kCOne);
}

}  // namespace l3c
