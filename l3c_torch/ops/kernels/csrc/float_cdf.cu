// v7 float mixture-CDF rows of the two-level RGB coding stage.
//
// Replaces the two Pallas TPU kernels of tools/pallas_cdf.py:
//   mixture_cdf_q  <- tools/pallas_cdf.py:48 mixture_cdf_quantized
//                     (body _kernel :38)
//   fine_cdf_q     <- tools/pallas_cdf.py:120 fine_cdf_quantized
//                     (body _fine_kernel :93)
// The plain PyTorch versions are in l3c_torch/ops/float_cdf.py.
//
//   cdf(p, e) = sum_k pi[p,k] * sigmoid((t_e - mu[p,k]) * inv_s[p,k])
//   q(p, e)   = floor(clip(cdf, 0, 1) * M),  M = 65536 - 2L
// (the +2l / edge-0 finish of the v7 table spec stays in PyTorch, as it
// stayed in XLA beside the Pallas kernels).
//
// What bounds them on Hopper: operations, and among them the special-
// function unit. Per pixel the kernels read 3K floats and write L ints but
// evaluate L K sigmoids (K = 10, L = 16 or 17: 160-170 a pixel), each an
// exponential and a reciprocal: two special-function instructions, of
// which an SM executes 16 a clock against 128 ordinary float32 ones. The
// bytes (184-188 a pixel) would take about two thirds of that time. So
// the design spends as little else as it can on a term:
//  - A tile of pixels per block, one block a tile. A tile's parameters are
//    one contiguous run in each (P, K) array; the runs come into shared
//    memory by 16-byte cp.async, neighbouring threads on neighbouring
//    addresses (ragged last tiles and bases off a 16-byte boundary take
//    4-byte copies). The blocks an SM holds (8 of K1, 6 of K2) cover each
//    other's loads; a persistent grid whose blocks walked over the tiles
//    through two buffers measured 4-9% slower on the H100 and was dropped.
//  - A thread reads a component's three parameters from shared memory
//    once and uses them for all its edges, k ascending: K1 gives a thread
//    4 neighbouring edges of a pixel (a warp's parameter reads then touch 8
//    pixels at a stride of K words: no bank conflict at K = 10, the four
//    threads of a pixel broadcast), K2 a whole pixel, its 17 edge values
//    in registers, so the conditional normalisation needs no exchange
//    (reads at a stride of K words between lanes: 2-way conflicts at
//    K = 10, accepted: 3 reads stand against 17 sigmoids).
//  - Rows leave as 16-byte stores to neighbouring addresses: K1's four
//    edges are one int4 (scalar stores only where L is no multiple of 4);
//    K2 stages a tile's rows in shared memory, swizzled so that neither
//    the row-wise writes nor the flat reads conflict, and the block copies
//    the tile out flat.
//  - The sigmoid has two forms (add_term below). K1 takes the cheap one:
//    the two special-function instructions, an add and a fused
//    multiply-add, within ~4 ulp of a sigmoid; that moves a mixture sum by
//    ~0.02 of a quantization step, so K1 stays within one step of the
//    plain version whatever the parameters. K2 divides by its coarse bin's
//    mass, up to 100 times that error on the rows it is held on, where the
//    cheap form reached the limit of two steps on real scale-0 parameters;
//    so K2 takes the exact one, which rounds as the plain version's
//    expression does (fixed k order, -fmad=false) at ~17 instructions a
//    term.
//  - The tiles hold at most kMaxK components a pixel and K1 kMaxL edges.
//    Beyond them (the JAX package takes any K and L) the launchers run
//    generic variants with the same arithmetic, a term's parameters read
//    from global memory and no tile: one thread a pixel's group of 4
//    edges (K1) or a pixel (K2), results equal to the tiled kernels'
//    wherever both run. They are not tuned.
#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int kMaxK = 10;   // mixture components (MAX_K of the wrappers)
constexpr int kMaxL = 32;   // K1's edges
constexpr int kFine = 16;
constexpr int kExact = 0, kCheap = 1;   // the sigmoid's forms

// acc + w sigmoid(z) in the two forms, z = (t - mu) s. kExact: the plain
// version's 1 / (1 + exp(-z)) with expf and, for the division, rcp.approx
// refined by one Newton step in fused arithmetic. The IEEE division is
// avoided because x = inf or x >= 2^126 sends it through a subroutine;
// that this was the cost of the kernels before is a hypothesis, not a
// measurement. z is held above -55 so that x stays below 2^80, which
// changes a sigmoid below 1.3e-24 and no sum that quantizes above 0. The
// rows equalled the plain version's on every entry run on the H100 (three
// channels of 2,097,152 pixels, chip_smoke.py); the refinement is not
// proven to round correctly. kCheap: s already multiplied by -log2(e):
// two special-function instructions, an add and a fused multiply-add.
template <int FORM>
__device__ __forceinline__ float add_term(float acc, float w, float z) {
  if (FORM == kExact) {
    const float x = 1.0f + expf(-fmaxf(z, -55.0f));
    const float r = ptx::rcp_approx(x);
    return acc + w * fmaf(r, fmaf(-x, r, 1.0f), r);
  }
  return fmaf(w, ptx::rcp_approx(1.0f + ptx::ex2_approx(z)), acc);
}

// acc[e] = sum_k pi[k] sigmoid((t[e] - mu[k]) inv_s[k]), k ascending; the
// pixel's K parameters lie in shared memory and are read once each
template <int FORM, int E>
__device__ __forceinline__ void mixture(const float* pi, const float* mu,
                                        const float* inv_s, int K,
                                        const float (&t)[E], float (&acc)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float w = pi[k], m = mu[k];
    const float s =
        FORM == kExact ? inv_s[k] : inv_s[k] * -1.4426950408889634f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] = add_term<FORM>(acc[e], w, (t[e] - m) * s);
  }
}

__device__ __forceinline__ int32_t quantize(float c, float M) {
  return static_cast<int32_t>(floorf(fminf(fmaxf(c, 0.0f), 1.0f) * M));
}

// n floats g -> s by all threads of the block, asynchronously: 16 bytes a
// copy where g is 16-byte aligned (s is), the rest 4 bytes a copy
__device__ __forceinline__ void load_run(float* s, const float* g, int n) {
  const int n4 = (reinterpret_cast<uintptr_t>(g) & 15) == 0 ? n >> 2 : 0;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    ptx::cp_async16(s + 4 * i, g + 4 * i);
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    ptx::cp_async4(s + i, g + i);
}

// a tile's parameters: n_px pixels from pixel p0 on, into par[0..2]
template <int TP>
__device__ __forceinline__ void load_params(float (*par)[TP * kMaxK],
                                            const float* pi, const float* mu,
                                            const float* inv_s, size_t p0,
                                            int n_px, int K) {
  load_run(par[0], pi + p0 * K, n_px * K);
  load_run(par[1], mu + p0 * K, n_px * K);
  load_run(par[2], inv_s + p0 * K, n_px * K);
}

constexpr int kTile1 = 64;      // K1: pixels a tile
constexpr int kThreads1 = 256;  // = kTile1 x 4 groups of 4 edges at L = 16

// pi, mu, inv_s: (P, K) f32; t: (L,) f32 -> out (P, L) int32
__global__ void __launch_bounds__(kThreads1)
    mixture_cdf_q_kernel(const float* __restrict__ pi,
                         const float* __restrict__ mu,
                         const float* __restrict__ inv_s,
                         const float* __restrict__ t,
                         int32_t* __restrict__ out, int P, int K, int L,
                         float M) {
  __shared__ __align__(16) float par[3][kTile1 * kMaxK];
  __shared__ __align__(16) float ts[kMaxL];
  const size_t p0 = static_cast<size_t>(blockIdx.x) * kTile1;
  const int n_px = min(kTile1, P - static_cast<int>(blockIdx.x) * kTile1);
  const int groups = (L + 3) >> 2;       // of 4 edges, the last padded
  const bool vec = (L & 3) == 0;
  const int tid = threadIdx.x;
  if (tid >= L && tid < kMaxL) ts[tid] = 0.0f;   // the last group's padding
  load_run(ts, t, L);
  load_params<kTile1>(par, pi, mu, inv_s, p0, n_px, K);
  ptx::cp_async_wait_all();
  __syncthreads();
  for (int i = tid; i < n_px * groups; i += blockDim.x) {
    const int p = i / groups, e0 = 4 * (i - p * groups);
    float te[4], c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) te[j] = ts[e0 + j];
    mixture<kCheap, 4>(par[0] + p * K, par[1] + p * K, par[2] + p * K, K, te,
                       c);
    int32_t* o = out + (p0 + p) * L + e0;
    if (vec) {
      *reinterpret_cast<int4*>(o) =
          make_int4(quantize(c[0], M), quantize(c[1], M), quantize(c[2], M),
                    quantize(c[3], M));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e0 + j < L) o[j] = quantize(c[j], M);
    }
  }
}

constexpr int kTile2 = 128;     // K2: pixels a tile, one thread each

// where the 16-byte piece `slot` of a tile's staged rows (4 pieces a row)
// lies: a warp writes piece j of 32 rows and reads 32 neighbouring pieces;
// the exclusive-or spreads both over all banks
__device__ __forceinline__ int swizzle(int slot) {
  return slot ^ ((slot >> 3) & 3);
}

// pi, mu, inv_s: (P, K) f32; a: (P,) f32 coarse symbols -> out (P, 16)
__global__ void __launch_bounds__(kTile2)
    fine_cdf_q_kernel(const float* __restrict__ pi,
                      const float* __restrict__ mu,
                      const float* __restrict__ inv_s,
                      const float* __restrict__ a, int32_t* __restrict__ out,
                      int P, int K, float bw, float t0, int n_coarse,
                      float M) {
  __shared__ __align__(16) float par[3][kTile2 * kMaxK];
  __shared__ __align__(16) float as[kTile2];
  __shared__ __align__(16) int4 rows[kTile2 * kFine / 4];
  const size_t p0 = static_cast<size_t>(blockIdx.x) * kTile2;
  const int n_px = min(kTile2, P - static_cast<int>(blockIdx.x) * kTile2);
  load_params<kTile2>(par, pi, mu, inv_s, p0, n_px, K);
  load_run(as, a + p0, n_px);
  ptx::cp_async_wait_all();
  __syncthreads();
  const int p = threadIdx.x;
  if (p < n_px) {
    const float ap = as[p];
    const float b0 = ap * static_cast<float>(kFine);
    float te[kFine + 1], c[kFine + 1];
#pragma unroll
    for (int e = 0; e <= kFine; ++e)
      te[e] = (b0 + static_cast<float>(e)) * bw + t0;
    mixture<kExact, kFine + 1>(par[0] + p * K, par[1] + p * K, par[2] + p * K,
                               K, te, c);
    // tail absorption: the first coarse bin opens at -inf (lo := 0), the
    // last closes at +inf (hi := 1)
    const float lo = ap == 0.0f ? 0.0f : c[0];
    const float hi =
        ap == static_cast<float>(n_coarse - 1) ? 1.0f : c[kFine];
    const float denom = fmaxf(hi - lo, 1e-9f);
    int32_t q[kFine];
#pragma unroll
    for (int e = 0; e < kFine; ++e) q[e] = quantize((c[e] - lo) / denom, M);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      rows[swizzle(4 * p + j)] =
          make_int4(q[4 * j], q[4 * j + 1], q[4 * j + 2], q[4 * j + 3]);
  }
  __syncthreads();
  int4* o = reinterpret_cast<int4*>(out + p0 * kFine);
  for (int i = threadIdx.x; i < 4 * n_px; i += blockDim.x)
    o[i] = rows[swizzle(i)];
}

// K1 for any K and L: one thread a (pixel, group of 4 edges), the
// parameters and edges read where they lie
__global__ void __launch_bounds__(kThreads1)
    mixture_cdf_q_generic(const float* __restrict__ pi,
                          const float* __restrict__ mu,
                          const float* __restrict__ inv_s,
                          const float* __restrict__ t,
                          int32_t* __restrict__ out, int P, int K, int L,
                          float M) {
  const int groups = (L + 3) >> 2;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(P) * groups) return;
  const size_t p = i / groups;
  const int e0 = 4 * static_cast<int>(i - p * groups);
  float te[4], c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) te[j] = e0 + j < L ? t[e0 + j] : 0.0f;
  mixture<kCheap, 4>(pi + p * K, mu + p * K, inv_s + p * K, K, te, c);
  int32_t* o = out + p * L + e0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (e0 + j < L) o[j] = quantize(c[j], M);
}

// K2 for any K: one thread a pixel, the parameters read where they lie
__global__ void __launch_bounds__(kTile2)
    fine_cdf_q_generic(const float* __restrict__ pi,
                       const float* __restrict__ mu,
                       const float* __restrict__ inv_s,
                       const float* __restrict__ a, int32_t* __restrict__ out,
                       int P, int K, float bw, float t0, int n_coarse,
                       float M) {
  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= static_cast<size_t>(P)) return;
  const float ap = a[p];
  const float b0 = ap * static_cast<float>(kFine);
  float te[kFine + 1], c[kFine + 1];
#pragma unroll
  for (int e = 0; e <= kFine; ++e)
    te[e] = (b0 + static_cast<float>(e)) * bw + t0;
  mixture<kExact, kFine + 1>(pi + p * K, mu + p * K, inv_s + p * K, K, te, c);
  const float lo = ap == 0.0f ? 0.0f : c[0];
  const float hi = ap == static_cast<float>(n_coarse - 1) ? 1.0f : c[kFine];
  const float denom = fmaxf(hi - lo, 1e-9f);
#pragma unroll
  for (int e = 0; e < kFine; ++e)
    out[p * kFine + e] = quantize((c[e] - lo) / denom, M);
}

template <class Kernel, class... Args>
int launch(Kernel kernel, int blocks, int threads, void* stream,
           Args... args) {
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int l3c_mixture_cdf_q(const void* pi, const void* mu,
                                 const void* inv_s, const void* t, void* out,
                                 int P, int K, int L, float M, void* stream) {
  if (P < 1 || K < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (K > kMaxK || L > kMaxL) {
    const long long n = static_cast<long long>(P) * ((L + 3) >> 2);
    return launch(mixture_cdf_q_generic,
                  static_cast<int>((n + kThreads1 - 1) / kThreads1),
                  kThreads1, stream, static_cast<const float*>(pi),
                  static_cast<const float*>(mu),
                  static_cast<const float*>(inv_s),
                  static_cast<const float*>(t), static_cast<int32_t*>(out),
                  P, K, L, M);
  }
  return launch(mixture_cdf_q_kernel, (P + kTile1 - 1) / kTile1, kThreads1,
                stream, static_cast<const float*>(pi),
                static_cast<const float*>(mu),
                static_cast<const float*>(inv_s),
                static_cast<const float*>(t), static_cast<int32_t*>(out), P,
                K, L, M);
}

extern "C" int l3c_fine_cdf_q(const void* pi, const void* mu,
                              const void* inv_s, const void* a, void* out,
                              int P, int K, float bw, float t0, int n_coarse,
                              float M, void* stream) {
  if (P < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(K > kMaxK ? fine_cdf_q_generic : fine_cdf_q_kernel,
                (P + kTile2 - 1) / kTile2, kTile2, stream,
                static_cast<const float*>(pi), static_cast<const float*>(mu),
                static_cast<const float*>(inv_s),
                static_cast<const float*>(a), static_cast<int32_t*>(out), P,
                K, bw, t0, n_coarse, M);
}
