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
// What bounds them on Hopper: bytes. Per pixel the kernels read 3K floats
// and write L ints while doing ~8 L K flops, about 1 flop per byte, far
// below the card's ~20 flops/byte float32 ridge. The Pallas kernels kept
// the (tile, L) evaluation in VMEM; here it lives in registers: K1 runs
// one thread per (pixel, edge) with the K loop in registers; K2 one
// thread per pixel holding its 17 edge values, so the conditional
// normalisation needs no second pass. Accumulation is in fixed k order
// and the file is built with -fmad=false, so every product and sum is
// rounded where the plain version rounds it; the sigmoid is
// 1/(1+expf(-z)) (expf within 2 ulp), so rows agree with the plain
// version to within one quantization step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// pi, mu, inv_s: (P, K) f32; t: (L,) f32 -> out (P, L) int32
__global__ void mixture_cdf_q_kernel(const float* __restrict__ pi,
                                     const float* __restrict__ mu,
                                     const float* __restrict__ inv_s,
                                     const float* __restrict__ t,
                                     int32_t* __restrict__ out, int P, int K,
                                     int L, float M) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(P) * L) return;
  const int p = static_cast<int>(idx / L);
  const int e = static_cast<int>(idx % L);
  const float te = t[e];
  const size_t base = static_cast<size_t>(p) * K;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float z = (te - mu[base + k]) * inv_s[base + k];
    acc = acc + pi[base + k] * sigmoidf(z);
  }
  acc = fminf(fmaxf(acc, 0.0f), 1.0f);
  out[idx] = static_cast<int32_t>(floorf(acc * M));
}

constexpr int kFine = 16;

// pi, mu, inv_s: (P, K) f32; a: (P,) f32 coarse symbols -> out (P, 16)
__global__ void fine_cdf_q_kernel(const float* __restrict__ pi,
                                  const float* __restrict__ mu,
                                  const float* __restrict__ inv_s,
                                  const float* __restrict__ a,
                                  int32_t* __restrict__ out, int P, int K,
                                  float bw, float t0, int n_coarse, float M) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t base = static_cast<size_t>(p) * K;
  const float ap = a[p];
  const float b0 = ap * static_cast<float>(kFine);
  float c[kFine + 1];
#pragma unroll
  for (int e = 0; e <= kFine; ++e) c[e] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float m = mu[base + k], s = inv_s[base + k], w = pi[base + k];
#pragma unroll
    for (int e = 0; e <= kFine; ++e) {
      const float te = (b0 + static_cast<float>(e)) * bw + t0;
      c[e] = c[e] + w * sigmoidf((te - m) * s);
    }
  }
  // tail absorption: the first coarse bin opens at -inf (lo := 0), the
  // last closes at +inf (hi := 1)
  const float lo = ap == 0.0f ? 0.0f : c[0];
  const float hi = ap == static_cast<float>(n_coarse - 1) ? 1.0f : c[kFine];
  const float denom = fmaxf(hi - lo, 1e-9f);
  int32_t* o = out + static_cast<size_t>(p) * kFine;
#pragma unroll
  for (int e = 0; e < kFine; ++e) {
    const float cond = fminf(fmaxf((c[e] - lo) / denom, 0.0f), 1.0f);
    o[e] = static_cast<int32_t>(floorf(cond * M));
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int l3c_mixture_cdf_q(const void* pi, const void* mu,
                                 const void* inv_s, const void* t, void* out,
                                 int P, int K, int L, float M, void* stream) {
  const long long total = static_cast<long long>(P) * L;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  mixture_cdf_q_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pi), static_cast<const float*>(mu),
      static_cast<const float*>(inv_s), static_cast<const float*>(t),
      static_cast<int32_t*>(out), P, K, L, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int l3c_fine_cdf_q(const void* pi, const void* mu,
                              const void* inv_s, const void* a, void* out,
                              int P, int K, float bw, float t0, int n_coarse,
                              float M, void* stream) {
  const int blocks = (P + kThreads - 1) / kThreads;
  fine_cdf_q_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pi), static_cast<const float*>(mu),
      static_cast<const float*>(inv_s), static_cast<const float*>(a),
      static_cast<int32_t*>(out), P, K, bw, t0, n_coarse, M);
  return static_cast<int>(cudaGetLastError());
}
