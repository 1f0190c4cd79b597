// pack_int (K5): the classifier's logits -> the coder's IntParams.
//
// Replaces l3c_tpu/ops/int_coder.py:259 pack_int_params (with topk_rank
// :195 and sel_kmajor :234), which XLA lowers inside the JAX codec's
// per-scale get_P program (l3c_tpu/codec/bitcoding2.py:279). The plain
// PyTorch version is l3c_torch/ops/int_coder.py pack_int_params.
//
// It is the one FLOAT stage of the v8 coder: what it rounds to defines
// the file format on a device, and the header canary attests it. So the
// evaluation order is fixed here and does not depend on the launch
// geometry: per (pixel, channel) one thread, k ascending for the max and
// the sum of the softmax, one expf per value, IEEE divisions (the
// softmax's and the one by the bin width: true divisions as the plain
// version makes them, not products with a reciprocal), the sigmoid as
// 1 / (1 + expf(-x)); the file is built with -fmad=false, so every
// product and sum rounds where it is written. The top-k selection is
// comparisons only and equals the plain version's indices exactly.
//
// What bounds it on Hopper: bytes. The convolution writes l as NCHW
// (N, Kp, H, W) with channel (i C + c) K + k for parameter group i, which
// is pixel-minor per plane, so the kernel reads l where it lies: a thread
// reads the K planes of each of its groups (neighbouring threads on
// neighbouring pixels, coalesced) and writes K' planes per output,
// (C, K', n) with n = N H W minor, the layout the rANS kernels read. Per
// pixel that is Kp floats in and 4-5 C K' floats out against ~K^2
// compares and 2-3 K' transcendentals: each input byte is read once, no
// intermediate reaches device memory.
//
// The lambda slots (RGB scale): slot j conditions TARGET channel (1, 2, 2)
// and follows that channel's selection and a_hat, so the thread of
// channel 1 writes w slot 0 and the thread of channel 2 slots 1 and 2.
//
// The registers hold at most kMaxK components. Beyond them (up to 255,
// the JAX package's u8 component rank) the launcher runs a generic
// variant: the same thread mapping and expressions in the same order,
// the logits read where they lie each time they are needed and the
// selected components' indices kept in a local array. Not tuned.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 10;     // mixture components K
constexpr int kMaxKGeneric = 255;   // the generic variant's
constexpr int kThreads = 256;

// the plain version's constants (ops/int_coder.py, frozen by the format)
constexpr float kLogScalesMin = -7.0f;
constexpr float kAMin = 1.0f / 256, kAMax = 64.0f;
constexpr float kPiQ = 4096.0f;              // pi Q12
constexpr float kQ10 = 1024.0f;              // a, v, w Q10
constexpr float kScQ10 = 16.0f * 1024.0f;    // coarse edge step
constexpr float kVClamp = 16777216.0f;       // 2^24

struct PackArgs {
  const float* l;               // (N, Kp, HW)
  float *p, *a, *sc, *v, *w;    // (C, KS, n); w (3, KS, n) or null
  int n, HW, C, K, KS;          // n = N HW; KS = K' <= K
  float bw, t0;                 // bin width, lowest edge
};

// x[r] <- the value of the component whose rank is r (r < KS): the first
// such k, x[0] when there is none, as an argmax over (rank == r) gives
template <int KP>
__device__ __forceinline__ void select(float (&out)[KP],
                                       const float (&x)[kMaxK],
                                       const int (&rank)[kMaxK], int K,
                                       int KS, bool sel) {
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    if (r >= KS) continue;
    if (!sel) {
      out[r] = x[r];
      continue;
    }
    float s = x[0];
#pragma unroll
    for (int k = kMaxK - 1; k >= 0; --k)
      if (k < K && rank[k] == r) s = x[k];
    out[r] = s;
  }
}

__device__ __forceinline__ void load_group(float (&x)[kMaxK], const float* g,
                                           int K, size_t plane) {
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    if (k < K) x[k] = g[k * plane];
}

// KP: registers for the K' selected components (4 or 10); LAM: RGB scale
template <int KP, bool LAM>
__global__ void __launch_bounds__(kThreads) pack_int_kernel(PackArgs A) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= A.n) return;
  const int c = blockIdx.y;
  const int K = A.K, KS = A.KS;
  const bool sel = KS < K;
  const size_t plane = static_cast<size_t>(A.HW);
  const int b = pix / A.HW;
  const int groups = LAM ? 4 : 3;
  const float* img = A.l +
                     (static_cast<size_t>(b) * groups * A.C * K) * plane +
                     (pix - b * A.HW);
  // parameter group i of channel ch: K planes from (i C + ch) K
  auto group = [&](int i, int ch) {
    return img + static_cast<size_t>((i * A.C + ch) * K) * plane;
  };

  float x[kMaxK];
  int rank[kMaxK];
  load_group(x, group(0, c), K, plane);
  if (sel) {
    // rank_k = #components that beat k, ties to the lower index
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      int r = 0;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (j < K && k < K) r += x[k] == x[j] ? (j < k) : (x[j] > x[k]);
      rank[k] = r;
    }
  }

  // pi = softmax over the selected logits: exp(x - max) / sum
  float pl[KP], e[KP];
  select<KP>(pl, x, rank, K, KS, sel);
  float m = pl[0];
#pragma unroll
  for (int r = 1; r < KP; ++r)
    if (r < KS) m = fmaxf(m, pl[r]);
  float sum = 0.0f;
#pragma unroll
  for (int r = 0; r < KP; ++r)
    if (r < KS) {
      e[r] = expf(pl[r] - m);
      sum = sum + e[r];
    }

  float mu[KP], ls[KP], a_hat[KP];
  load_group(x, group(1, c), K, plane);
  select<KP>(mu, x, rank, K, KS, sel);
  load_group(x, group(2, c), K, plane);
  select<KP>(ls, x, rank, K, KS, sel);

  const size_t out0 = static_cast<size_t>(c) * KS * A.n + pix;
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    if (r >= KS) continue;
    const float pi = e[r] / sum;
    const float inv_s = expf(-fmaxf(ls[r], kLogScalesMin));
    a_hat[r] = fminf(fmaxf(inv_s * A.bw, kAMin), kAMax);
    const float m_hat = (mu[r] - A.t0) / A.bw;
    const float vq = rintf(m_hat * a_hat[r] * kQ10);
    const size_t o = out0 + static_cast<size_t>(r) * A.n;
    A.p[o] = rintf(pi * kPiQ);
    A.a[o] = rintf(a_hat[r] * kQ10);
    A.sc[o] = rintf(a_hat[r] * kScQ10);
    A.v[o] = fminf(fmaxf(vq, -kVClamp), kVClamp);
  }

  if (LAM && c > 0) {
    // w slot j = sigmoid(lam_j) * a_hat(target channel), target (1, 2, 2)
    for (int j = c == 1 ? 0 : 1; j < (c == 1 ? 1 : 3); ++j) {
      float lam[KP];
      load_group(x, group(3, j), K, plane);
      select<KP>(lam, x, rank, K, KS, sel);
#pragma unroll
      for (int r = 0; r < KP; ++r) {
        if (r >= KS) continue;
        const float s = 1.0f / (1.0f + expf(-lam[r]));
        A.w[(static_cast<size_t>(j) * KS + r) * A.n + pix] =
            rintf(s * a_hat[r] * kQ10);
      }
    }
  }
}

// pack_int_kernel's function for any K: component k's rank is counted
// when it is needed, and slot r takes the lowest k of rank r (k = 0 when
// there is none), as select does
template <bool LAM>
__global__ void __launch_bounds__(kThreads)
    pack_int_generic(PackArgs A) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= A.n) return;
  const int c = blockIdx.y;
  const int K = A.K, KS = A.KS;
  const bool sel = KS < K;
  const size_t plane = static_cast<size_t>(A.HW);
  const int b = pix / A.HW;
  const int groups = LAM ? 4 : 3;
  const float* img = A.l +
                     (static_cast<size_t>(b) * groups * A.C * K) * plane +
                     (pix - b * A.HW);
  auto at = [&](int i, int ch, int k) {
    return img[static_cast<size_t>((i * A.C + ch) * K + k) * plane];
  };
  uint8_t ks[kMaxKGeneric];       // slot r's component
  for (int r = 0; r < KS; ++r) ks[r] = sel ? 0 : r;
  if (sel) {
    for (int k = K - 1; k >= 0; --k) {
      const float xk = at(0, c, k);
      int r = 0;
      for (int j = 0; j < K; ++j) {
        const float xj = at(0, c, j);
        r += xk == xj ? (j < k) : (xj > xk);
      }
      if (r < KS) ks[r] = static_cast<uint8_t>(k);
    }
  }
  float m = at(0, c, ks[0]);
  for (int r = 1; r < KS; ++r) m = fmaxf(m, at(0, c, ks[r]));
  float sum = 0.0f;
  for (int r = 0; r < KS; ++r) sum = sum + expf(at(0, c, ks[r]) - m);
  const size_t out0 = static_cast<size_t>(c) * KS * A.n + pix;
  for (int r = 0; r < KS; ++r) {
    const int k = ks[r];
    const float pi = expf(at(0, c, k) - m) / sum;
    const float inv_s = expf(-fmaxf(at(2, c, k), kLogScalesMin));
    const float a_hat = fminf(fmaxf(inv_s * A.bw, kAMin), kAMax);
    const float m_hat = (at(1, c, k) - A.t0) / A.bw;
    const float vq = rintf(m_hat * a_hat * kQ10);
    const size_t o = out0 + static_cast<size_t>(r) * A.n;
    A.p[o] = rintf(pi * kPiQ);
    A.a[o] = rintf(a_hat * kQ10);
    A.sc[o] = rintf(a_hat * kScQ10);
    A.v[o] = fminf(fmaxf(vq, -kVClamp), kVClamp);
    if (LAM && c > 0) {
      for (int j = c == 1 ? 0 : 1; j < (c == 1 ? 1 : 3); ++j) {
        const float s = 1.0f / (1.0f + expf(-at(3, j, k)));
        A.w[(static_cast<size_t>(j) * KS + r) * A.n + pix] =
            rintf(s * a_hat * kQ10);
      }
    }
  }
}

template <bool LAM>
int launch_generic(const PackArgs& A, cudaStream_t stream) {
  const dim3 grid((A.n + kThreads - 1) / kThreads, A.C);
  pack_int_generic<LAM><<<grid, kThreads, 0, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

template <int KP, bool LAM>
int launch(const PackArgs& A, cudaStream_t stream) {
  const dim3 grid((A.n + kThreads - 1) / kThreads, A.C);
  pack_int_kernel<KP, LAM><<<grid, kThreads, 0, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// l (N, Kp, H, W) f32 NCHW, Kp = (lam ? 4 : 3) C K -> p, a, sc, v
// (C, KS, N HW) and, with lam (C = 3), w (3, KS, N HW); KS = K' <= K, the
// top-KS components by pi logit when KS < K
extern "C" int l3c_pack_int(const void* l, void* p, void* a, void* sc,
                            void* v, void* w, int N, int HW, int C, int K,
                            int KS, int lam, float bw, float t0,
                            void* stream) {
  if (K < 1 || K > kMaxKGeneric || KS < 1 || KS > K || C < 1 || N < 1 || HW < 1 ||
      (lam && (C != 3 || w == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PackArgs A{static_cast<const float*>(l), static_cast<float*>(p),
                   static_cast<float*>(a),       static_cast<float*>(sc),
                   static_cast<float*>(v),       static_cast<float*>(w),
                   N * HW, HW, C, K, KS, bw, t0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > kMaxK) return lam ? launch_generic<true>(A, s)
                            : launch_generic<false>(A, s);
  if (KS > 4)
    return lam ? launch<kMaxK, true>(A, s) : launch<kMaxK, false>(A, s);
  return lam ? launch<4, true>(A, s) : launch<4, false>(A, s);
}
