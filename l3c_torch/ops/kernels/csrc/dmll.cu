// dmll_nll / dmll_nll_grad (K6): the discretized logistic mixture's
// per-element negative log-likelihood, and its gradient.
//
// Replaces l3c_tpu/models/dmll.py:126 nll together with the VJP that
// jax.value_and_grad builds for it, both of which XLA fuses into the
// jitted train step (l3c_tpu/train/trainer.py:113-117). The plain PyTorch
// version is l3c_torch/models/dmll.py nll_plain, differentiated by
// autograd; the dispatch and the autograd.Function are dmll.nll.
//
// Per pixel and channel c, with K components (pi logits, means, raw
// log-scales; for the RGB scale also the lambda logits):
//   mean~  = mu (c = 0), mu + s(lam0) x0 (c = 1),
//            (mu + s(lam1) x0) + s(lam2) x1 (c = 2)      s = sigmoid
//   ls     = max(ls_raw, -7),  inv = exp(-ls),  d = x - mean~
//   p      = inv (d + b/2),    m = inv (d - b/2)
//   lp     = p - softplus(p)                 x < x_min + 0.001
//            -softplus(m)                    x > x_max - 0.001
//            log(max(s(p) - s(m), 1e-12))    otherwise
//   nll    = -logsumexp_k(lp_k + log_softmax_k(pi logits))
// in the plain version's order of operations (the products and sums as
// written, softplus as max(z, 0) + log1p(exp(-|z|)), the sigmoid as
// 1 / (1 + exp(-z)), expf / log1pf / logf and IEEE divisions; the file is
// built with -fmad=false).
//
// The gradient follows JAX's conventions: a branch passes the gradient of
// the branch it selects only; max(ls_raw, -7) and max(delta, 1e-12) pass
// all of it above the bound, none below and half at an exact tie (as
// jnp.maximum / jnp.clip and torch.maximum do). With r_k the softmax of
// the weighted log-probabilities and pi_k that of the logits,
// d nll / d logit_k = g (pi_k sum_j r_j - r_k), and d nll / d lp_k = -g r_k
// goes through the branch to p and m, from there to d and ls, and through
// the means to mu, the lambda logits and the conditioning channels of x.
// The gradient w.r.t. x is needed: at the bottleneck scales x is the
// straight-through bottleneck, whose gradient reaches the encoder.
//
// Layout: l (N, Kp, H, W) f32 as the classifier's convolution writes it,
// plane (i C + c) K + k for parameter group i (Kp = 4 C K for RGB, C = 3,
// else 3 C K); x, the upstream gradient g, nll and grad_x (N, H, W, C);
// grad_l in l's layout. One thread per pixel handles all C channels, so
// the lambda coupling of the RGB channels stays inside the thread; the
// threads of a warp run along neighbouring pixels, so every plane read or
// written is coalesced.
//
// What bounds it on Hopper: bytes. Per pixel it reads Kp floats (120 or
// 150) and writes C (forward) or Kp + C (backward), against ~8
// transcendentals per term in the forward and ~12 in the backward; each
// input byte is read once and no intermediate reaches device memory
// (autograd's plain version writes ~25 (N, H, W, C, K) tensors). The
// backward recomputes the forward per pixel rather than storing it.
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 10;     // mixture components K
constexpr int kThreads = 128;
constexpr float kLogScalesMin = -7.0f;
constexpr float kDeltaMin = 1e-12f;

struct DmllArgs {
  const float* l;     // (N, Kp, HW)
  const float* x;     // (n, C)
  const float* g;     // (n, C) upstream gradient; backward only
  float* nll;         // (n, C); forward only
  float *gl, *gx;     // (N, Kp, HW), (n, C); backward only
  int n, HW, C, K;    // n = N HW
  float half_bin, lower, upper;
};

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ float softplus(float z) {
  return fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)));
}

// half at an exact tie, as jnp.maximum's and torch.maximum's gradients
__device__ __forceinline__ float max_grad(float v, float bound) {
  return v > bound ? 1.0f : (v == bound ? 0.5f : 0.0f);
}

enum Branch { kLower = 0, kUpper = 1, kMiddle = 2 };

// One mixture term's log-probability and, with GRAD, its derivatives
// w.r.t. d = x - mean~ and ls_raw
template <bool GRAD>
__device__ __forceinline__ float term(float x, float mean, float ls_raw,
                                      int branch, float hb, float* d_d,
                                      float* d_ls) {
  const float ls = fmaxf(ls_raw, kLogScalesMin);
  const float d = x - mean;
  const float inv = expf(-ls);
  const float p = inv * (d + hb);
  const float m = inv * (d - hb);
  float lp, dp = 0.0f, dm = 0.0f;
  if (branch == kLower) {
    lp = p - softplus(p);
    if (GRAD) dp = sigmoid(-p);
  } else if (branch == kUpper) {
    lp = -softplus(m);
    if (GRAD) dm = -sigmoid(m);
  } else {
    const float sp = sigmoid(p), sm = sigmoid(m);
    const float delta = sp - sm;
    lp = logf(fmaxf(delta, kDeltaMin));
    if (GRAD) {
      const float s = max_grad(delta, kDeltaMin) / fmaxf(delta, kDeltaMin);
      dp = s * (sp * (1.0f - sp));
      dm = -(s * (sm * (1.0f - sm)));
    }
  }
  if (GRAD) {
    *d_d = inv * (dp + dm);
    const float d_inv = dp * (d + hb) + dm * (d - hb);
    *d_ls = -(inv * d_inv) * max_grad(ls_raw, kLogScalesMin);
  }
  return lp;
}

template <bool GRAD, bool LAM>
__global__ void __launch_bounds__(kThreads) dmll_kernel(DmllArgs A) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= A.n) return;
  const int C = A.C, K = A.K;
  const size_t plane = static_cast<size_t>(A.HW);
  const int b = pix / A.HW;
  const int groups = LAM ? 4 : 3;
  const size_t base = static_cast<size_t>(b) * groups * C * K * plane +
                      (pix - b * A.HW);
  // parameter group i of channel ch, component k
  auto at = [&](int i, int ch, int k) {
    return base + static_cast<size_t>((i * C + ch) * K + k) * plane;
  };
  const float* xp = A.x + static_cast<size_t>(pix) * C;
  const float x0 = xp[0], x1 = LAM ? xp[1] : 0.0f;

#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const float xc = xp[c];
    const int branch =
        xc < A.lower ? kLower : (xc > A.upper ? kUpper : kMiddle);
    // log_softmax of the pi logits: (logit - max) - log(sum exp(. - max))
    float logit[kMaxK];
    float lmax = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) {
        logit[k] = A.l[at(0, c, k)];
        lmax = fmaxf(lmax, logit[k]);
      }
    float se = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) se = se + expf(logit[k] - lmax);
    const float lse_pi = logf(se);

    float lw[kMaxK], dd[kMaxK], dls[kMaxK], s1[kMaxK], s2[kMaxK];
    float wmax = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k >= K) continue;
      float mean = A.l[at(1, c, k)];
      if (LAM && c == 1) {
        s1[k] = sigmoid(A.l[at(3, 0, k)]);
        mean = mean + s1[k] * x0;
      } else if (LAM && c == 2) {
        s1[k] = sigmoid(A.l[at(3, 1, k)]);
        s2[k] = sigmoid(A.l[at(3, 2, k)]);
        mean = (mean + s1[k] * x0) + s2[k] * x1;
      }
      const float lp = term<GRAD>(xc, mean, A.l[at(2, c, k)], branch,
                                  A.half_bin, &dd[k], &dls[k]);
      lw[k] = lp + ((logit[k] - lmax) - lse_pi);
      wmax = fmaxf(wmax, lw[k]);
    }
    float sw = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) sw = sw + expf(lw[k] - wmax);
    const size_t o = static_cast<size_t>(pix) * C + c;
    if (!GRAD) {
      A.nll[o] = -(logf(sw) + wmax);
      continue;
    }

    const float g = A.g[o];
    float r[kMaxK], sum_r = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) {
        r[k] = expf(lw[k] - wmax) / sw;
        sum_r = sum_r + r[k];
      }
    float gxc = 0.0f, gx0 = 0.0f, gx1 = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k >= K) continue;
      const float pi = expf(logit[k] - lmax) / se;
      A.gl[at(0, c, k)] = g * (pi * sum_r - r[k]);
      const float G = -(g * r[k]);          // d nll / d lp_k
      const float g_d = G * dd[k];           // d / d (x - mean~)
      gxc = gxc + g_d;
      A.gl[at(1, c, k)] = -g_d;
      A.gl[at(2, c, k)] = G * dls[k];
      if (LAM && c == 1) {
        A.gl[at(3, 0, k)] = -g_d * x0 * (s1[k] * (1.0f - s1[k]));
        gx0 = gx0 + -g_d * s1[k];
      } else if (LAM && c == 2) {
        A.gl[at(3, 1, k)] = -g_d * x0 * (s1[k] * (1.0f - s1[k]));
        A.gl[at(3, 2, k)] = -g_d * x1 * (s2[k] * (1.0f - s2[k]));
        gx0 = gx0 + -g_d * s1[k];
        gx1 = gx1 + -g_d * s2[k];
      }
    }
    // a thread owns its pixel's grad_x entries: channel c's own term is
    // written at step c, the lambda terms of later channels are added
    float* gxp = A.gx + static_cast<size_t>(pix) * C;
    gxp[c] = gxc;
    if (LAM && c >= 1) gxp[0] = gxp[0] + gx0;
    if (LAM && c == 2) gxp[1] = gxp[1] + gx1;
  }
}

template <bool GRAD>
int launch(const DmllArgs& A, bool lam, cudaStream_t stream) {
  const dim3 grid((A.n + kThreads - 1) / kThreads);
  if (lam)
    dmll_kernel<GRAD, true><<<grid, kThreads, 0, stream>>>(A);
  else
    dmll_kernel<GRAD, false><<<grid, kThreads, 0, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int N, int HW, int C, int K, int lam) {
  return K < 1 || K > kMaxK || C < 1 || N < 1 || HW < 1 ||
         (lam && C != 3) ||
         static_cast<long long>(N) * HW >= (1LL << 31);
}

}  // namespace

// l (N, Kp, H, W), x (N, H, W, C) f32 -> nll (N, H, W, C) f32
extern "C" int l3c_dmll_nll(const void* l, const void* x, void* nll, int N,
                            int HW, int C, int K, int lam, float half_bin,
                            float lower, float upper, void* stream) {
  if (bad_shape(N, HW, C, K, lam))
    return static_cast<int>(cudaErrorInvalidValue);
  DmllArgs A{static_cast<const float*>(l), static_cast<const float*>(x),
             nullptr, static_cast<float*>(nll), nullptr, nullptr,
             N * HW, HW, C, K, half_bin, lower, upper};
  return launch<false>(A, lam != 0, static_cast<cudaStream_t>(stream));
}

// l, x as above, g (N, H, W, C) the gradient of nll -> grad_l in l's
// layout, grad_x (N, H, W, C)
extern "C" int l3c_dmll_nll_grad(const void* l, const void* x, const void* g,
                                 void* gl, void* gx, int N, int HW, int C,
                                 int K, int lam, float half_bin, float lower,
                                 float upper, void* stream) {
  if (bad_shape(N, HW, C, K, lam))
    return static_cast<int>(cudaErrorInvalidValue);
  DmllArgs A{static_cast<const float*>(l), static_cast<const float*>(x),
             static_cast<const float*>(g), nullptr, static_cast<float*>(gl),
             static_cast<float*>(gx), N * HW, HW, C, K, half_bin, lower,
             upper};
  return launch<true>(A, lam != 0, static_cast<cudaStream_t>(stream));
}
