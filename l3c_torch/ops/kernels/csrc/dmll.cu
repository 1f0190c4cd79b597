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
// in the plain version's order of operations within a term (the products
// and sums as written, softplus as max(z, 0) + log1p(exp(-|z|)), the
// sigmoid as 1 / (1 + exp(-z)), expf / log1pf / logf and IEEE divisions;
// the file is built with -fmad=false). Every sum over k runs k ascending
// from 0, as a loop over k in one thread adds them, so the results do not
// depend on how the threads share a pixel's components: they are those of
// a kernel that runs one thread a pixel, bit for bit.
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
// grad_l in l's layout.
//
// What bounds it on Hopper: issuing its math. Per pixel it reads Kp
// floats (120 or 150) and writes C (forward) or Kp + C (backward), which
// the card moves in 40-50 % of the kernel's time; the accurate expf /
// logf / log1pf and IEEE divisions of K terms a (pixel, channel), which
// the order of operations above pins, take the rest (measured with
// profile_k6.py: without the tile's load the kernel keeps 80-90 % of its
// time). A kernel that walked a pixel's C K
// terms in one thread was held by latency instead: 16,384 to 65,536
// threads at the bottleneck scales, 8-16 warps an SM at scale 0. So:
//  - A block owns a tile of kTile consecutive pixels of one image (tiles
//    never straddle two images: an image's last tile is ragged). Its Kp
//    plane slices reach shared memory at once, by 16-byte cp.async (4-byte
//    copies where HW % 4 != 0, where the tile is ragged, or where a base
//    is off a 16-byte boundary), as do its x and g.
//  - Threads map to (pixel, channel, sub): kSplit lanes share a pixel's
//    channel, lane s taking the components k = s, s + kSplit, ...; a
//    warp holds 32 / kSplit pixels of one channel. So a thread's chain is
//    K / kSplit terms (one thread walked C K before), and the reductions
//    over k (the logits' max and sum, the weighted max and sum, sum_k r_k,
//    the grad_x sums) are warp shuffles inside the kSplit lanes, which
//    leave the same value in every lane of the group: a max by a
//    butterfly, a sum by gathering the group's values into every lane and
//    adding them k ascending.
//  - Shared memory rows (one plane slice each) are swizzled: a warp's
//    lanes read kSplit neighbouring rows at once, and the row's parity
//    (mod kSplit) moves its columns onto other banks. 16-byte pieces stay
//    whole, so copies in and out are 16 bytes a thread.
//  - The backward keeps the forward's intermediates (d lp / d d, d lp / d
//    ls, the lambda sigmoids) in the shared-memory slots of the values
//    they came from, and writes grad_l over them: every slot belongs to
//    one thread (the lambda planes of channel 0's mean to channel 1, those
//    of channels 0 and 1's to channel 2). The block then copies the tile
//    out as rows of the planes, 16 bytes a thread.
//  - The RGB coupling (channels 1 and 2's terms reach grad_x of channels
//    0 and 1) is summed in shared memory in a fixed order, (own + from
//    channel 1) + from channel 2, and stored once per pixel.
//  - A block takes at most kMaxC channels. Bottleneck channels do not
//    interact, so C > kMaxC runs one launch a group of kMaxC channels
//    (the last one smaller), each block staging its group's planes only;
//    C <= kMaxC is one launch of the whole, as before.
//  - The tile and a lane's registers hold at most kMaxK components. For
//    K > kMaxK (up to 255, the JAX package's u8 component rank) the
//    launchers run dmll_generic: one thread a pixel, its channels in
//    order, every value read where it lies and each term evaluated again
//    in each pass that needs it; the same expressions and sums over k
//    ascending. Not tuned.
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int kMaxK = 10;     // mixture components K of the tile
constexpr int kMaxKGeneric = 255;   // of dmll_generic
constexpr int kMaxC = 8;      // channels a block (threads: 32 C kSplit)
constexpr int kGenericThreads = 128;
constexpr int kTile = 32;     // pixels a block
constexpr int kSplit = 2;     // lanes a (pixel, channel)
constexpr int kSlots = (kMaxK + kSplit - 1) / kSplit;   // components a lane
constexpr int kGroupPx = 32 / kSplit;                  // pixels a warp
constexpr float kLogScalesMin = -7.0f;
constexpr float kDeltaMin = 1e-12f;

struct DmllArgs {
  const float* l;     // (N, Kp, HW)
  const float* x;     // (n, C)
  const float* g;     // (n, C) upstream gradient; backward only
  float* nll;         // (n, C); forward only
  float *gl, *gx;     // (N, Kp, HW), (n, C); backward only
  int HW, C, K, tiles;   // tiles: a image's
  int cg0, Cg;           // this launch's channels [cg0, cg0 + Cg)
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

// over the kSplit lanes of a (pixel, channel): every lane gets the result
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sum_k v_k over the K components, k ascending from 0.0f as one thread
// summed them before: lane s of the group holds v_k, k = s + kSplit j, in
// v[j]; every lane gathers the group's values (lane s ^ o's by a shuffle)
// and adds them in that order
__device__ __forceinline__ float ordered_sum(const float (&v)[kSlots], int K,
                                             int s) {
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    float got[kSplit];                  // got[o]: lane s ^ o's v[j]
    got[0] = v[j];
#pragma unroll
    for (int o = 1; o < kSplit; ++o)
      got[o] = __shfl_xor_sync(0xffffffffu, v[j], o);
#pragma unroll
    for (int t = 0; t < kSplit; ++t) {  // component kSplit j + t
      float x = got[0];
#pragma unroll
      for (int o = 1; o < kSplit; ++o)
        if ((s ^ o) == t) x = got[o];
      if (kSplit * j + t < K) sum = sum + x;
    }
  }
  return sum;
}

// where column col of row r lies in the tile (kTile floats a row): rows
// read together differ in r mod kSplit, which moves them by multiples of
// a warp's kGroupPx columns onto other banks
__device__ __forceinline__ int slot(int r, int col) {
  return r * kTile + (col ^ ((r & (kSplit - 1)) * kGroupPx));
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

// the plane of tile row r: a group of channels holds rg = Cg K rows of
// each parameter group, which lie skip = (C - Cg) K planes apart
struct Rows {
  int rg, skip;
  __device__ __forceinline__ size_t operator()(int r) const {
    return static_cast<size_t>(skip ? r + (r / rg) * skip : r);
  }
};

// the tile's columns 0..n_px-1 of every plane: 16-byte pieces where the
// planes' rows and g are 16-byte aligned, else 4-byte copies
__device__ __forceinline__ void load_tile(float* tile, const float* g,
                                          int Kp, int HW, int n_px,
                                          bool vec, Rows row) {
  const int n4 = vec ? n_px >> 2 : 0;
  for (int i = threadIdx.x; i < Kp * n4; i += blockDim.x) {
    const int r = i / n4, q = 4 * (i - r * n4);
    ptx::cp_async16(tile + slot(r, q), g + row(r) * HW + q);
  }
  const int rest = n_px - 4 * n4;
  for (int i = threadIdx.x; i < Kp * rest; i += blockDim.x) {
    const int r = i / rest, q = 4 * n4 + (i - r * rest);
    ptx::cp_async4(tile + slot(r, q), g + row(r) * HW + q);
  }
}

// the tile back to the planes, as load_tile reads them
__device__ __forceinline__ void store_tile(float* g, const float* tile,
                                           int Kp, int HW, int n_px,
                                           bool vec, Rows row) {
  const int n4 = vec ? n_px >> 2 : 0;
  for (int i = threadIdx.x; i < Kp * n4; i += blockDim.x) {
    const int r = i / n4, q = 4 * (i - r * n4);
    *reinterpret_cast<float4*>(g + row(r) * HW + q) =
        *reinterpret_cast<const float4*>(tile + slot(r, q));
  }
  const int rest = n_px - 4 * n4;
  for (int i = threadIdx.x; i < Kp * rest; i += blockDim.x) {
    const int r = i / rest, q = 4 * n4 + (i - r * rest);
    g[row(r) * HW + q] = tile[slot(r, q)];
  }
}

// a group's (pixel, channel) values of an (n, C) array: one run where the
// group is every channel, else Cg of every C
__device__ __forceinline__ void load_group(float* s, const float* g,
                                           int n_px, int C, int cg0,
                                           int Cg) {
  if (Cg == C) {
    load_run(s, g, n_px * C);
    return;
  }
  for (int i = threadIdx.x; i < n_px * Cg; i += blockDim.x) {
    const int q = i / Cg;
    ptx::cp_async4(s + i, g + static_cast<size_t>(q) * C + cg0 + (i - q * Cg));
  }
}

// shared memory a block uses: the tile, then x, then (backward) g and the
// grad_x parts: a pixel's own channels, and channel 0's from channels 1
// and 2 and channel 1's from channel 2
int smem_floats(int Kp, int C, bool grad) {
  return Kp * kTile + kTile * C * (grad ? 3 : 1) + (grad ? 3 * kTile : 0);
}

template <bool GRAD, bool LAM>
__global__ void __launch_bounds__(32 * kMaxC * kSplit)
    dmll_kernel(DmllArgs A) {
  extern __shared__ __align__(16) float smem[];
  const int C = A.C, K = A.K, HW = A.HW, cg0 = A.cg0, Cg = A.Cg;
  const int groups = LAM ? 4 : 3;
  const int Kp = groups * Cg * K;      // the tile's planes
  const Rows row{Cg * K, (C - Cg) * K};
  const int b = blockIdx.x / A.tiles;
  const int p0 = (blockIdx.x - b * A.tiles) * kTile;
  const int n_px = min(kTile, HW - p0);
  const size_t pix0 = static_cast<size_t>(b) * HW + p0;
  const size_t base = (static_cast<size_t>(b) * groups * C + cg0) * K * HW +
                      p0;
  const bool vec = (HW & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(A.l) |
                     reinterpret_cast<uintptr_t>(GRAD ? A.gl : A.l)) &
                    15) == 0;
  float* tile = smem;
  float* xs = tile + Kp * kTile;
  float* gs = xs + kTile * Cg;
  float* own = gs + kTile * Cg;     // (pixel, channel)
  float* lam = own + kTile * Cg;    // [3][pixel]: 0 <- 1, 0 <- 2, 1 <- 2

  load_tile(tile, A.l + base, Kp, HW, n_px, vec, row);
  load_group(xs, A.x + pix0 * C, n_px, C, cg0, Cg);
  if (GRAD) load_group(gs, A.g + pix0 * C, n_px, C, cg0, Cg);
  ptx::cp_async_wait_all();
  __syncthreads();

  // this thread's (pixel, channel, sub); the lanes of a ragged tile's
  // missing pixels run on their columns' stale values and write nothing
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = warp / kSplit;
  const int p = (warp - c * kSplit) * kGroupPx + lane / kSplit;
  const int s = lane & (kSplit - 1);
  const bool on = p < n_px;
  // this thread's component j of parameter group i, channel ch: plane
  // (i C + ch) K + s + kSplit j, whose rows all have the parity of j = 0,
  // so component j lies kSplit rows on from component j - 1
  auto plane = [&](int i, int ch) {
    return tile + slot((i * Cg + ch) * K + s, p);
  };
  constexpr int kNext = kSplit * kTile;
  float* const t_pi = plane(0, c);
  float* const t_mu = plane(1, c);
  float* const t_ls = plane(2, c);
  float* const t_l1 = LAM ? plane(3, c == 1 ? 0 : 1) : tile;  // lambda of x0
  float* const t_l2 = LAM ? plane(3, 2) : tile;               // lambda of x1
  const float xc = xs[p * Cg + c];
  const float x0 = LAM ? xs[p * Cg] : 0.0f;
  const float x1 = LAM ? xs[p * Cg + 1] : 0.0f;
  const int branch =
      xc < A.lower ? kLower : (xc > A.upper ? kUpper : kMiddle);

  // log_softmax of the pi logits: (logit - max) - log(sum exp(. - max))
  float logit[kSlots], e[kSlots] = {}, lw[kSlots] = {};
  float lmax = -INFINITY;
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    if (s + kSplit * j < K) {
      logit[j] = t_pi[kNext * j];
      lmax = fmaxf(lmax, logit[j]);
    }
  lmax = group_max(lmax);
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    if (s + kSplit * j < K) e[j] = expf(logit[j] - lmax);
  const float se = ordered_sum(e, K, s);
  const float lse_pi = logf(se);

  float wmax = -INFINITY;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (s + kSplit * j >= K) continue;
    const int q = kNext * j;
    float mean = t_mu[q], s1 = 0.0f, s2 = 0.0f;
    if (LAM && c == 1) {
      s1 = sigmoid(t_l1[q]);
      mean = mean + s1 * x0;
    } else if (LAM && c == 2) {
      s1 = sigmoid(t_l1[q]);
      s2 = sigmoid(t_l2[q]);
      mean = (mean + s1 * x0) + s2 * x1;
    }
    float dd, dls;
    const float lp = term<GRAD>(xc, mean, t_ls[q], branch, A.half_bin, &dd,
                                &dls);
    lw[j] = lp + ((logit[j] - lmax) - lse_pi);
    wmax = fmaxf(wmax, lw[j]);
    if (GRAD && on) {   // kept in the slots of the values they came from
      t_mu[q] = dd;
      t_ls[q] = dls;
      if (LAM && c >= 1) t_l1[q] = s1;
      if (LAM && c == 2) t_l2[q] = s2;
    }
  }
  wmax = group_max(wmax);
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    if (s + kSplit * j < K) lw[j] = expf(lw[j] - wmax);
  const float sw = ordered_sum(lw, K, s);
  if (!GRAD) {
    if (on && s == 0) A.nll[(pix0 + p) * C + cg0 + c] = -(logf(sw) + wmax);
    return;
  }

  const float gv = gs[p * Cg + c];
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    if (s + kSplit * j < K) lw[j] = lw[j] / sw;              // r_k
  const float sum_r = ordered_sum(lw, K, s);
  // per component: d nll / d (x - mean~), and the lambda terms' parts of
  // grad_x of channels 0 and 1
  float gd[kSlots] = {}, g0[kSlots] = {}, g1[kSlots] = {};
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (s + kSplit * j >= K) continue;
    const int q = kNext * j;
    const float pi = e[j] / se;
    const float r = lw[j];
    const float G = -(gv * r);                        // d nll / d lp_k
    gd[j] = G * t_mu[q];
    const float g_ls = G * t_ls[q];
    float gl1 = 0.0f, gl2 = 0.0f;
    if (LAM && c >= 1) {
      const float s1 = t_l1[q];
      gl1 = -gd[j] * x0 * (s1 * (1.0f - s1));
      g0[j] = -gd[j] * s1;
    }
    if (LAM && c == 2) {
      const float s2 = t_l2[q];
      gl2 = -gd[j] * x1 * (s2 * (1.0f - s2));
      g1[j] = -gd[j] * s2;
    }
    if (!on) continue;
    t_pi[q] = gv * (pi * sum_r - r);
    t_mu[q] = -gd[j];
    t_ls[q] = g_ls;
    if (LAM && c >= 1) t_l1[q] = gl1;
    if (LAM && c == 2) t_l2[q] = gl2;
  }
  // (every warp shuffles: channel 0's g0, g1 and channel 1's g1 are 0)
  const float gxc = ordered_sum(gd, K, s);
  const float gx0 = LAM ? ordered_sum(g0, K, s) : 0.0f;
  const float gx1 = LAM ? ordered_sum(g1, K, s) : 0.0f;
  if (on && s == 0) {
    own[p * Cg + c] = gxc;
    if (LAM && c == 1) lam[p] = gx0;
    if (LAM && c == 2) {
      lam[kTile + p] = gx0;
      lam[2 * kTile + p] = gx1;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_px * Cg; i += blockDim.x) {
    float v = own[i];
    const int q = i / Cg, ch = i - q * Cg;
    if (LAM) {
      if (ch == 0) v = (v + lam[q]) + lam[kTile + q];
      if (ch == 1) v = v + lam[2 * kTile + q];
    }
    A.gx[Cg == C ? pix0 * C + i : (pix0 + q) * C + cg0 + ch] = v;
  }
  store_tile(A.gl + base, tile, Kp, HW, n_px, vec, row);
}

// dmll_kernel's function for any K: thread i takes pixel i, its channels
// in order, reading l where it lies; each pass over k evaluates its terms
// again (the same values), the sums run k ascending
template <bool GRAD, bool LAM>
__global__ void __launch_bounds__(kGenericThreads)
    dmll_generic(DmllArgs A, int n) {
  const int i = blockIdx.x * kGenericThreads + threadIdx.x;
  if (i >= n) return;
  const int C = A.C, K = A.K, HW = A.HW;
  const int Kp = (LAM ? 4 : 3) * C * K;
  const int b = i / HW;
  const size_t base = static_cast<size_t>(b) * Kp * HW + (i - b * HW);
  // parameter group g, channel ch, component k of this pixel
  auto at = [&](int g, int ch, int k) {
    return base + static_cast<size_t>((g * C + ch) * K + k) * HW;
  };
  const float* xp = A.x + static_cast<size_t>(i) * C;
  const float x0 = LAM ? xp[0] : 0.0f, x1 = LAM ? xp[1] : 0.0f;
  float own[3] = {}, lam[3] = {};   // LAM: as dmll_kernel's shared arrays
  for (int c = 0; c < C; ++c) {
    const float xc = xp[c];
    const int branch =
        xc < A.lower ? kLower : (xc > A.upper ? kUpper : kMiddle);
    // component k's weighted log-probability (lp + log softmax), with
    // GRAD its derivatives and lambda sigmoids
    auto weighted = [&](int k, float lmax, float lse_pi, float* dd,
                        float* dls, float* s1, float* s2) {
      float mean = A.l[at(1, c, k)];
      *s1 = *s2 = 0.0f;
      if (LAM && c == 1) {
        *s1 = sigmoid(A.l[at(3, 0, k)]);
        mean = mean + *s1 * x0;
      } else if (LAM && c == 2) {
        *s1 = sigmoid(A.l[at(3, 1, k)]);
        *s2 = sigmoid(A.l[at(3, 2, k)]);
        mean = (mean + *s1 * x0) + *s2 * x1;
      }
      const float lp = term<GRAD>(xc, mean, A.l[at(2, c, k)], branch,
                                  A.half_bin, dd, dls);
      return lp + ((A.l[at(0, c, k)] - lmax) - lse_pi);
    };
    float lmax = -INFINITY;
    for (int k = 0; k < K; ++k) lmax = fmaxf(lmax, A.l[at(0, c, k)]);
    float se = 0.0f;
    for (int k = 0; k < K; ++k) se = se + expf(A.l[at(0, c, k)] - lmax);
    const float lse_pi = logf(se);
    float dd, dls, s1, s2, wmax = -INFINITY;
    for (int k = 0; k < K; ++k)
      wmax = fmaxf(wmax, weighted(k, lmax, lse_pi, &dd, &dls, &s1, &s2));
    float sw = 0.0f;
    for (int k = 0; k < K; ++k)
      sw = sw + expf(weighted(k, lmax, lse_pi, &dd, &dls, &s1, &s2) - wmax);
    if (!GRAD) {
      A.nll[static_cast<size_t>(i) * C + c] = -(logf(sw) + wmax);
      continue;
    }
    const float gv = A.g[static_cast<size_t>(i) * C + c];
    float sum_r = 0.0f;
    for (int k = 0; k < K; ++k)
      sum_r = sum_r +
              expf(weighted(k, lmax, lse_pi, &dd, &dls, &s1, &s2) - wmax) /
                  sw;
    float gxc = 0.0f, gx0 = 0.0f, gx1 = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float r =
          expf(weighted(k, lmax, lse_pi, &dd, &dls, &s1, &s2) - wmax) / sw;
      const float pi = expf(A.l[at(0, c, k)] - lmax) / se;
      const float G = -(gv * r);
      const float gd = G * dd;
      A.gl[at(0, c, k)] = gv * (pi * sum_r - r);
      A.gl[at(1, c, k)] = -gd;
      A.gl[at(2, c, k)] = G * dls;
      if (LAM && c >= 1) {
        A.gl[at(3, c == 1 ? 0 : 1, k)] = -gd * x0 * (s1 * (1.0f - s1));
        gx0 = gx0 + -gd * s1;
      }
      if (LAM && c == 2) {
        A.gl[at(3, 2, k)] = -gd * x1 * (s2 * (1.0f - s2));
        gx1 = gx1 + -gd * s2;
      }
      gxc = gxc + gd;
    }
    if (!LAM) {
      A.gx[static_cast<size_t>(i) * C + c] = gxc;
      continue;
    }
    own[c] = gxc;
    if (c == 1) lam[0] = gx0;
    if (c == 2) {
      lam[1] = gx0;
      lam[2] = gx1;
    }
  }
  if (GRAD && LAM) {
    float* gx = A.gx + static_cast<size_t>(i) * C;
    gx[0] = (own[0] + lam[0]) + lam[1];
    gx[1] = own[1] + lam[2];
    gx[2] = own[2];
  }
}

// K <= kMaxK: one launch a group of kMaxC channels; else dmll_generic
template <bool GRAD>
int launch(DmllArgs A, int N, bool lam, cudaStream_t stream) {
  if (A.K > kMaxK) {
    const int n = N * A.HW;
    const int blocks = (n + kGenericThreads - 1) / kGenericThreads;
    if (lam)
      dmll_generic<GRAD, true><<<blocks, kGenericThreads, 0, stream>>>(A, n);
    else
      dmll_generic<GRAD, false><<<blocks, kGenericThreads, 0, stream>>>(A, n);
    return static_cast<int>(cudaGetLastError());
  }
  for (A.cg0 = 0; A.cg0 < A.C; A.cg0 += kMaxC) {
    A.Cg = min(kMaxC, A.C - A.cg0);
    const int grid = N * A.tiles, threads = 32 * A.Cg * kSplit;
    const int Kp = (lam ? 4 : 3) * A.Cg * A.K;
    const size_t bytes = sizeof(float) * smem_floats(Kp, A.Cg, GRAD);
    if (lam)
      dmll_kernel<GRAD, true><<<grid, threads, bytes, stream>>>(A);
    else
      dmll_kernel<GRAD, false><<<grid, threads, bytes, stream>>>(A);
    const int e = static_cast<int>(cudaGetLastError());
    if (e != 0) return e;
  }
  return 0;
}

bool bad_shape(int N, int HW, int C, int K, int lam) {
  return K < 1 || K > kMaxKGeneric || C < 1 || N < 1 || HW < 1 ||
         (lam && C != 3) ||
         static_cast<long long>(N) * HW >= (1LL << 31);
}

DmllArgs args(const void* l, const void* x, const void* g, void* nll,
              void* gl, void* gx, int HW, int C, int K, float half_bin,
              float lower, float upper) {
  return DmllArgs{static_cast<const float*>(l), static_cast<const float*>(x),
                  static_cast<const float*>(g), static_cast<float*>(nll),
                  static_cast<float*>(gl), static_cast<float*>(gx), HW, C,
                  K, (HW + kTile - 1) / kTile, 0, C, half_bin, lower, upper};
}

}  // namespace

// l (N, Kp, H, W), x (N, H, W, C) f32 -> nll (N, H, W, C) f32
extern "C" int l3c_dmll_nll(const void* l, const void* x, void* nll, int N,
                            int HW, int C, int K, int lam, float half_bin,
                            float lower, float upper, void* stream) {
  if (bad_shape(N, HW, C, K, lam))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(args(l, x, nullptr, nll, nullptr, nullptr, HW, C, K,
                            half_bin, lower, upper),
                       N, lam != 0, static_cast<cudaStream_t>(stream));
}

// l, x as above, g (N, H, W, C) the gradient of nll -> grad_l in l's
// layout, grad_x (N, H, W, C)
extern "C" int l3c_dmll_nll_grad(const void* l, const void* x, const void* g,
                                 void* gl, void* gx, int N, int HW, int C,
                                 int K, int lam, float half_bin, float lower,
                                 float upper, void* stream) {
  if (bad_shape(N, HW, C, K, lam))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(args(l, x, g, nullptr, gl, gx, HW, C, K, half_bin,
                           lower, upper),
                      N, lam != 0, static_cast<cudaStream_t>(stream));
}
