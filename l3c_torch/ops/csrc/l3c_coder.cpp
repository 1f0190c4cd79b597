// l3c_coder: host-side rANS entropy backend for l3c_tpu.
//
// TPU-native replacement for the reference's torchac C++/CUDA extension
// (/root/reference/src/torchac/torchac_backend/torchac.cpp + _kernel.cu).
// Design differences, deliberate:
//
//  * rANS (64-bit state, 16-bit probabilities, 32-bit word renorm) instead
//    of a bit-by-bit arithmetic coder: byte-oriented renormalization is
//    several times faster on the host CPU.
//  * CDFs are evaluated ON THE FLY from the logistic-mixture parameters
//    (pi, mu, inv_sigma, lambda) instead of materializing N x (L+1) uint16
//    tables: encode touches 2 CDF points per symbol and decode ~log2(L)
//    via galloping search from a model-predicted start, so the host does
//    ~25x less math for L=256 than the table approach AND the TPU->host
//    transfer shrinks from O(L) to O(K) floats per pixel.
//  * The RGB channel autoregression (mu~ shifted by lambda * decoded
//    channels, reference logistic_mixture.py:235-243) is applied here from
//    the decoded symbols, so a whole scale is coded in ONE host call with
//    zero per-channel TPU round-trips.
//  * Streams are chunked (independent sub-streams per channel) so future
//    multi-core hosts can encode/decode chunks in parallel without a
//    format change.
//
// Determinism contract: encoder and decoder call the exact same float32
// evaluation path (exp via a positive-coefficient polynomial, fused
// contraction disabled at build time), and the quantized CDF
//   CQ(l) = floor(min(cdf(t_l),1) * (65536 - L) + 0.5) + l
// is STRICTLY increasing in l by construction (every step of the evaluator
// is a monotone correctly-rounded IEEE op, plus the +l term), matching the
// no-zero-width-bin renorm of the reference CUDA kernel
// (torchac_kernel.cu:20-24) while being safe to evaluate pointwise.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

#if defined(__AVX2__) && defined(__FMA__) && !defined(L3C_FORCE_SCALAR)
#include <immintrin.h>
#define L3C_AVX2 1
#endif

// EVALUATOR SPEC (variant 1, recorded in the v1 header flags byte): the
// CDF is defined as the 8-LANE algorithm — components padded to a
// multiple of 8 with pi=0, per-lane partial sums with FMA accumulation,
// fixed-order tree reduction ((a0+a4)+(a2+a6)) + ((a1+a5)+(a3+a7)), and
// an FMA-Horner exp polynomial with inputs clamped to [-87, 87]. The
// scalar build implements the SAME algorithm with fmaf(), so bitstreams
// are identical across ISAs (decode rejects other variants).

// ---------------------------------------------------------------------------
// Deterministic float math
// ---------------------------------------------------------------------------

// exp(w) for w in [-87, 87], float32, deterministic and monotone.
// 2^f on [0,1) via the Taylor polynomial with positive coefficients
// (strictly increasing, p(1) < 2), scaled by an exact power of two.
static inline float exp_det(float w) {
    // Identical math to exp_det8 (one lane): clamp, FMA-Horner, 2^n.
    if (w > 87.0f) w = 87.0f;
    if (w < -87.0f) w = -87.0f;
    float t = w * 1.4426950408889634f;    // w * log2(e)
    float n = floorf(t);
    float f = t - n;                      // [0, 1)
    // ln2^k / k!, k = 7..1, FMA-Horner (matches the AVX2 build exactly)
    float p = 1.5252733804059840e-5f;
    p = fmaf(p, f, 1.5403530393381608e-4f);
    p = fmaf(p, f, 0.001333355814642844f);
    p = fmaf(p, f, 0.009618129107628477f);
    p = fmaf(p, f, 0.05550410866482158f);
    p = fmaf(p, f, 0.2402265069591007f);
    p = fmaf(p, f, 0.6931471805599453f);
    p = fmaf(p, f, 1.0f);
    int ni = (int)n;                      // in [-126, 126]
    union { uint32_t u; float fl; } sc;
    sc.u = (uint32_t)(ni + 127) << 23;    // exact 2^ni
    return p * sc.fl;
}

// sigmoid(z) = 1 / (1 + exp(-z)): single code path, monotone in z.
static inline float sigmoid_det(float z) {
    return 1.0f / (1.0f + exp_det(-z));
}

// ---------------------------------------------------------------------------
// Mixture CDF evaluation
// ---------------------------------------------------------------------------

// Mixture components with pi below this are skipped deterministically on
// both encode and decode (same inputs -> same decision); the truncated CDF
// stays monotone and the bitrate cost is < 1e-4 bpsp.
static const float PI_SKIP = 1e-5f;

struct PixelModel {
    // effective (lambda-adjusted) means; active components only.
    // Arrays are padded to a multiple of 8 with pi=0 components (which
    // contribute exactly 0.0f) so the AVX2 path needs no masking.
    alignas(32) float pi[40];
    alignas(32) float mu[40];
    alignas(32) float inv_s[40];
    int n_active;   // rounded up to 8 in the AVX2 build
    int s_hint;     // symbol index near the dominant component's mean
    float hint_mu;      // dominant component mean (for decode-side hints)
    float hint_scale;   // dominant component scale 1/inv_s
};

static inline void load_pixel_model(
    PixelModel* m, const float* pi, const float* mu, const float* inv_s,
    int K, float lam_shift_0, const float* lam0,
    float lam_shift_1, const float* lam1,
    float x_min, float inv_bw, int L) {
    int n = 0;
    float best_pi = -1.0f;
    float best_mu = 0.0f;
    float best_is = 1.0f;
    for (int k = 0; k < K; ++k) {
        float p = pi[k];
        float mk = mu[k];
        if (lam0) mk += lam0[k] * lam_shift_0;
        if (lam1) mk += lam1[k] * lam_shift_1;
        if (p > best_pi) { best_pi = p; best_mu = mk; best_is = inv_s[k]; }
        if (p < PI_SKIP) continue;
        m->pi[n] = p;
        m->mu[n] = mk;
        m->inv_s[n] = inv_s[k];
        ++n;
    }
    while (n & 7) {  // pad with zero-weight components (contribute 0.0f);
        m->pi[n] = 0.0f;   // both builds: the 8-lane spec requires it
        m->mu[n] = 0.0f;
        m->inv_s[n] = 0.0f;
        ++n;
    }
    m->n_active = n;
    m->hint_mu = best_mu;
    m->hint_scale = 1.0f / best_is;
    int hint = (int)floorf((best_mu - x_min) * inv_bw + 0.5f);
    if (hint < 0) hint = 0;
    if (hint > L - 1) hint = L - 1;
    m->s_hint = hint;
}

#ifdef L3C_AVX2
// 8-lane exp_det; same polynomial, same monotonicity argument. FMA is used
// explicitly (deterministic: this one code path serves encode AND decode).
static inline __m256 exp_det8(__m256 w) {
    w = _mm256_max_ps(w, _mm256_set1_ps(-87.0f));
    w = _mm256_min_ps(w, _mm256_set1_ps(87.0f));
    __m256 t = _mm256_mul_ps(w, _mm256_set1_ps(1.4426950408889634f));
    __m256 n = _mm256_floor_ps(t);
    __m256 f = _mm256_sub_ps(t, n);
    __m256 p = _mm256_set1_ps(1.5252733804059840e-5f);
    p = _mm256_fmadd_ps(p, f, _mm256_set1_ps(1.5403530393381608e-4f));
    p = _mm256_fmadd_ps(p, f, _mm256_set1_ps(0.001333355814642844f));
    p = _mm256_fmadd_ps(p, f, _mm256_set1_ps(0.009618129107628477f));
    p = _mm256_fmadd_ps(p, f, _mm256_set1_ps(0.05550410866482158f));
    p = _mm256_fmadd_ps(p, f, _mm256_set1_ps(0.2402265069591007f));
    p = _mm256_fmadd_ps(p, f, _mm256_set1_ps(0.6931471805599453f));
    p = _mm256_fmadd_ps(p, f, _mm256_set1_ps(1.0f));
    __m256i ni = _mm256_cvtps_epi32(n);  // exact: n is integral
    __m256i sc = _mm256_slli_epi32(
        _mm256_add_epi32(ni, _mm256_set1_epi32(127)), 23);
    return _mm256_mul_ps(p, _mm256_castsi256_ps(sc));
}
#endif

// Quantized CDF at bin edge l (l in [0, L]; l == L is the implicit top).
// t_l = l * bw + (x_min - bw/2); CQ strictly increasing in l; CQ(L) would
// be <= 65535 but the coder uses the implicit 65536 top for the last
// symbol (same convention as torchac.cpp:181,340).
static inline uint32_t cdf_q(const PixelModel* m, int l,
                             float t0, float bw, uint32_t M) {
    // Edge 0 is pinned to 0: symbol 0 absorbs the open lower tail
    // (DMLL expresses "x = x_min" by pushing mu below the range; the
    // mass below t_0 must belong to symbol 0, like the implicit 65536
    // top gives symbol L-1 the upper tail). Mirrors the TPU builders'
    // _quantize_rows pin; reference coding CDFs span [0,1] the same way.
    if (l == 0) return 0;
    float t = (float)l * bw + t0;
    float c;
#ifdef L3C_AVX2
    __m256 tv = _mm256_set1_ps(t);
    __m256 acc = _mm256_setzero_ps();
    __m256 one = _mm256_set1_ps(1.0f);
    for (int k = 0; k < m->n_active; k += 8) {
        __m256 mu = _mm256_load_ps(m->mu + k);
        __m256 is = _mm256_load_ps(m->inv_s + k);
        __m256 pi = _mm256_load_ps(m->pi + k);
        __m256 z = _mm256_mul_ps(_mm256_sub_ps(tv, mu), is);
        __m256 e = exp_det8(_mm256_sub_ps(_mm256_setzero_ps(), z));
        __m256 sig = _mm256_div_ps(one, _mm256_add_ps(one, e));
        acc = _mm256_fmadd_ps(pi, sig, acc);
    }
    // fixed-order horizontal reduction (monotone IEEE adds)
    __m128 lo = _mm256_castps256_ps128(acc);
    __m128 hi = _mm256_extractf128_ps(acc, 1);
    __m128 s4 = _mm_add_ps(lo, hi);
    __m128 s2 = _mm_add_ps(s4, _mm_movehl_ps(s4, s4));
    __m128 s1 = _mm_add_ss(s2, _mm_shuffle_ps(s2, s2, 1));
    c = _mm_cvtss_f32(s1);
#else
    // Scalar build: the SAME 8-lane algorithm, lane-by-lane with fmaf.
    float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int k = 0; k < m->n_active; k += 8) {
        for (int j = 0; j < 8; ++j) {
            float z = (t - m->mu[k + j]) * m->inv_s[k + j];
            float sig = 1.0f / (1.0f + exp_det(-z));
            acc[j] = fmaf(m->pi[k + j], sig, acc[j]);
        }
    }
    // fixed-order tree reduction, matching the AVX2 horizontal reduce:
    // s4[j] = acc[j] + acc[j+4]; s2[j] = s4[j] + s4[j+2]; c = s2[0]+s2[1]
    float s4_0 = acc[0] + acc[4], s4_1 = acc[1] + acc[5];
    float s4_2 = acc[2] + acc[6], s4_3 = acc[3] + acc[7];
    float s2_0 = s4_0 + s4_2, s2_1 = s4_1 + s4_3;
    c = s2_0 + s2_1;
#endif
    if (c > 1.0f) c = 1.0f;
    return (uint32_t)floorf(c * (float)M + 0.5f) + (uint32_t)l;
}

// ---------------------------------------------------------------------------
// rANS (64-bit state, 16-bit probabilities, 32-bit renorm)
// ---------------------------------------------------------------------------

static const uint64_t RANS_L = 1ull << 31;
static const int PROB_BITS = 16;
static const uint32_t PROB_SCALE = 1u << PROB_BITS;

struct RansEnc {
    uint64_t x;
    uint32_t* ptr;   // grows DOWN
    uint32_t* base;  // lower bound
};

static inline void rans_enc_init(RansEnc* r, uint32_t* end, uint32_t* base) {
    r->x = RANS_L;
    r->ptr = end;
    r->base = base;
}

static inline int rans_enc_put(RansEnc* r, uint32_t start, uint32_t freq) {
    uint64_t x = r->x;
    uint64_t x_max = ((RANS_L >> PROB_BITS) << 32) * freq;
    if (x >= x_max) {
        if (r->ptr <= r->base) return -1;
        *--r->ptr = (uint32_t)x;
        x >>= 32;
    }
    r->x = ((x / freq) << PROB_BITS) + (x % freq) + start;
    return 0;
}

static inline int rans_enc_flush(RansEnc* r) {
    if (r->ptr - r->base < 2) return -1;
    r->ptr -= 2;
    r->ptr[0] = (uint32_t)r->x;
    r->ptr[1] = (uint32_t)(r->x >> 32);
    return 0;
}

struct RansDec {
    uint64_t x;
    const uint32_t* ptr;
    const uint32_t* end;
};

static inline void rans_dec_init(RansDec* r, const uint32_t* p,
                                 const uint32_t* end) {
    r->x = ((uint64_t)p[1] << 32) | p[0];
    r->ptr = p + 2;
    r->end = end;
}

static inline uint32_t rans_dec_cf(const RansDec* r) {
    return (uint32_t)(r->x & (PROB_SCALE - 1));
}

static inline void rans_dec_advance(RansDec* r, uint32_t start,
                                    uint32_t freq) {
    uint64_t x = freq * (r->x >> PROB_BITS) + (r->x & (PROB_SCALE - 1))
                 - start;
    if (x < RANS_L && r->ptr < r->end) {
        x = (x << 32) | *r->ptr++;
    }
    r->x = x;
}

// ---------------------------------------------------------------------------
// Symbol search: largest s in [0, L-1] with CQ(s) <= cf.
// Gallops outward from the model hint (usually 1-4 CDF evaluations on a
// trained model), then binary-searches the bracket. Correct for any hint
// because CQ is strictly monotone.
// ---------------------------------------------------------------------------

static inline int find_symbol(const PixelModel* m, uint32_t cf,
                              float t0, float bw, uint32_t M, int L,
                              uint32_t* lo_out, uint32_t* hi_out) {
    int lo, hi;  // bracket: CQ(lo) <= cf, and hi==L-1 or CQ(hi+1) > cf test
    // Initial guess: invert the dominant component's logistic CDF at cf.
    // Hints need NOT be deterministic — any start yields the same symbol
    // because CQ is strictly monotone — so plain libm logf is fine here.
    float u = ((float)cf + 0.5f) * (1.0f / 65536.0f);
    if (u < 1e-6f) u = 1e-6f;
    if (u > 1.0f - 1e-6f) u = 1.0f - 1e-6f;
    float x_est = m->hint_mu + m->hint_scale * logf(u / (1.0f - u));
    int s0 = (int)floorf((x_est - (t0 + 0.5f * bw)) / bw + 0.5f);
    if (s0 < 0) s0 = 0;
    if (s0 > L - 1) s0 = L - 1;
    if (cdf_q(m, s0, t0, bw, M) <= cf) {
        lo = s0;
        hi = L - 1;
        int step = 1;
        while (lo + step <= L - 1) {
            if (cdf_q(m, lo + step, t0, bw, M) <= cf) {
                lo += step;
                step <<= 1;
            } else {
                hi = lo + step - 1;
                break;
            }
        }
    } else {
        hi = s0 - 1;
        lo = 0;
        int step = 1;
        while (hi - step >= 0) {
            if (cdf_q(m, hi - step, t0, bw, M) > cf) {
                hi -= step;
                step <<= 1;
            } else {
                lo = hi - step;
                break;
            }
        }
    }
    while (lo < hi) {  // invariant: CQ(lo) <= cf < CQ(hi+1)
        int mid = lo + (hi - lo + 1) / 2;
        if (cdf_q(m, mid, t0, bw, M) <= cf) lo = mid;
        else hi = mid - 1;
    }
    uint32_t c_lo = cdf_q(m, lo, t0, bw, M);
    uint32_t c_hi = (lo == L - 1) ? PROB_SCALE
                                  : cdf_q(m, lo + 1, t0, bw, M);
    *lo_out = c_lo;
    *hi_out = c_hi;
    return lo;
}

// ---------------------------------------------------------------------------
// Chunk helpers
// ---------------------------------------------------------------------------

static inline long long chunk_begin(long long n, int n_chunks, int i) {
    return (n * i) / n_chunks;
}

// ---------------------------------------------------------------------------
// Public API
// ---------------------------------------------------------------------------

extern "C" {

// Version / feature probe.
int l3c_coder_version() { return 11; }

// CDF evaluator variant (see spec comment at top). Bumped whenever the
// float evaluation changes; the v1 file header records it so a decoder
// with a different evaluator rejects the file instead of silently
// corrupting symbols.
int l3c_eval_variant() { return 1; }

// Encode one scale's C channels under the mixture model.
//   pi, mu, inv_s : [C][HW][K] float32  (softmaxed / raw / exp(-log_s))
//   lam           : [3][HW][K] float32 (sigmoid'd; g<-r, b<-r, b<-g rows)
//                   or NULL when no channel autoregression
//   syms          : [C][HW] int32, each in [0, L-1]
//   out           : byte buffer, capacity out_cap
//   chunk_lens    : [C * n_chunks] int64, filled with per-chunk byte counts
// Streams are written back-to-back per (channel, chunk), channel-major.
// Returns total bytes written, or < 0 on error.
long long l3c_encode_mixture(
    const float* pi, const float* mu, const float* inv_s, const float* lam,
    const int32_t* syms,
    int C, int K, long long HW, int L, float x_min, float bin_w,
    int n_chunks, unsigned char* out, long long out_cap,
    long long* chunk_lens) {
    if (K > 32 || C <= 0 || n_chunks <= 0 || L < 2) return -2;
    const uint32_t M = PROB_SCALE - (uint32_t)L;  // Lp-1 == L
    const float t0 = x_min - bin_w * 0.5f;
    const float inv_bw = 1.0f / bin_w;
    long long written = 0;
    PixelModel pm;

    for (int c = 0; c < C; ++c) {
        const float* pi_c = pi + (long long)c * HW * K;
        const float* mu_c = mu + (long long)c * HW * K;
        const float* is_c = inv_s + (long long)c * HW * K;
        const int32_t* s_c = syms + (long long)c * HW;
        for (int ch = 0; ch < n_chunks; ++ch) {
            long long p0 = chunk_begin(HW, n_chunks, ch);
            long long p1 = chunk_begin(HW, n_chunks, ch + 1);
            long long n_sym = p1 - p0;
            // worst case: one u32 per symbol + 2 flush words
            long long cap_words = n_sym + 2;
            if (written + cap_words * 4 > out_cap) return -3;
            uint32_t* base = (uint32_t*)(out + written);
            uint32_t* end = base + cap_words;
            RansEnc enc;
            rans_enc_init(&enc, end, base);
            // rANS encodes in reverse so the decoder reads forward
            for (long long p = p1 - 1; p >= p0; --p) {
                const float* l0 = nullptr;
                const float* l1 = nullptr;
                float x0 = 0.0f, x1 = 0.0f;
                if (lam && c >= 1) {
                    x0 = (float)syms[p] * bin_w + x_min;  // channel 0
                    if (c == 1) {
                        l0 = lam + (long long)0 * HW * K + p * K;
                    } else {
                        x1 = (float)syms[HW + p] * bin_w + x_min;
                        l0 = lam + (long long)1 * HW * K + p * K;
                        l1 = lam + (long long)2 * HW * K + p * K;
                    }
                }
                load_pixel_model(&pm, pi_c + p * K, mu_c + p * K,
                                 is_c + p * K, K, x0, l0, x1, l1,
                                 x_min, inv_bw, L);
                int s = s_c[p];
                if (s < 0 || s >= L) return -4;
                uint32_t c_lo = cdf_q(&pm, s, t0, bin_w, M);
                uint32_t c_hi = (s == L - 1)
                                    ? PROB_SCALE
                                    : cdf_q(&pm, s + 1, t0, bin_w, M);
                if (rans_enc_put(&enc, c_lo, c_hi - c_lo) != 0) return -5;
            }
            if (rans_enc_flush(&enc) != 0) return -5;
            long long n_bytes = (char*)end - (char*)enc.ptr;
            std::memmove(out + written, enc.ptr, (size_t)n_bytes);
            chunk_lens[c * n_chunks + ch] = n_bytes;
            written += n_bytes;
        }
    }
    return written;
}

// Decode one scale. Same parameter layouts as encode; `in` holds the
// concatenated (channel, chunk) streams with lengths `chunk_lens`.
// Fills syms_out [C][HW]. Returns 0, or < 0 on error.
int l3c_decode_mixture(
    const float* pi, const float* mu, const float* inv_s, const float* lam,
    const unsigned char* in, const long long* chunk_lens,
    int C, int K, long long HW, int L, float x_min, float bin_w,
    int n_chunks, int32_t* syms_out) {
    if (K > 32 || C <= 0 || n_chunks <= 0 || L < 2) return -2;
    const uint32_t M = PROB_SCALE - (uint32_t)L;
    const float t0 = x_min - bin_w * 0.5f;
    const float inv_bw = 1.0f / bin_w;
    long long off = 0;
    PixelModel pm;

    for (int c = 0; c < C; ++c) {
        const float* pi_c = pi + (long long)c * HW * K;
        const float* mu_c = mu + (long long)c * HW * K;
        const float* is_c = inv_s + (long long)c * HW * K;
        int32_t* s_c = syms_out + (long long)c * HW;
        for (int ch = 0; ch < n_chunks; ++ch) {
            long long p0 = chunk_begin(HW, n_chunks, ch);
            long long p1 = chunk_begin(HW, n_chunks, ch + 1);
            long long n_bytes = chunk_lens[c * n_chunks + ch];
            if (n_bytes < 8 || (n_bytes & 3)) return -6;
            const uint32_t* words = (const uint32_t*)(in + off);
            const uint32_t* wend = words + n_bytes / 4;
            RansDec dec;
            rans_dec_init(&dec, words, wend);
            for (long long p = p0; p < p1; ++p) {
                const float* l0 = nullptr;
                const float* l1 = nullptr;
                float x0 = 0.0f, x1 = 0.0f;
                if (lam && c >= 1) {
                    x0 = (float)syms_out[p] * bin_w + x_min;
                    if (c == 1) {
                        l0 = lam + (long long)0 * HW * K + p * K;
                    } else {
                        x1 = (float)syms_out[HW + p] * bin_w + x_min;
                        l0 = lam + (long long)1 * HW * K + p * K;
                        l1 = lam + (long long)2 * HW * K + p * K;
                    }
                }
                load_pixel_model(&pm, pi_c + p * K, mu_c + p * K,
                                 is_c + p * K, K, x0, l0, x1, l1,
                                 x_min, inv_bw, L);
                uint32_t cf = rans_dec_cf(&dec);
                uint32_t c_lo, c_hi;
                int s = find_symbol(&pm, cf, t0, bin_w, M, L, &c_lo, &c_hi);
                s_c[p] = s;
                rans_dec_advance(&dec, c_lo, c_hi - c_lo);
            }
            off += n_bytes;
        }
    }
    return 0;
}

// Uniform-prior coder for the coarsest scale (bitcoding.py:171-210):
// closed-form CDF cum(l) = floor(l * 65536 / L), no TPU data needed.
long long l3c_encode_uniform(
    const int32_t* syms, long long n, int L, int n_chunks,
    unsigned char* out, long long out_cap, long long* chunk_lens) {
    if (L < 2 || L > 65536 || n_chunks <= 0) return -2;
    long long written = 0;
    for (int ch = 0; ch < n_chunks; ++ch) {
        long long p0 = chunk_begin(n, n_chunks, ch);
        long long p1 = chunk_begin(n, n_chunks, ch + 1);
        long long cap_words = (p1 - p0) + 2;
        if (written + cap_words * 4 > out_cap) return -3;
        uint32_t* base = (uint32_t*)(out + written);
        uint32_t* end = base + cap_words;
        RansEnc enc;
        rans_enc_init(&enc, end, base);
        for (long long p = p1 - 1; p >= p0; --p) {
            uint32_t s = (uint32_t)syms[p];
            if (s >= (uint32_t)L) return -4;
            uint32_t lo = (uint32_t)(((uint64_t)s << 16) / (uint32_t)L);
            uint32_t hi = (uint32_t)(((uint64_t)(s + 1) << 16)
                                     / (uint32_t)L);
            if (rans_enc_put(&enc, lo, hi - lo) != 0) return -5;
        }
        if (rans_enc_flush(&enc) != 0) return -5;
        long long n_bytes = (char*)end - (char*)enc.ptr;
        std::memmove(out + written, enc.ptr, (size_t)n_bytes);
        chunk_lens[ch] = n_bytes;
        written += n_bytes;
    }
    return written;
}

int l3c_decode_uniform(
    const unsigned char* in, const long long* chunk_lens,
    long long n, int L, int n_chunks, int32_t* syms_out) {
    if (L < 2 || L > 65536 || n_chunks <= 0) return -2;
    long long off = 0;
    for (int ch = 0; ch < n_chunks; ++ch) {
        long long p0 = chunk_begin(n, n_chunks, ch);
        long long p1 = chunk_begin(n, n_chunks, ch + 1);
        long long n_bytes = chunk_lens[ch];
        if (n_bytes < 8 || (n_bytes & 3)) return -6;
        const uint32_t* words = (const uint32_t*)(in + off);
        RansDec dec;
        rans_dec_init(&dec, words, words + n_bytes / 4);
        for (long long p = p0; p < p1; ++p) {
            uint32_t cf = rans_dec_cf(&dec);
            uint32_t s = ((uint64_t)cf * (uint32_t)L) >> 16;
            // fix up boundary rounding (at most one step)
            while ((uint32_t)(((uint64_t)(s + 1) << 16) / (uint32_t)L) <= cf)
                ++s;
            while ((uint32_t)(((uint64_t)s << 16) / (uint32_t)L) > cf)
                --s;
            syms_out[p] = (int32_t)s;
            uint32_t lo = (uint32_t)(((uint64_t)s << 16) / (uint32_t)L);
            uint32_t hi = (uint32_t)(((uint64_t)(s + 1) << 16)
                                     / (uint32_t)L);
            rans_dec_advance(&dec, lo, hi - lo);
        }
        off += n_bytes;
    }
    return 0;
}

// Static-cumulative-table coder: all symbols of a call share ONE
// (L+1)-entry uint32 cumulative table (cum[0]=0, cum[L]=65536, cum
// nondecreasing; symbols with cum[s+1]==cum[s] must not occur). Used by
// the classical MED/JPEG-LS baseline (eval/classic.py) — the reference
// compares against PNG only; a MED+rANS coder is the stronger classical
// bar (LOCO-I / JPEG-LS is the standard of "simple predictor done
// right", Weinberger et al., IEEE TIP 2000).
long long l3c_encode_table(
    const int32_t* syms, long long n, const uint32_t* cum, int L,
    int n_chunks, unsigned char* out, long long out_cap,
    long long* chunk_lens) {
    if (L < 2 || L > 65536 || n_chunks <= 0) return -2;
    if (cum[0] != 0 || cum[L] != 65536u) return -2;
    long long written = 0;
    for (int ch = 0; ch < n_chunks; ++ch) {
        long long p0 = chunk_begin(n, n_chunks, ch);
        long long p1 = chunk_begin(n, n_chunks, ch + 1);
        long long cap_words = (p1 - p0) + 2;
        if (written + cap_words * 4 > out_cap) return -3;
        uint32_t* base = (uint32_t*)(out + written);
        uint32_t* end = base + cap_words;
        RansEnc enc;
        rans_enc_init(&enc, end, base);
        for (long long p = p1 - 1; p >= p0; --p) {
            uint32_t s = (uint32_t)syms[p];
            if (s >= (uint32_t)L) return -4;
            uint32_t lo = cum[s], hi = cum[s + 1];
            if (hi <= lo) return -4;           // zero-frequency symbol
            if (rans_enc_put(&enc, lo, hi - lo) != 0) return -5;
        }
        if (rans_enc_flush(&enc) != 0) return -5;
        long long n_bytes = (char*)end - (char*)enc.ptr;
        std::memmove(out + written, enc.ptr, (size_t)n_bytes);
        chunk_lens[ch] = n_bytes;
        written += n_bytes;
    }
    return written;
}

int l3c_decode_table(
    const unsigned char* in, const long long* chunk_lens,
    long long n, const uint32_t* cum, int L, int n_chunks,
    int32_t* syms_out) {
    if (L < 2 || L > 65536 || n_chunks <= 0) return -2;
    long long off = 0;
    for (int ch = 0; ch < n_chunks; ++ch) {
        long long p0 = chunk_begin(n, n_chunks, ch);
        long long p1 = chunk_begin(n, n_chunks, ch + 1);
        long long n_bytes = chunk_lens[ch];
        if (n_bytes < 8 || (n_bytes & 3)) return -6;
        const uint32_t* words = (const uint32_t*)(in + off);
        RansDec dec;
        rans_dec_init(&dec, words, words + n_bytes / 4);
        for (long long p = p0; p < p1; ++p) {
            uint32_t cf = rans_dec_cf(&dec);
            // binary search: greatest s with cum[s] <= cf
            int lo = 0, hi = L;                 // invariant: cum[lo]<=cf<cum[hi]
            while (hi - lo > 1) {
                int mid = (lo + hi) >> 1;
                if (cum[mid] <= cf) lo = mid; else hi = mid;
            }
            syms_out[p] = (int32_t)lo;
            rans_dec_advance(&dec, cum[lo], cum[lo + 1] - cum[lo]);
        }
        off += n_bytes;
    }
    return 0;
}

// MED / LOCO-I gradient-adjusted predictor (JPEG-LS, Weinberger et al.):
//   a = left, b = above, c = above-left
//   pred = min(a,b) if c >= max(a,b); max(a,b) if c <= min(a,b);
//          else a + b - c
// First row predicts from a, first column from b, corner from 128.
// Residuals are mod-256 so they stay in [0, 256).
static inline int med_pred(int a, int b, int c) {
    int mx = a > b ? a : b, mn = a < b ? a : b;
    if (c >= mx) return mn;
    if (c <= mn) return mx;
    return a + b - c;
}

void l3c_med_residuals(const unsigned char* img, int H, int W, int C,
                       int32_t* res_out) {
    // img is HWC interleaved; residuals channel-planar (C, H*W)
    for (int ch = 0; ch < C; ++ch) {
        int32_t* r = res_out + (long long)ch * H * W;
        for (int i = 0; i < H; ++i)
            for (int j = 0; j < W; ++j) {
                int x = img[((long long)i * W + j) * C + ch];
                int a = j ? img[((long long)i * W + j - 1) * C + ch] : -1;
                int b = i ? img[((long long)(i - 1) * W + j) * C + ch] : -1;
                int c = (i && j)
                    ? img[((long long)(i - 1) * W + j - 1) * C + ch] : -1;
                int pred = (i == 0)
                    ? (j == 0 ? 128 : a)
                    : (j == 0 ? b : med_pred(a, b, c));
                r[(long long)i * W + j] = (x - pred) & 255;
            }
    }
}

// Context-modeled variant (JPEG-LS-style): each symbol is coded under
// one of n_ctx static tables selected by the quantized local gradient
// activity act = |b-c| + |c-a| (causal neighbors; 0 on the first
// row/column), thresholds 1,3,7,...  — ctx = #(2^k - 1 <= act).
// The encoder computes ctx from the original image (== the decoder's
// reconstruction, losslessness), the decoder recomputes it inline
// while reconstructing, so no ctx ids ever hit the file.
static inline int act_ctx(int a, int b, int c, int n_ctx) {
    int act = (b > c ? b - c : c - b) + (c > a ? c - a : a - c);
    int ctx = 0;
    for (int t = 1; ctx < n_ctx - 1 && act >= t; t = 2 * t + 1) ++ctx;
    return ctx;
}

long long l3c_encode_table_ctx(
    const int32_t* syms, const int32_t* ctx, long long n,
    const uint32_t* cums, int n_ctx, int L, int n_chunks,
    unsigned char* out, long long out_cap, long long* chunk_lens) {
    if (L < 2 || L > 65536 || n_chunks <= 0 || n_ctx <= 0) return -2;
    long long written = 0;
    for (int ch = 0; ch < n_chunks; ++ch) {
        long long p0 = chunk_begin(n, n_chunks, ch);
        long long p1 = chunk_begin(n, n_chunks, ch + 1);
        long long cap_words = (p1 - p0) + 2;
        if (written + cap_words * 4 > out_cap) return -3;
        uint32_t* base = (uint32_t*)(out + written);
        uint32_t* end = base + cap_words;
        RansEnc enc;
        rans_enc_init(&enc, end, base);
        for (long long p = p1 - 1; p >= p0; --p) {
            uint32_t s = (uint32_t)syms[p];
            if (s >= (uint32_t)L) return -4;
            if ((uint32_t)ctx[p] >= (uint32_t)n_ctx) return -4;
            const uint32_t* cum = cums + (long long)ctx[p] * (L + 1);
            uint32_t lo = cum[s], hi = cum[s + 1];
            if (hi <= lo) return -4;
            if (rans_enc_put(&enc, lo, hi - lo) != 0) return -5;
        }
        if (rans_enc_flush(&enc) != 0) return -5;
        long long n_bytes = (char*)end - (char*)enc.ptr;
        std::memmove(out + written, enc.ptr, (size_t)n_bytes);
        chunk_lens[ch] = n_bytes;
        written += n_bytes;
    }
    return written;
}

// Decode + MED reconstruction fused: the context of pixel p depends on
// already-reconstructed neighbors, so decode must interleave with
// reconstruction (this is exactly how JPEG-LS decoders work).
// cums: (C, n_ctx, L+1) uint32; chunk_lens: (C, n_chunks).
int l3c_medctx_decode(
    const unsigned char* in, const long long* chunk_lens,
    int H, int W, int C, const uint32_t* cums, int n_ctx, int L,
    int n_chunks, unsigned char* img_out) {
    if (L != 256 || n_chunks <= 0 || n_ctx <= 0) return -2;
    long long off = 0;
    long long n = (long long)H * W;
    for (int chn = 0; chn < C; ++chn) {
        const uint32_t* ch_cums = cums + (long long)chn * n_ctx * (L + 1);
        for (int ck = 0; ck < n_chunks; ++ck) {
            long long p0 = chunk_begin(n, n_chunks, ck);
            long long p1 = chunk_begin(n, n_chunks, ck + 1);
            long long n_bytes = chunk_lens[(long long)chn * n_chunks + ck];
            if (n_bytes < 8 || (n_bytes & 3)) return -6;
            const uint32_t* words = (const uint32_t*)(in + off);
            RansDec dec;
            rans_dec_init(&dec, words, words + n_bytes / 4);
            for (long long p = p0; p < p1; ++p) {
                int i = (int)(p / W), j = (int)(p % W);
                int a = j ? img_out[((long long)i * W + j - 1) * C + chn]
                          : -1;
                int b = i ? img_out[((long long)(i - 1) * W + j) * C + chn]
                          : -1;
                int c = (i && j)
                    ? img_out[((long long)(i - 1) * W + j - 1) * C + chn]
                    : -1;
                int pred, ctx;
                if (i == 0) {
                    pred = (j == 0) ? 128 : a;
                    ctx = 0;
                } else if (j == 0) {
                    pred = b;
                    ctx = 0;
                } else {
                    pred = med_pred(a, b, c);
                    ctx = act_ctx(a, b, c, n_ctx);
                }
                const uint32_t* cum = ch_cums + (long long)ctx * (L + 1);
                uint32_t cf = rans_dec_cf(&dec);
                int lo = 0, hi = L;
                while (hi - lo > 1) {
                    int mid = (lo + hi) >> 1;
                    if (cum[mid] <= cf) lo = mid; else hi = mid;
                }
                rans_dec_advance(&dec, cum[lo], cum[lo + 1] - cum[lo]);
                img_out[((long long)i * W + j) * C + chn] =
                    (unsigned char)((pred + lo) & 255);
            }
            off += n_bytes;
        }
    }
    return 0;
}

// v3 (.medl): v2 + chained inter-channel residual correction. Channel
// chn's prediction is MED plus, per previously-decoded channel j, the
// integer correction floor((resc_j * alpha_{chn,j} + 32) / 64) from
// that channel's CENTERED mod-256 residual resc_j in [-128, 127].
// Alphas (int8, fitted per image on the encode side) arrive flattened
// channel-major: [a10, a20, a21, a30, ...] — C*(C-1)/2 entries.
// Contexts still come from the channel's own reconstruction, so the
// context model is untouched; only the prediction moves. The exact
// integer form ((r * a + 32) >> 6, arithmetic shift == floor division)
// is the cross-language contract with eval/classic.py's encoder.
int l3c_medctx_decode_v3(
    const unsigned char* in, const long long* chunk_lens,
    int H, int W, int C, const uint32_t* cums, int n_ctx, int L,
    int n_chunks, const signed char* alphas, unsigned char* img_out) {
    if (L != 256 || n_chunks <= 0 || n_ctx <= 0 || C > 8) return -2;
    long long off = 0;
    long long n = (long long)H * W;
    std::vector<signed char> resc((size_t)C * n);   // centered residuals
    std::vector<int32_t> corr(n);
    int a_off = 0;
    for (int chn = 0; chn < C; ++chn) {
        const uint32_t* ch_cums = cums + (long long)chn * n_ctx * (L + 1);
        std::fill(corr.begin(), corr.end(), 0);
        for (int j = 0; j < chn; ++j) {
            int a = alphas[a_off + j];
            if (!a) continue;
            const signed char* pr = resc.data() + (size_t)j * n;
            for (long long p = 0; p < n; ++p)
                corr[p] += ((int32_t)pr[p] * a + 32) >> 6;
        }
        a_off += chn;
        signed char* rc = resc.data() + (size_t)chn * n;
        for (int ck = 0; ck < n_chunks; ++ck) {
            long long p0 = chunk_begin(n, n_chunks, ck);
            long long p1 = chunk_begin(n, n_chunks, ck + 1);
            long long n_bytes = chunk_lens[(long long)chn * n_chunks + ck];
            if (n_bytes < 8 || (n_bytes & 3)) return -6;
            const uint32_t* words = (const uint32_t*)(in + off);
            RansDec dec;
            rans_dec_init(&dec, words, words + n_bytes / 4);
            for (long long p = p0; p < p1; ++p) {
                int i = (int)(p / W), j = (int)(p % W);
                int a = j ? img_out[((long long)i * W + j - 1) * C + chn]
                          : -1;
                int b = i ? img_out[((long long)(i - 1) * W + j) * C + chn]
                          : -1;
                int c = (i && j)
                    ? img_out[((long long)(i - 1) * W + j - 1) * C + chn]
                    : -1;
                int pred, ctx;
                if (i == 0) {
                    pred = (j == 0) ? 128 : a;
                    ctx = 0;
                } else if (j == 0) {
                    pred = b;
                    ctx = 0;
                } else {
                    pred = med_pred(a, b, c);
                    ctx = act_ctx(a, b, c, n_ctx);
                }
                pred += corr[p];
                const uint32_t* cum = ch_cums + (long long)ctx * (L + 1);
                uint32_t cf = rans_dec_cf(&dec);
                int lo = 0, hi = L;
                while (hi - lo > 1) {
                    int mid = (lo + hi) >> 1;
                    if (cum[mid] <= cf) lo = mid; else hi = mid;
                }
                rans_dec_advance(&dec, cum[lo], cum[lo + 1] - cum[lo]);
                img_out[((long long)i * W + j) * C + chn] =
                    (unsigned char)((pred + lo) & 255);
                rc[p] = (signed char)(((lo + 128) & 255) - 128);
            }
            off += n_bytes;
        }
    }
    return 0;
}

// Encode-side context map from the original image (must equal the
// decoder's reconstruction-time contexts; shares act_ctx/med boundary
// conventions above).
void l3c_medctx_contexts(const unsigned char* img, int H, int W, int C,
                         int n_ctx, int32_t* ctx_out) {
    for (int chn = 0; chn < C; ++chn) {
        int32_t* cx = ctx_out + (long long)chn * H * W;
        for (int i = 0; i < H; ++i)
            for (int j = 0; j < W; ++j) {
                if (i == 0 || j == 0) {
                    cx[(long long)i * W + j] = 0;
                    continue;
                }
                int a = img[((long long)i * W + j - 1) * C + chn];
                int b = img[((long long)(i - 1) * W + j) * C + chn];
                int c = img[((long long)(i - 1) * W + j - 1) * C + chn];
                cx[(long long)i * W + j] = act_ctx(a, b, c, n_ctx);
            }
    }
}

void l3c_med_reconstruct(const int32_t* res, int H, int W, int C,
                         unsigned char* img_out) {
    for (int ch = 0; ch < C; ++ch) {
        const int32_t* r = res + (long long)ch * H * W;
        for (int i = 0; i < H; ++i)
            for (int j = 0; j < W; ++j) {
                int a = j ? img_out[((long long)i * W + j - 1) * C + ch]
                          : -1;
                int b = i ? img_out[((long long)(i - 1) * W + j) * C + ch]
                          : -1;
                int c = (i && j)
                    ? img_out[((long long)(i - 1) * W + j - 1) * C + ch]
                    : -1;
                int pred = (i == 0)
                    ? (j == 0 ? 128 : a)
                    : (j == 0 ? b : med_pred(a, b, c));
                img_out[((long long)i * W + j) * C + ch] =
                    (unsigned char)((pred + r[(long long)i * W + j]) & 255);
            }
    }
}

}  // extern "C"
