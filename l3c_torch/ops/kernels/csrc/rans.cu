// rANS32 encode and decode scans for the v8 codec, one thread per stream.
//
// Replaces the XLA-lowered lax.scan programs of the JAX package:
//   rans_encode  <- l3c_tpu/ops/tpu_coder.py:305 rans_encode
//                   (+ _divmod_by_freq :250 and _compact_left :375)
//   rans_decode  <- l3c_tpu/ops/tpu_coder.py:481 rans_decode
//                   (+ _decode_symbol :418 and the word window :453)
// The plain PyTorch versions are in l3c_torch/ops/gpu_coder.py.
//
// What bounds them on Hopper: each stream is a chain of T dependent
// steps (the rANS state), so a stream is inherently serial and the
// kernels are latency-bound, not bandwidth-bound: the bytes they move
// (start/freq/mask in, words out; rows in, symbols out) take tens of
// microseconds at HBM rate while the T-step chains take milliseconds.
// The design therefore spends nothing on the TPU's workarounds:
//   - exact hardware u32 '/' and '%' replace the two-f32-division divmod
//     (a VPU workaround, bit-identical by proof, so the output is too);
//   - the encoder writes each renorm word straight to its decode-order
//     slot (written from the row's end, then moved to the front once), so
//     the log-rotation compaction pass disappears;
//   - the decoder reads its next word at its own cursor instead of a
//     one-hot window fetch, and searches the L <= 25 row entries linearly.
// Both are integer-exact, so outputs equal the JAX scans bit for bit:
// words/lengths byte-identical, symbols identical, including masked
// (padding) slots, which never move the state.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;

// start, freq: (NS, T) int32 (u32 values < 2^17); mask: (NS, T) u8.
// words: (NS, T + 2) int32 holding u16 values in decode order
// [state_lo, state_hi, renorm words...]; slots past the stream's length
// are left as they are (no reader looks past a length);
// lengths: (NS,) int32 = renorm words + 2.
__global__ void rans_encode_kernel(const int32_t* __restrict__ start,
                                   const int32_t* __restrict__ freq,
                                   const uint8_t* __restrict__ mask,
                                   int32_t* __restrict__ words,
                                   int32_t* __restrict__ lengths,
                                   int ns, int T) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= ns) return;
  const size_t in_off = static_cast<size_t>(s) * T;
  int32_t* row = words + static_cast<size_t>(s) * (T + 2);
  uint32_t x = kRansL;
  int n = 0;  // renorm words emitted so far
  for (int t = T - 1; t >= 0; --t) {  // rANS encodes in reverse order
    if (!mask[in_off + t]) continue;
    const uint32_t f = static_cast<uint32_t>(freq[in_off + t]);
    const uint32_t st = static_cast<uint32_t>(start[in_off + t]);
    if (x >= (f << 16)) {
      // the k-th emitted word is the (n_emit-1-k)-th in decode order:
      // park it at the row's end, counting down
      row[T + 1 - n] = static_cast<int32_t>(x & 0xFFFFu);
      ++n;
      x >>= 16;
    }
    const uint32_t fs = f > 0 ? f : 1u;   // padded slots carry f = 0
    x = ((x / fs) << 16) + (x % fs) + st;
  }
  // move the n parked words [T+2-n, T+2) to [2, 2+n): dst < src, so an
  // ascending copy never overwrites a word before it is read
  for (int i = 0; i < n; ++i) row[2 + i] = row[T + 2 - n + i];
  row[0] = static_cast<int32_t>(x & 0xFFFFu);
  row[1] = static_cast<int32_t>(x >> 16);
  lengths[s] = n + 2;
}

// rows: (L, NS, T) int32 CDF rows (u16 values), lane-major;
// words: (NS, W) int32 u16 stream words in decode order; mask (NS, T) u8.
// syms: (NS, T) int32.
__global__ void rans_decode_kernel(const int32_t* __restrict__ rows,
                                   const int32_t* __restrict__ words,
                                   const uint8_t* __restrict__ mask,
                                   int32_t* __restrict__ syms,
                                   int ns, int T, int W, int L) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= ns) return;
  const int32_t* wr = words + static_cast<size_t>(s) * W;
  const size_t lane_stride = static_cast<size_t>(ns) * T;
  const int32_t* rs = rows + static_cast<size_t>(s) * T;
  const size_t io_off = static_cast<size_t>(s) * T;
  uint32_t x = W > 1 ? (static_cast<uint32_t>(wr[0]) |
                        (static_cast<uint32_t>(wr[1]) << 16))
                     : 0u;
  int cur = 2;
  for (int t = 0; t < T; ++t) {
    const int32_t cf = static_cast<int32_t>(x & 0xFFFFu);
    // searchsorted as counts and extrema over the row, the reference's
    // exact definition (valid for any row, monotone or not)
    int cnt = 0;
    int32_t lo = 0, hi = 65536;
    for (int l = 0; l < L; ++l) {
      const int32_t r = rs[l * lane_stride + t];
      if (r <= cf) {
        ++cnt;
        lo = r > lo ? r : lo;
      } else {
        hi = r < hi ? r : hi;
      }
    }
    const int sym = cnt > 0 ? cnt - 1 : 0;
    if (sym == L - 1) hi = 65536;
    const uint32_t f = static_cast<uint32_t>(hi - lo);
    const uint32_t x1 = f * (x >> 16) + (x & 0xFFFFu) -
                        static_cast<uint32_t>(lo);
    if (mask[io_off + t]) {
      if (x1 < kRansL) {
        const uint32_t w = cur < W ? static_cast<uint32_t>(wr[cur]) : 0u;
        x = (x1 << 16) | w;
        ++cur;
      } else {
        x = x1;
      }
    }
    syms[io_off + t] = sym;
  }
}

constexpr int kThreads = 64;

}  // namespace

extern "C" int l3c_rans_encode(const void* start, const void* freq,
                               const void* mask, void* words, void* lengths,
                               int ns, int T, void* stream) {
  const int blocks = (ns + kThreads - 1) / kThreads;
  rans_encode_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(start), static_cast<const int32_t*>(freq),
      static_cast<const uint8_t*>(mask), static_cast<int32_t*>(words),
      static_cast<int32_t*>(lengths), ns, T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int l3c_rans_decode(const void* rows, const void* words,
                               const void* mask, void* syms, int ns, int T,
                               int W, int L, void* stream) {
  const int blocks = (ns + kThreads - 1) / kThreads;
  rans_decode_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(words),
      static_cast<const uint8_t*>(mask), static_cast<int32_t*>(syms), ns, T,
      W, L);
  return static_cast<int>(cudaGetLastError());
}
