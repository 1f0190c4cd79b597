"""The rANS kernels' source (csrc/rans.cu) run on the CPU, against the plain
versions of ops/gpu_coder.py.

There is no CUDA compiler here, so the test compiles rans.cu with g++
against a small header that maps the CUDA constructs the file uses onto
the host: each block runs as its threads, one std::thread each,
`__syncthreads` is a std::barrier, the warp intrinsics (shuffles,
`__ballot_sync`, `__reduce_{max,min}_sync`, `__syncwarp`) exchange
through memory behind a barrier of the lanes taking part (a warp, or the
tiled decode's groups of four), the SIMD intrinsics are written out, and
`kernel<<<...>>>(args)` becomes one such block run per block. Shared
memory is a static array per kernel. The library is then bound in place
of build.library("rans"), with tensors reporting is_cuda, so the
channel-level functions take the kernels' path on CPU memory. A test-only
`extern "C"` shim appended to the compiled text reaches the generic
variants where the launchers run the tiles, and the uniform row's
closed-form inverse. This checks the kernels' index arithmetic, tiling,
double buffering, word placement and search exactly, in every mode, at
small sizes; it does not check what only the card can show (the CUDA
compiler, the card's arithmetic, speed), which
tests/test_torch_port_kernels.py and chip_smoke.py do on the card.
"""
import ctypes
import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from l3c_torch import blueprint
from l3c_torch import config as tcfg
from l3c_torch.codec import bitcoding2
from l3c_torch.codec.bitcoding2 import (TorchBitcoding, canary_inputs,
                                        coder_check, contract_canary)
from l3c_torch.models.network import MultiscaleNetwork
from l3c_torch.ops import gpu_coder as gc
from l3c_torch.ops import int_coder as ic
from l3c_torch.ops import kernels
from l3c_torch.ops.kernels import build

torch.set_num_threads(1)

HOST_CUDA_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(x) __attribute__((aligned(x)))
#define __restrict__
using std::max;
using std::min;
struct Dim { int x = 0; };
inline thread_local Dim threadIdx, blockIdx;
inline std::barrier<>* g_block = nullptr;
inline std::barrier<>* g_quad[64];
inline std::barrier<>* g_warp[8];
inline uint32_t g_lanes[256];
inline void __syncthreads() { g_block->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct float4 { float x, y, z, w; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return uint2{a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return float4{a, b, c, d};
}
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return uint4{a, b, c, d};
}
// Warp intrinsics as exchanges through memory between two barriers of the
// lanes taking part: the whole warp (mask 0xFFFFFFFF), or the four lanes
// of the tiled decode's groups (any other mask rans.cu passes)
inline void lanes_sync(unsigned mask) {
  const int t = threadIdx.x;
  if (mask == 0xFFFFFFFFu) g_warp[t >> 5]->arrive_and_wait();
  else g_quad[t >> 2]->arrive_and_wait();
}
inline void __syncwarp(unsigned mask) { lanes_sync(mask); }
template <class F> inline uint32_t exchange(unsigned mask, uint32_t v, F read) {
  g_lanes[threadIdx.x] = v;
  lanes_sync(mask);
  const uint32_t r = read(g_lanes + (threadIdx.x & ~31));
  lanes_sync(mask);
  return r;
}
template <class T> inline T shfl_from(unsigned mask, T v, int src) {
  static_assert(sizeof(T) == 4);
  uint32_t u;
  std::memcpy(&u, &v, 4);
  u = exchange(mask, u, [&](const uint32_t* w) { return w[src & 31]; });
  std::memcpy(&v, &u, 4);
  return v;
}
template <class T> inline T __shfl_sync(unsigned m, T v, int src) {
  return shfl_from(m, v, src);
}
template <class T> inline T __shfl_xor_sync(unsigned m, T v, int o) {
  return shfl_from(m, v, (threadIdx.x & 31) ^ o);
}
inline uint32_t __ballot_sync(unsigned m, int pred) {
  return exchange(m, pred != 0, [](const uint32_t* w) {
    uint32_t r = 0;
    for (int j = 0; j < 32; ++j) r |= w[j] << j;
    return r;
  });
}
inline uint32_t __reduce_max_sync(unsigned m, uint32_t v) {
  return exchange(m, v, [](const uint32_t* w) {
    return *std::max_element(w, w + 32);
  });
}
inline uint32_t __reduce_min_sync(unsigned m, uint32_t v) {
  return exchange(m, v, [](const uint32_t* w) {
    return *std::min_element(w, w + 32);
  });
}
inline uint32_t __vcmpleu2(uint32_t a, uint32_t b) {
  return ((a & 0xFFFF) <= (b & 0xFFFF) ? 0xFFFFu : 0u) |
         ((a >> 16) <= (b >> 16) ? 0xFFFF0000u : 0u);
}
inline uint32_t __vmaxu2(uint32_t a, uint32_t b) {
  return max(a & 0xFFFF, b & 0xFFFF) | (max(a >> 16, b >> 16) << 16);
}
inline uint32_t __vminu2(uint32_t a, uint32_t b) {
  return min(a & 0xFFFF, b & 0xFFFF) | (min(a >> 16, b >> 16) << 16);
}
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
template <class F> void host_launch(int blocks, int threads, F body) {
  for (int b = 0; b < blocks; ++b) {
    std::barrier<> block(threads);
    std::vector<std::unique_ptr<std::barrier<>>> groups;
    for (int q = 0; q < threads / 4; ++q) {
      groups.emplace_back(new std::barrier<>(4));
      g_quad[q] = groups.back().get();
    }
    for (int w = 0; w < threads / 32; ++w) {
      groups.emplace_back(new std::barrier<>(32));
      g_warp[w] = groups.back().get();
    }
    g_block = &block;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    for (auto& th : ts) th.join();
  }
}
"""

# Test-only entry points appended to the compiled text (rans.cu has none):
# the launchers' generic variants called directly, where the launchers
# would run the tiles, and the uniform row's closed-form inverse
TEST_SHIM = r"""
extern "C" int l3c_test_rans_decode_generic(
    const void* p, const void* a, const void* sc, const void* v,
    const void* w, const void* dec, const void* asym, const void* words,
    void* syms, int mode, int K, int N, int n, int T, int W, int lanes,
    int F, int c0, int L, void* stream) {
  const Geom G{n, T, (n + T - 1) / T, lanes, F, c0};
  return decode_generic(mode, params(p, a, sc, v, w, K, N), dec, asym, words,
                        syms, G, W, L, static_cast<cudaStream_t>(stream));
}
extern "C" int l3c_test_rans_encode_generic(
    const void* p, const void* a, const void* sc, const void* v,
    const void* w, const void* sym, void* words, void* lengths, int mode,
    int K, int N, int n, int T, int lanes, int F, int L, void* stream) {
  const Geom G{n, T, (n + T - 1) / T, lanes, F, 0};
  return encode_generic(mode, params(p, a, sc, v, w, K, N), sym, words,
                        lengths, G, L, static_cast<cudaStream_t>(stream));
}
// (symbol, its edge, the next edge) of every cf in 0..65535 at L symbols
extern "C" int l3c_test_uniform_symbols(int L, void* out) {
  int32_t* o = static_cast<int32_t*>(out);
  for (uint32_t cf = 0; cf < 65536; ++cf) {
    const uint32_t s = uniform_symbol(cf, L);
    o[3 * cf] = static_cast<int32_t>(s);
    o[3 * cf + 1] = static_cast<int32_t>(uniform_edge_u(s, L));
    o[3 * cf + 2] = static_cast<int32_t>(uniform_edge_u(s + 1, L));
  }
  return 0;
}
"""


def _host_source() -> str:
    src = open(os.path.join(build.CSRC, "rans.cu")).read()
    for old, new in (
            ("kernel<<<blocks, threads, smem, stream>>>(args...);",
             "host_launch(blocks, threads, [&] { kernel(args...); });"),
            ("extern __shared__ __align__(16) unsigned char smem[];",
             "static unsigned char smem[1 << 18] __attribute__((aligned(16)));"
             )):
        assert old in src, f"rans.cu no longer contains {old!r}"
        src = src.replace(old, new)
    assert not re.search(r"<<<|extern __shared__", src)
    return src


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """ctypes library of rans.cu compiled for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile rans.cu for the host")
    d = tmp_path_factory.mktemp("rans_host")
    (d / "cuda_runtime.h").write_text(HOST_CUDA_H)
    (d / "rans_host.cpp").write_text(_host_source() + TEST_SHIM)
    out = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-fno-gnu-unique",   # threadIdx: one per library, not shared
         "-pthread", f"-I{d}", f"-I{build.CSRC}", "-o",
         str(d / "librans.so"), str(d / "rans_host.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert out.returncode == 0, out.stdout[-4000:]
    return build._bind("rans", str(d / "librans.so"))


def _kernel_path(monkeypatch, lib):
    """Route the rANS launchers to `lib` on CPU tensors. The float pack
    stage keeps its plain version: its kernel is another source, run on
    the host by tests/test_torch_port_pack_host.py."""
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(bitcoding2, "pack_int", ic.pack_int_params_nchw)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))


F, n, T, L_BN = 2, 150, 64, 25
N = F * n


def _int_params(K, rgb, seed):
    """Random IntParams (C, K, N) within the evaluator's ranges, sharp and
    flat mixtures mixed."""
    rng = np.random.RandomState(seed)
    C = 3 if rgb else 5
    pi = rng.dirichlet(np.ones(K) * rng.choice([0.05, 0.5]), (C, N))
    a_hat = np.clip(np.exp(rng.uniform(-6, 5, (C, N, K))), ic.A_MIN,
                    ic.A_MAX)
    m_hat = rng.uniform(-10, 300 if rgb else 30, (C, N, K))
    v = np.clip(np.round(m_hat * a_hat * 1024), -ic.V_CLAMP, ic.V_CLAMP)
    w = (np.round(rng.uniform(0, 1, (3, N, K)) * a_hat[[1, 2, 2]] * 1024)
         if rgb else None)
    return ic.IntParams(*[
        None if x is None else torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 2, 1)).astype(np.float32))
        for x in (np.round(pi * ic.PI_Q), np.round(a_hat * 1024),
                  np.round(a_hat * 16 * 1024), v, w)])


def _same_coded(got, want):
    (wk, lk), (wp, lp) = got, want
    keep = lambda w, ln: w[torch.arange(w.shape[1])[None] < ln[:, None]]
    return torch.equal(lk, lp) and torch.equal(keep(wk, lk), keep(wp, lp))


def _cut(w, ln):
    return w[:, :int(ln.max())].contiguous()


def _run(monkeypatch, lib, fn):
    with monkeypatch.context() as m:
        _kernel_path(m, lib)
        return fn()


@pytest.mark.parametrize("mode,K", [
    ("uniform", 0), ("bn", 1), ("bn", 3), ("bn", 4), ("bn", 7), ("bn", 10),
    ("rgb", 1), ("rgb", 3), ("rgb", 4), ("rgb", 7), ("rgb", 10)])
def test_rans_source_matches_plain(host_lib, monkeypatch, mode, K):
    """K3 and K4 of rans.cu against the plain versions: lengths and used
    words identical, symbols identical and equal to the coded ones. K' > 4
    takes the kernels' 10-component parameter registers, K' <= 4 the
    4-component ones; n = 150 is not a multiple of T = 64."""
    _rans_matches_plain(host_lib, monkeypatch, mode, K, L_BN)


# beyond the tiles (the generic variants): K' = 12, 16, 32 and 255 (the
# cap), L = 40 and 256 (the cap; the baselines' unit 0 is uniform there)
@pytest.mark.parametrize("mode,K,L", [
    ("bn", 12, 25), ("bn", 16, 40), ("uniform", 0, 40), ("bn", 4, 40),
    ("rgb", 12, 16), ("rgb", 16, 16), ("uniform", 0, 256), ("bn", 4, 256),
    ("bn", 255, 25), ("rgb", 32, 16), ("rgb", 255, 16)])
def test_rans_source_beyond_the_tiles(host_lib, monkeypatch, mode, K, L):
    """K3 and K4 where the JAX package's sizes pass the tiles' (K' > 10 or
    L > 33): the same words, lengths and symbols as the plain versions."""
    _rans_matches_plain(host_lib, monkeypatch, mode, K, L)


def _generic(lib):
    """`lib` with the launchers replaced by the test shim's, which run the
    generic variants at every size."""
    sigs = build.signatures("rans")
    out = types.SimpleNamespace()
    for name, shim in (("l3c_rans_decode", "l3c_test_rans_decode_generic"),
                       ("l3c_rans_encode", "l3c_test_rans_encode_generic")):
        fn = getattr(lib, shim)
        fn.argtypes, fn.restype = sigs[name], ctypes.c_int
        setattr(out, name, fn)
    return out


def _outputs(monkeypatch, lib, mode, K, L):
    """K3's lengths and used words and K4's symbols through `lib`, on the
    inputs _rans_matches_plain codes."""
    rng = np.random.RandomState(K)
    run = lambda fn: _run(monkeypatch, lib, fn)
    if mode == "rgb":
        ip = _int_params(K, True, 10 + K)
        img = torch.from_numpy(rng.randint(0, 256, (3, N)))
        lay6 = gc.layout_for(n, 6 * F, T)
        w6, l6 = run(lambda: gc.encode_rgb(ip, img, lay6))
        out = [l6, _cut(w6, l6)]
        lay = gc.layout_for(n, F, T)
        ns, half = F * lay.ns_c, lay6.lanes // 2
        dec = img.to(torch.uint8)
        for c in range(3):
            wc = _cut(w6[c * ns:(c + 1) * ns], l6[c * ns:(c + 1) * ns])
            r0 = half + c * ns
            wf = _cut(w6[r0:r0 + ns], l6[r0:r0 + ns])
            a = run(lambda: gc.decode_rgb_coarse(ip, c, dec, wc, lay))
            out += [a, run(lambda: gc.decode_rgb_fine(ip, c, dec, a, wf,
                                                      lay))]
        return out
    syms = torch.from_numpy(rng.randint(0, L, (5, N)))
    lay = gc.layout_for(n, 5 * F, T)
    if mode == "uniform":
        w, ln = run(lambda: gc.encode_uniform(syms.reshape(-1), L, lay))
        words = _cut(w, ln)
        return [ln, words, run(lambda: gc.decode_uniform(words, L, lay))]
    ip = _int_params(K, False, 20 + K)
    w, ln = run(lambda: gc.encode_bn(ip, syms, L, lay))
    words = _cut(w, ln)
    return [ln, words, run(lambda: gc.decode_bn(ip, words, L, lay))]


# where both run: K' <= 10, L <= 33
@pytest.mark.parametrize("mode,K,L", [
    ("uniform", 0, 25), ("uniform", 0, 33), ("bn", 1, 25), ("bn", 4, 33),
    ("rgb", 4, 16), ("rgb", 10, 16)])
def test_generic_variants_equal_the_tiles(host_lib, monkeypatch, mode, K, L):
    """The generic variants of K3 and K4 give the tiled kernels' lengths,
    words and symbols bit for bit where the launchers run the tiles (the
    generic ones reached through a test-only shim)."""
    tiled = _outputs(monkeypatch, host_lib, mode, K, L)
    generic = _outputs(monkeypatch, _generic(host_lib), mode, K, L)
    assert _same_coded(generic[1::-1], tiled[1::-1])
    assert len(generic) == len(tiled)
    for got, want in zip(generic[2:], tiled[2:]):
        assert torch.equal(got, want)


def test_uniform_inverse_is_exact(host_lib):
    """K4 uniform's closed-form inverse of the uniform row, for every L in
    2..256 and every cf in 0..65535: the symbol, its edge and the next edge
    are those uniform_cdf_row's search gives (the last symbol's next edge
    the top, 65536)."""
    fn = host_lib.l3c_test_uniform_symbols
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    cf = np.arange(65536)
    out = np.empty((65536, 3), np.int32)
    for L in range(2, 257):
        assert fn(L, out.ctypes.data) == 0
        row = np.append(gc.uniform_cdf_row(L).astype(np.int64), 65536)
        s = np.searchsorted(row[:L], cf, side="right") - 1
        np.testing.assert_array_equal(out, np.stack([s, row[s], row[s + 1]],
                                                    1), err_msg=f"L={L}")


def _rans_matches_plain(lib, monkeypatch, mode, K, L_BN):
    rng = np.random.RandomState(K)
    launches = dict(kernels.launches)
    if mode == "rgb":
        ip = _int_params(K, True, 10 + K)
        img = torch.from_numpy(rng.randint(0, 256, (3, N)))
        lay6 = gc.layout_for(n, 6 * F, T)
        want = gc.encode_rgb_plain(ip, img, lay6)
        w6, l6 = _run(monkeypatch, lib, lambda: gc.encode_rgb(ip, img, lay6))
        assert _same_coded((w6, l6), want)
        lay = gc.layout_for(n, F, T)
        ns, half = F * lay.ns_c, lay6.lanes // 2
        dec = img.to(torch.uint8)
        for c in range(3):
            wc = _cut(w6[c * ns:(c + 1) * ns], l6[c * ns:(c + 1) * ns])
            r0 = half + c * ns
            wf = _cut(w6[r0:r0 + ns], l6[r0:r0 + ns])
            a = _run(monkeypatch, lib, lambda: gc.decode_rgb_coarse(
                ip, c, dec, wc, lay))
            assert torch.equal(a, gc.decode_rgb_coarse_plain(ip, c, dec, wc,
                                                             lay))
            b = _run(monkeypatch, lib, lambda: gc.decode_rgb_fine(
                ip, c, dec, a, wf, lay))
            assert torch.equal(b, gc.decode_rgb_fine_plain(ip, c, dec, a, wf,
                                                           lay))
            assert torch.equal(((a << 4) | b).long(), img[c])
        want_launches = {"rans_encode": 1, "rans_decode": 6}
    else:
        syms = torch.from_numpy(rng.randint(0, L_BN, (5, N)))
        lay = gc.layout_for(n, 5 * F, T)
        if mode == "uniform":
            flat = syms.reshape(-1)
            enc = lambda: gc.encode_uniform(flat, L_BN, lay)
            want = gc.encode_uniform_plain(flat, L_BN, lay)
        else:
            ip = _int_params(K, False, 20 + K)
            enc = lambda: gc.encode_bn(ip, syms, L_BN, lay)
            want = gc.encode_bn_plain(ip, syms, L_BN, lay)
        coded = _run(monkeypatch, lib, enc)
        assert _same_coded(coded, want)
        words = _cut(*coded)
        if mode == "uniform":
            got = _run(monkeypatch, lib,
                       lambda: gc.decode_uniform(words, L_BN, lay))
            ref = gc.decode_uniform_plain(words, L_BN, lay)
        else:
            got = _run(monkeypatch, lib,
                       lambda: gc.decode_bn(ip, words, L_BN, lay))
            ref = gc.decode_bn_plain(ip, words, L_BN, lay)
        assert torch.equal(got, ref)
        assert torch.equal(got.reshape(5, N).long(), syms)
        want_launches = {"rans_encode": 1, "rans_decode": 1}
    assert {k: kernels.launches[k] - launches.get(k, 0)
            for k in want_launches} == want_launches


def test_codec_files_through_rans_source(host_lib, monkeypatch, tmp_path):
    """A tiny model's codec round through the host-built kernels writes the
    same bytes as the plain path and decodes bit-exactly, launching K3 4
    times and K4 9 times."""
    cfg = tcfg.MsConfig(num_scales=3, Cf=8, enc=tcfg.EncConfig(num_blocks=1),
                        dec=tcfg.DecConfig(num_blocks=1),
                        q=tcfg.QConfig(C=5, L=25), prob=tcfg.ProbConfig(K=10))
    torch.manual_seed(0)
    bc = TorchBitcoding(cfg, MultiscaleNetwork(cfg), device="cpu")
    imgs = [np.random.RandomState(i).randint(0, 256, (1, 21, 19, 3))
            .astype(np.uint8) for i in range(3)]
    plain = [str(tmp_path / f"p{i}") for i in range(3)]
    fused = [str(tmp_path / f"k{i}") for i in range(3)]
    bc.encode_batch(imgs, plain)
    kernels.reset_launches()
    outs = _run(monkeypatch, host_lib,
                lambda: (bc.encode_batch(imgs, fused),
                         bc.decode_batch(fused))[1])
    assert dict(kernels.launches) == {"rans_encode": 4, "rans_decode": 9}
    for p, k, img, out in zip(plain, fused, imgs, outs):
        assert open(p, "rb").read() == open(k, "rb").read()
        np.testing.assert_array_equal(out, img)


def _canary(cfg):
    return contract_canary(blueprint.rgb_spec(cfg), blueprint.bn_spec(cfg),
                           cfg.q.C, cfg.prob.K, 4, torch.device("cpu"))


def test_canary_holds_the_kernels(host_lib, monkeypatch):
    """On the kernel path the canary first holds K3/K4 to the plain
    versions on its IntParams at every symbol value (coder_check: one
    RGB and one bn encode, six RGB and one bn decode), then gives the
    plain path's value."""
    cfg = tcfg.MsConfig()
    want = _canary(cfg)
    launches = dict(kernels.launches)
    assert _run(monkeypatch, host_lib, lambda: _canary(cfg)) == want
    assert {k: kernels.launches[k] - launches.get(k, 0)
            for k in kernels.KERNELS if k.startswith("rans")} == {
        "rans_encode": 2, "rans_decode": 7}


@pytest.mark.parametrize("fn,what", [
    ("encode_rgb", "encode_rgb"), ("decode_rgb_fine", "decode_rgb channel 0"),
    ("encode_bn", "encode_bn"), ("decode_bn", "decode_bn")])
def test_coder_check_refuses_a_differing_coder(monkeypatch, fn, what):
    """A channel-level coder function whose output differs from its plain
    version by one bit of one element fails coder_check (plain path: the
    check's comparisons, not the kernels, are under test here)."""
    cfg = tcfg.MsConfig()
    rgb, bn = blueprint.rgb_spec(cfg), blueprint.bn_spec(cfg)
    l_rgb, l_bn, _, _ = canary_inputs(bn, cfg.q.C, cfg.prob.K)
    ip_r = ic.pack_int_params(rgb, torch.from_numpy(l_rgb), 3, 4)
    ip_b = ic.pack_int_params(bn, torch.from_numpy(l_bn), cfg.q.C, 4)
    orig = getattr(gc, fn)

    def broken(*args):
        out = orig(*args)
        if fn.startswith("encode"):          # the first stream's state
            w, ln = out
            w = w.clone()
            w[0, 0] ^= 1
            return w, ln
        out = out.clone()
        out.view(-1)[0] ^= 1
        return out

    coder_check(ip_r, ip_b, bn.L)
    monkeypatch.setattr(gc, fn, broken)
    with pytest.raises(RuntimeError, match=what):
        coder_check(ip_r, ip_b, bn.L)
