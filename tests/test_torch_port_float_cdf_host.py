"""The float-row kernels' source (csrc/float_cdf.cu) run on the CPU, against
the plain versions of ops/float_cdf.py and the Pallas kernels of
tools/pallas_cdf.py in interpret mode.

There is no CUDA compiler here, so the test compiles float_cdf.cu with g++
against a small header that maps the CUDA constructs the file uses onto
the host: each block runs as its threads' std::threads, `__syncthreads` is
a std::barrier, shared memory a static array per kernel, and
`kernel<<<...>>>(args)` one such block run per block of the grid (the
header also serves test_torch_port_dmll_host.py: a warp shuffle is an
exchange through an array between two barriers, so every thread of the
block must reach it, as every lane of a warp must on the card). The
PTX the kernels use (csrc/ptx.cuh: the asynchronous copies, ex2.approx,
rcp.approx) is replaced by a header of the same name with plain copies,
exp2f and a division. The library is bound in place of
build.library("float_cdf"), with tensors reporting is_cuda, so the
dispatching wrappers take the kernels' path on CPU memory. This checks the
kernels' tiling, ragged tiles, misaligned bases, edge groups, staging
swizzle and arithmetic order at small sizes; what only the
card can show (the CUDA compiler, cp.async itself, the card's expf and
approximate instructions, speed) tests/test_torch_port_kernels.py and
chip_smoke.py check there.

Tolerance, the kernels' contract: K1 within 1 quantization step of the
plain version and of the Pallas kernel; K2 within 2 steps on
well-conditioned rows (coarse-bin mass over 1e-2); finished rows strictly
increasing. On the host K2's exact sigmoid differs from the plain version
only by libm's expf against torch.sigmoid, K1's cheap one by exp2f and
its fused multiply-add.
"""
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from l3c_torch.ops import float_cdf, kernels  # noqa: E402
from l3c_torch.ops.kernels import build  # noqa: E402
from tools import pallas_cdf  # noqa: E402

torch.set_num_threads(1)

HOST_CUDA_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
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
using std::min;
struct Dim { int x = 0; };
inline thread_local Dim threadIdx, blockIdx;
inline Dim blockDim, gridDim;
inline std::barrier<>* g_block = nullptr;
inline void __syncthreads() { g_block->arrive_and_wait(); }
struct int4 { int32_t x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
inline int4 make_int4(int32_t a, int32_t b, int32_t c, int32_t d) {
  return int4{a, b, c, d};
}
// a warp's exchange, for kernels whose every thread reaches each shuffle:
// all threads of the block post their value, then read their partner's
inline float g_shfl[1024];
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  g_shfl[threadIdx.x] = v;
  __syncthreads();
  const float got = g_shfl[threadIdx.x ^ lane_mask];
  __syncthreads();
  return got;
}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
template <class F> void host_launch(int blocks, int threads, F body) {
  gridDim.x = blocks;
  blockDim.x = threads;
  for (int b = 0; b < blocks; ++b) {
    std::barrier<> block(threads);
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

HOST_PTX_H = r"""
#pragma once
#include <cmath>
#include <cstring>
namespace ptx {
inline void cp_async16(void* smem, const void* gmem) {
  std::memcpy(smem, gmem, 16);
}
inline void cp_async4(void* smem, const void* gmem) {
  std::memcpy(smem, gmem, 4);
}
inline void cp_async_wait_all() {}
inline float ex2_approx(float x) { return exp2f(x); }
inline float rcp_approx(float x) { return 1.0f / x; }
}  // namespace ptx
"""


def _host_source() -> str:
    src = open(os.path.join(build.CSRC, "float_cdf.cu")).read()
    old = ("kernel<<<blocks, threads, 0, "
           "static_cast<cudaStream_t>(stream)>>>(args...);")
    assert old in src, f"float_cdf.cu no longer contains {old!r}"
    src = src.replace(old, "host_launch(blocks, threads, "
                           "[&] { kernel(args...); });")
    assert "<<<" not in src and "asm" not in src
    assert '#include "ptx.cuh"' in src
    return src


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """ctypes library of float_cdf.cu compiled for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile float_cdf.cu for the host")
    d = tmp_path_factory.mktemp("float_cdf_host")
    (d / "cuda_runtime.h").write_text(HOST_CUDA_H)
    (d / "ptx.cuh").write_text(HOST_PTX_H)     # found before csrc/ptx.cuh
    (d / "float_cdf_host.cpp").write_text(_host_source())
    out = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-fno-gnu-unique",   # threadIdx: one per library, not shared
         "-pthread", f"-I{d}", "-o", str(d / "libfloat_cdf.so"),
         str(d / "float_cdf_host.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert out.returncode == 0, out.stdout[-4000:]
    return build._bind("float_cdf", str(d / "libfloat_cdf.so"))


def _kernel_path(monkeypatch, lib):
    """Route the float_cdf launchers to `lib` on CPU tensors."""
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))


def _mixture(rng, P, K):
    """Mixtures over the pixel range, sharp and flat components mixed."""
    pi = rng.dirichlet(np.ones(K), size=P).astype(np.float32)
    mu = rng.uniform(-20, 280, (P, K)).astype(np.float32)
    inv_s = np.exp(-rng.uniform(-3, 4, (P, K))).astype(np.float32)
    return [torch.from_numpy(x) for x in (pi, mu, inv_s)]


def _increasing(q):
    rows = float_cdf.finish_rows(q)
    top = torch.full((rows.shape[0], 1), 65536)
    return bool((torch.diff(torch.cat([rows, top], 1), dim=1) >= 1).all())


# K1's tile holds 64 pixels: several tiles with a ragged last one, one
# whole tile, one pixel, one pixel over four tiles, one pixel short of two;
# L = 16 and 32 take the 16-byte stores, the others the scalar ones with a
# padded last group of edges; K from 1 to the tile's 10; K = 12 and 16 or
# L = 40 the generic variant
@pytest.mark.parametrize("P,K,L", [(300, 10, 16), (64, 3, 25), (1, 10, 16),
                                   (257, 4, 16), (127, 10, 32), (128, 1, 1),
                                   (70, 7, 17), (200, 10, 6), (300, 12, 16),
                                   (65, 16, 25), (130, 10, 40),
                                   (70, 16, 40)])
def test_mixture_cdf_q_source_matches_plain_and_pallas(
        host_lib, monkeypatch, P, K, L):
    """K1 of float_cdf.cu: <= 1 step from the plain version and from the
    Pallas kernel; one launch; rows strictly increasing."""
    pi, mu, inv_s = _mixture(np.random.RandomState(P + K), P, K)
    t = torch.arange(L, dtype=torch.float32) * (256.0 / L) - 0.5
    want = float_cdf.mixture_cdf_q_plain(pi, mu, inv_s, t, L)
    pls = np.asarray(pallas_cdf.mixture_cdf_quantized(
        jnp.asarray(pi.numpy()), jnp.asarray(mu.numpy()),
        jnp.asarray(inv_s.numpy()), t.numpy(), L, interpret=True))
    n0 = kernels.launches["mixture_cdf_q"]
    with monkeypatch.context() as m:
        _kernel_path(m, host_lib)
        got = kernels.mixture_cdf_q(pi, mu, inv_s, t, L)
    assert kernels.launches["mixture_cdf_q"] == n0 + 1
    assert got.shape == (P, L) and got.dtype == torch.int32
    d = (got - want).abs()
    print(f"K1: {int((d > 0).sum())} of {d.numel()} entries "
          "differ from the plain version")
    assert int(d.max()) <= 1
    assert np.abs(got.numpy().astype(np.int64) - pls).max() <= 1
    assert _increasing(got)


def _fine_inputs(P, K, seed):
    """Parameters and coarse symbols (the bin of component 0's mean), both
    tail bins present from 16 pixels on."""
    pi, mu, inv_s = _mixture(np.random.RandomState(seed), P, K)
    if P >= 16:
        mu[0, 0], mu[P - 1, 0] = 3.0, 250.0
    a = torch.from_numpy(np.clip(mu[:, 0].numpy() / 16.0, 0, 15)
                         .astype(np.int64)).to(torch.float32)
    return pi, mu, inv_s, a


# K2's tile holds 128 pixels: ragged last tiles, one pixel, one whole
# tile, one pixel over and one short of a tile
@pytest.mark.parametrize("P", [625, 1, 300, 128, 129, 127])
def test_fine_cdf_q_source_matches_plain_and_pallas(host_lib, monkeypatch,
                                                    P):
    """K2 of float_cdf.cu: <= 2 steps from the plain version and from the
    Pallas kernel on well-conditioned rows; one launch; rows strictly
    increasing; a = 0 and a = 15 (the tail absorption) among the pixels."""
    _fine_matches_plain_and_pallas(host_lib, monkeypatch, P, 10)


@pytest.mark.parametrize("P,K", [(300, 12), (129, 16)])
def test_fine_cdf_q_source_beyond_ten_components(host_lib, monkeypatch, P,
                                                 K):
    """K2's generic variant (K > 10), held as the tiled kernel is."""
    _fine_matches_plain_and_pallas(host_lib, monkeypatch, P, K)


def _fine_matches_plain_and_pallas(host_lib, monkeypatch, P, K):
    bw, t0 = 1.0, -0.5
    pi, mu, inv_s, a = _fine_inputs(P, K, P)
    if P >= 16:
        assert (a == 0).any() and (a == 15).any()
    want = float_cdf.fine_cdf_q_plain(pi, mu, inv_s, a, bw, t0)
    pls = torch.from_numpy(np.array(pallas_cdf.fine_cdf_quantized(
        jnp.asarray(pi.numpy()), jnp.asarray(mu.numpy()),
        jnp.asarray(inv_s.numpy()), jnp.asarray(a.numpy()), bw, t0, 16, 16,
        interpret=True)))
    n0 = kernels.launches["fine_cdf_q"]
    with monkeypatch.context() as m:
        _kernel_path(m, host_lib)
        got = kernels.fine_cdf_q(pi, mu, inv_s, a, bw, t0)
    assert kernels.launches["fine_cdf_q"] == n0 + 1
    assert got.shape == (P, 16) and got.dtype == torch.int32
    t = (a[:, None] * 16.0 + torch.arange(17.0)) * bw + t0
    cv = float_cdf.edge_cdf(pi, mu, inv_s, t)
    good = (cv[:, -1] - cv[:, 0]) > 1e-2
    if P > 1:
        assert good.sum() > P // 4
    d = (got - want).abs()[good]
    print(f"K2: {int((d > 0).sum())} of {d.numel()} entries of "
          "well-conditioned rows differ from the plain version")
    if good.any():
        assert int(d.max()) <= 2
        assert int((got - pls).abs()[good].max()) <= 2
    assert _increasing(got)


def test_dispatch_and_misaligned_bases(host_lib, monkeypatch):
    """The dispatching wrappers of ops/float_cdf.py reach the kernels;
    parameter arrays that start off a 16-byte boundary take the 4-byte
    copies and give the same rows."""
    P, K, L = 130, 10, 16
    pi, mu, inv_s, a = _fine_inputs(P + 1, K, 7)
    t = torch.arange(L, dtype=torch.float32) * 16.0 - 0.5
    # rows 1.. of a (P + 1, K) array: contiguous, 40 bytes into it
    off = [x[1:] for x in (pi, mu, inv_s)]
    assert all(x.is_contiguous() and x.data_ptr() % 16 for x in off)
    al = [x.clone() for x in off]
    n0 = dict(kernels.launches)
    with monkeypatch.context() as m:
        _kernel_path(m, host_lib)
        k1 = [float_cdf.mixture_cdf_q(*x, t, L) for x in (off, al)]
        k2 = [float_cdf.fine_cdf_q(*x, a[1:], 1.0, -0.5) for x in (off, al)]
    assert kernels.launches["mixture_cdf_q"] == n0.get("mixture_cdf_q", 0) + 2
    assert kernels.launches["fine_cdf_q"] == n0.get("fine_cdf_q", 0) + 2
    assert torch.equal(*k1) and torch.equal(*k2)
    assert int((k1[0] - float_cdf.mixture_cdf_q_plain(*al, t, L)).abs()
               .max()) <= 1


@pytest.mark.parametrize("K,L,what", [(0, 16, "K=0"), (10, 0, "L=0"),
                                      (0, 0, "K=0")])
def test_wrappers_refuse_sizes_outside_the_kernels_domain(host_lib,
                                                          monkeypatch, K, L,
                                                          what):
    """No component or no edge raises for a CUDA tensor: no launch and no
    plain version in the kernels' place. (K1 and K2 take any K >= 1 and K1
    any L >= 1: beyond the tiles' K = 10 and L = 32 the generic variants
    run, as test_mixture_cdf_q_source_matches_plain_and_pallas and
    test_fine_cdf_q_source_matches_plain_and_pallas show.)"""
    f = torch.zeros((4, K))
    n0 = dict(kernels.launches)
    with monkeypatch.context() as m:
        _kernel_path(m, host_lib)
        m.setattr(float_cdf, "mixture_cdf_q_plain", None)
        m.setattr(float_cdf, "fine_cdf_q_plain", None)
        with pytest.raises(ValueError, match=what):
            float_cdf.mixture_cdf_q(f, f, f, torch.zeros(L), L)
        if K < 1:
            with pytest.raises(ValueError, match=what):
                float_cdf.fine_cdf_q(f, f, f, torch.zeros(4), 1.0, -0.5)
    assert dict(kernels.launches) == n0
