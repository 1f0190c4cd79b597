"""The pack_int kernel's source (csrc/pack.cu) run on the CPU, against the
plain version (ops/int_coder.pack_int_params), and the NCHW route of the
plain version against its NHWC route and against JAX.

There is no CUDA compiler here, so the test compiles pack.cu with g++
against a small header that maps the CUDA constructs the file uses onto
the host: the kernel has no shared memory and no barrier, so a launch is
a loop over the grid's blocks and threads. The library is bound in place
of build.library("pack"), with tensors reporting is_cuda, so the codec's
pack_int takes the kernel's path on CPU memory. This checks the kernel's
plane arithmetic, the selection, the lambda slots and its rounding
against the plain version; what only the card can show (the CUDA compiler,
the card's expf, speed) chip_smoke.py and tests/test_torch_port_kernels.py
check there.

Bound between kernel and plain version, the one
test_torch_port_int_coder.py::test_pack_int_params_vs_jax holds between
JAX and the port: the selection is comparisons only and must be exact
(every mu entry is then the selected value itself: v differs by at most
one step); the float part (expf against torch.exp, the order of the
softmax's sum, the division by the bin width) may move an entry by one
step at a rounding boundary, in at most 1e-3 of the entries.
"""
import os
import shutil
import subprocess
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l3c_tpu.models import dmll as jdmll
from l3c_tpu.ops import int_coder as jic
from l3c_torch import config as tcfg
from l3c_torch.codec import bitcoding2 as b2
from l3c_torch.models import dmll as tdmll
from l3c_torch.models.network import MultiscaleNetwork
from l3c_torch.ops import int_coder as ic
from l3c_torch.ops import kernels
from l3c_torch.ops.kernels import build

torch.set_num_threads(1)

HOST_CUDA_H = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
inline dim3 threadIdx, blockIdx;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
template <class F> void host_launch(dim3 grid, int threads, F body) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx)
      for (int t = 0; t < threads; ++t) {
        blockIdx = dim3(bx, by);
        threadIdx = dim3(t);
        body();
      }
}
"""

RGB = tdmll.DMLLSpec(True)
BN = tdmll.DMLLSpec(False, -1.0, 1.0, 25)


def _host_source() -> str:
    src = open(os.path.join(build.CSRC, "pack.cu")).read()
    for kernel in ("pack_int_kernel<KP, LAM>", "pack_int_generic<LAM>"):
        old = f"{kernel}<<<grid, kThreads, 0, stream>>>(A);"
        assert old in src, f"pack.cu no longer contains {old!r}"
        src = src.replace(old, "host_launch(grid, kThreads, [&] { "
                               f"{kernel}(A); }});")
    assert "<<<" not in src
    return src


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """ctypes library of pack.cu compiled for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile pack.cu for the host")
    d = tmp_path_factory.mktemp("pack_host")
    (d / "cuda_runtime.h").write_text(HOST_CUDA_H)
    (d / "pack_host.cpp").write_text(_host_source())
    out = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-fno-gnu-unique",   # threadIdx: one per library, not shared
         f"-I{d}", "-o", str(d / "libpack.so"), str(d / "pack_host.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert out.returncode == 0, out.stdout[-4000:]
    return build._bind("pack", str(d / "libpack.so"))


def _kernel_path(monkeypatch, lib):
    """Route the pack_int launcher to `lib` on CPU tensors."""
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))


def _logits(rgb, K, seed, N=2, H=9, W=13, deep=True):
    """Classifier output (N,Kp,H,W): random logits with exact ties among
    the pi logits of a fifth of the pixels and, with `deep`, log-scales
    far below the -7 clamp in another fifth (sharp components: a_hat at
    its upper clamp, v large)."""
    rng = np.random.RandomState(seed)
    C = 3 if rgb else 5
    P = 4 if rgb else 3
    l = (rng.randn(N, P, C, K, H, W) * 2.0).astype(np.float32)
    ties = rng.rand(N, 1, C, 1, H, W) < 0.2
    l[:, 0:1] = np.where(ties, np.round(l[:, 0:1]), l[:, 0:1])
    sharp = (rng.rand(N, 1, C, K, H, W) < 0.2) & deep
    l[:, 2:3] = np.where(sharp, l[:, 2:3] * 4 - 9, l[:, 2:3])
    return torch.from_numpy(l.reshape(N, P * C * K, H, W)), C


def _compare(got, want):
    """(entries differing, entries) over all fields; every difference one
    step at most."""
    n_bad = n_all = 0
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and g.dtype == w.dtype
        d = (g - w).abs()
        assert float(d.max()) <= 1
        n_bad += int((d > 0).sum())
        n_all += d.numel()
    return n_bad, n_all


@pytest.mark.parametrize("rgb,K,topk", [
    (True, 10, 4), (True, 10, 0), (False, 10, 4), (False, 10, 0),
    (True, 2, 4), (False, 7, 3), (False, 3, 0), (True, 12, 4),
    (True, 16, 0), (False, 12, 0), (False, 16, 4)])
def test_pack_source_matches_plain(host_lib, monkeypatch, rgb, K, topk):
    """K5 of pack.cu against the plain version: K' = 4 and 10 registers,
    K = 12 and 16 the generic variant, with and without the lambda slots,
    selection and no selection. The
    selected components must be the plain version's exactly; the integer
    outputs within one step in <= 1e-3 of the entries."""
    spec = RGB if rgb else BN
    l, C = _logits(rgb, K, 100 + K + topk)
    want = ic.pack_int_params_nchw(spec, l, C, topk)
    before = kernels.launches["pack_int"]
    with monkeypatch.context() as m:
        _kernel_path(m, host_lib)
        got = b2.pack_int(spec, l, C, topk)
    assert kernels.launches["pack_int"] == before + 1
    n_bad, n_all = _compare(got, want)
    print(f"pack.cu vs plain rgb={rgb} K={K} topk={topk}: {n_bad}/{n_all} "
          f"entries differ by one step")
    assert n_bad <= 1e-3 * n_all
    # the selection itself: a kernel that picked another component would
    # move v (= the selected mu, scaled) by far more than one step, which
    # _compare refused; hold the indices directly too, through mu with
    # log-scales and pi logits that make a_hat and the softmax exact
    if topk and K > topk:
        P = 4 if rgb else 3
        lx = l.reshape(l.shape[0], P, C, K, -1).clone()
        lx[:, 1] = torch.arange(K, dtype=torch.float32)[None, None, :, None]
        lx[:, 2] = 0.0
        lx = lx.reshape(l.shape)
        idx = ic.topk_index(ic.topk_rank(
            lx.reshape(l.shape[0], P, C, K, -1)[:, 0].permute(1, 2, 0, 3)
            .reshape(C, K, -1)), topk)
        with monkeypatch.context() as m:
            _kernel_path(m, host_lib)
            v = b2.pack_int(spec, lx, C, topk).v
        # mu = k, inv_s = 1: v = round((k - t0) / bw * a_hat * 1024) is
        # strictly increasing in k, so equal v means equal index
        t0 = spec.x_min - spec.bin_width / 2.0
        a_hat = min(max(spec.bin_width, ic.A_MIN), ic.A_MAX)
        want_v = torch.round((idx.float() - t0) / spec.bin_width * a_hat
                             * 1024.0)
        assert float((v - want_v).abs().max()) <= 1
        step = a_hat / spec.bin_width * 1024.0
        assert step > 4          # indices are told apart by far


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("rgb,topk", [(True, 0), (True, 4), (False, 0),
                                      (False, 4)])
def test_pack_nchw_route_bitwise_and_vs_jax(rgb, topk, deep):
    _pack_nchw_route_vs_jax(rgb, 10, topk, deep, bitwise=True)


@pytest.mark.parametrize("rgb,K,topk", [(True, 12, 4), (True, 16, 0),
                                        (False, 12, 0), (False, 16, 4)])
def test_pack_plain_vs_jax_beyond_ten_components(rgb, K, topk):
    """The plain version meets JAX at K = 12 and 16, where the kernel runs
    its generic variant (held to the plain version above). (Its NCHW and
    NHWC routes are not bitwise equal at K = 16 on the CPU: PyTorch's
    reductions over K vectorise otherwise on the two layouts.)"""
    _pack_nchw_route_vs_jax(rgb, K, topk, False, bitwise=False)


def _pack_nchw_route_vs_jax(rgb, K, topk, deep, bitwise):
    """The plain version on the classifier's NCHW output gives what it
    gives on the NHWC tensor bit for bit on the CPU (the NHWC entry hands
    a view to the NCHW one), and hence JAX's within the bound of
    test_pack_int_params_vs_jax (one step, <= 1e-3 of the entries).

    With sharp components (`deep`: a_hat at its clamp, |v| up to 2^21) the
    bound on v is 1e-2: XLA compiles the JAX package's division by the
    constant bin width into a product with its float32 reciprocal (12 for
    the bn scales), which rounds otherwise than a division in a quarter of
    the values, and an ulp of v is then a good part of a step. Measured
    here: up to 5e-3 of the bn v entries, none at bin width 1 (RGB). The
    port divides all the same: the JAX package's header canary, whose
    constant inputs XLA folds, attests the division, and with the product
    the port's CPU canary is no longer the JAX package's."""
    spec = RGB if rgb else BN
    l, C = _logits(rgb, K, 7 + topk, deep=deep)
    l_nhwc = l.permute(0, 2, 3, 1).contiguous()
    got = ic.pack_int_params_nchw(spec, l, C, topk)
    for g, w in zip(got, ic.pack_int_params(spec, l_nhwc, C, topk)):
        assert (g is None and w is None) or not bitwise or torch.equal(g, w)
    js = jdmll.DMLLSpec(True) if rgb else jdmll.DMLLSpec(False, -1.0, 1.0,
                                                          25)
    want = jax.jit(lambda x: jic.pack_int_params(js, x, C, topk))(
        jnp.asarray(l_nhwc.numpy()))
    want = ic.IntParams(*[None if w is None else
                          torch.from_numpy(np.array(w)) for w in want])
    n_v, all_v = _compare([got.v], [want.v])
    n_bad, n_all = _compare(got._replace(v=None), want._replace(v=None))
    print(f"pack_int_params_nchw vs JAX rgb={rgb} K={K} topk={topk} "
          f"deep={deep}: "
          f"v {n_v}/{all_v}, other fields {n_bad}/{n_all} entries differ")
    assert n_bad <= 1e-3 * n_all
    assert n_v <= (1e-2 if deep else 1e-3) * all_v


def test_pack_int_dispatches_on_the_device():
    """A CPU tensor takes the plain version; the launcher itself refuses
    it (no quiet way from the card to the plain version or back)."""
    l, C = _logits(False, 10, 3)
    before = kernels.launches["pack_int"]
    got = b2.pack_int(BN, l, C, 4)
    assert kernels.launches["pack_int"] == before
    for g, w in zip(got, ic.pack_int_params_nchw(BN, l, C, 4)):
        assert (g is None and w is None) or torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pack_int(l, C, 4, False, BN.bin_width, -1.0)


def test_codec_round_trip_through_pack_source(host_lib, monkeypatch,
                                              tmp_path):
    """A tiny model's codec round with the float pack stage through the
    host-built kernel (the rANS coders through their plain versions):
    bit-exact, six launches (three scales, encode and decode), and the
    canary attests the kernel: it packs through it too."""
    cfg = tcfg.MsConfig(num_scales=3, Cf=8, enc=tcfg.EncConfig(num_blocks=1),
                        dec=tcfg.DecConfig(num_blocks=1),
                        q=tcfg.QConfig(C=5, L=25), prob=tcfg.ProbConfig(K=10))
    torch.manual_seed(0)
    bc = b2.TorchBitcoding(cfg, MultiscaleNetwork(cfg), device="cpu")
    imgs = [np.random.RandomState(i).randint(0, 256, (1, 21, 19, 3))
            .astype(np.uint8) for i in range(3)]
    paths = [str(tmp_path / f"k{i}") for i in range(3)]

    dispatch = b2.pack_int

    def pack_int(*args):
        with monkeypatch.context() as m:
            _kernel_path(m, host_lib)
            return dispatch(*args)

    monkeypatch.setattr(b2, "pack_int", pack_int)
    kernels.reset_launches()
    bc.encode_batch(imgs, paths)
    assert kernels.launches["pack_int"] == 3 + 2       # 3 scales + canary
    outs = bc.decode_batch(paths)
    assert dict(kernels.launches) == {"pack_int": 8}
    for img, out in zip(imgs, outs):
        np.testing.assert_array_equal(out, img)
