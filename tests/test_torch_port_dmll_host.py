"""K6 (csrc/dmll.cu: the mixture NLL and its gradient) run on the CPU,
against the plain version (models/dmll.nll_plain and its autograd
gradient).

There is no CUDA compiler here, so the test compiles dmll.cu with g++
against the host header of test_torch_port_float_cdf_host.py: each block
runs as its threads' std::threads, `__syncthreads` is a barrier, the
block's dynamic shared memory a static array, a warp shuffle an exchange
between two barriers, and the PTX of csrc/ptx.cuh (cp.async) plain
copies. The library is bound in place of build.library("dmll"), with
tensors reporting is_cuda, so dmll.nll takes the kernel's path (its
autograd.Function, forward and backward) on CPU memory. This checks the
tiles (ragged, one pixel, several images with HW no multiple of the
tile), the 16-byte and the 4-byte copies, the shuffled sums over k, the
swizzled rows, the slots the backward overwrites and the grad_x sums; what
only the card can show (the CUDA compiler, cp.async itself, the card's
expf, speed) chip_smoke.py and tests/test_torch_port_kernels.py check
there.

Tolerances (test_torch_port_kernels.assert_nll_close / assert_grad_close).
The kernel evaluates the plain version's expression in its order within a
term, its sums over k in another; what differs besides is the libraries'
exp / log1p / log (glibc here, PyTorch's vectorised ones in the plain
version), ~1 ulp apart, and the order of the gradient's products: every
nll element within 1e-5 relative + 1e-6, every grad_l and grad_x entry
within 1e-5 of the tensor's largest magnitude, each plus its
float32_spread of two roundings (non-zero only where a term is
ill-conditioned); each sum within 1e-6 relative.
"""
import os
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from l3c_torch.models import dmll
from l3c_torch.ops import kernels
from l3c_torch.ops.kernels import build
from tests.test_torch_port_kernels import (assert_grad_close,
                                          assert_nll_close,
                                          dmll_grads as _grads, dmll_inputs,
                                          float32_spread)
from tests.test_torch_port_float_cdf_host import HOST_CUDA_H, HOST_PTX_H

torch.set_num_threads(1)

RGB = dmll.DMLLSpec(True)
BN = dmll.DMLLSpec(False, -1.0, 1.0, 25)


def _host_source(split: int = 0) -> str:
    """dmll.cu for the host; with `split`, kSplit (lanes a pixel's
    channel) rewritten to it."""
    src = open(os.path.join(build.CSRC, "dmll.cu")).read()
    if split:
        old = "constexpr int kSplit = 2;"
        assert old in src, f"dmll.cu no longer contains {old!r}"
        src = src.replace(old, f"constexpr int kSplit = {split};")
    for lam in ("true", "false"):
        old = (f"dmll_kernel<GRAD, {lam}><<<grid, threads, bytes, "
               "stream>>>(A);")
        assert old in src, f"dmll.cu no longer contains {old!r}"
        src = src.replace(old, "host_launch(grid, threads, [&] { "
                               f"dmll_kernel<GRAD, {lam}>(A); }});")
        old = (f"dmll_generic<GRAD, {lam}><<<blocks, kGenericThreads, 0, "
               "stream>>>(A, n);")
        assert old in src, f"dmll.cu no longer contains {old!r}"
        src = src.replace(old, "host_launch(blocks, kGenericThreads, [&] { "
                               f"dmll_generic<GRAD, {lam}>(A, n); }});")
    dyn = "extern __shared__ __align__(16) float smem[];"
    assert dyn in src, f"dmll.cu no longer contains {dyn!r}"
    src = src.replace(dyn, "__shared__ __align__(16) float smem[1 << 14];")
    assert "<<<" not in src and "asm" not in src
    assert '#include "ptx.cuh"' in src
    return src


def _compile(tmp_path_factory, split: int = 0):
    """ctypes library of dmll.cu (kSplit rewritten to `split`) compiled
    for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile dmll.cu for the host")
    d = tmp_path_factory.mktemp("dmll_host")
    (d / "cuda_runtime.h").write_text(HOST_CUDA_H)
    (d / "ptx.cuh").write_text(HOST_PTX_H)     # found before csrc/ptx.cuh
    (d / "dmll_host.cpp").write_text(_host_source(split))
    out = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-fno-gnu-unique",   # threadIdx: one per library, not shared
         "-pthread", f"-I{d}", "-o", str(d / "libdmll.so"),
         str(d / "dmll_host.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert out.returncode == 0, out.stdout[-4000:]
    return build._bind("dmll", str(d / "libdmll.so"))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _compile(tmp_path_factory)


def _kernel_path(monkeypatch, lib):
    """Route dmll.nll to the kernels of `lib` on CPU tensors."""
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))


def _matches_plain(lib, monkeypatch, rgb, K, C, N, H, W, seed):
    spec = RGB if rgb else BN
    x, l = dmll_inputs(rgb, K, seed, N=N, H=H, W=W, C=C)
    g = torch.from_numpy(np.random.RandomState(1).rand(*x.shape)
                         .astype(np.float32))
    want = _grads(dmll.nll_plain, spec, x, l, g)
    kernels.reset_launches()
    with monkeypatch.context() as m:
        _kernel_path(m, lib)
        got = _grads(dmll.nll, spec, x, l, g)
    assert dict(kernels.launches) == {"dmll_nll": 1, "dmll_nll_grad": 1}
    spread = float32_spread(spec, x, l, g)
    assert_nll_close(got[0], want[0], spread[0])
    assert_grad_close("grad_l", got[1], want[1], spread[1])
    assert_grad_close("grad_x", got[2], want[2], spread[2])
    return spec, x, l, g


@pytest.mark.parametrize("rgb,K,C,H", [(True, 10, 3, 37), (False, 10, 5, 37),
                                       (True, 2, 3, 7), (False, 3, 2, 7)])
def test_dmll_source_matches_plain(host_lib, monkeypatch, rgb, K, C, H):
    """K6 forward and backward against the plain version and its autograd
    gradient: both tails, log-scales below and at -7, the lambda path;
    exactly one forward and one backward launch."""
    spec, x, l, g = _matches_plain(host_lib, monkeypatch, rgb, K, C, 2, H,
                                   53, 10 * K + C)
    # the lambda terms move channels 0 and 1 of grad_x on the RGB scale
    if rgb:
        x0 = _grads(dmll.nll_plain, spec, x, l,
                    g * torch.tensor([0.0, 1.0, 1.0]))[2]
        assert float(x0[..., 0].abs().max()) > 0


# around the kernel's tile of 32 pixels: one pixel; several images whose
# HW is no multiple of the tile nor of 4 (4-byte copies); HW a multiple of
# 4 with a ragged last tile and whole tiles only (16-byte copies); K = 3
# and 10, C = 3 with lambda and C = 5
@pytest.mark.parametrize("rgb,K,C,N,H,W", [
    (True, 10, 3, 1, 1, 1), (False, 10, 5, 3, 5, 7), (True, 3, 3, 3, 5, 7),
    (False, 3, 5, 2, 4, 13), (True, 10, 3, 2, 4, 13),
    (False, 10, 5, 2, 16, 12), (True, 10, 3, 1, 8, 16)])
def test_dmll_source_ragged_tiles(host_lib, monkeypatch, rgb, K, C, N, H, W):
    """K6 against the plain version at shapes around its tile, each with
    both tails and log-scales at -7 (exact ties of the clamp)."""
    _matches_plain(host_lib, monkeypatch, rgb, K, C, N, H, W, N * H * W + K)


@pytest.mark.parametrize("split", [1, 4])
def test_dmll_source_results_do_not_depend_on_the_split(
        host_lib, tmp_path_factory, monkeypatch, split):
    """Every output bit of K6 is the same whether 1, 2 (the source's) or
    4 lanes share a pixel's channel: the sums over k run k ascending
    whoever holds the terms, so the kernel gives what one thread a
    (pixel, channel) summing k in order gives."""
    other = _compile(tmp_path_factory, split)
    for rgb, K, C, N, H, W in ((True, 10, 3, 2, 9, 13), (False, 3, 5, 2, 4, 9),
                               (False, 10, 5, 1, 8, 8)):
        spec = RGB if rgb else BN
        x, l = dmll_inputs(rgb, K, 7 + K, N=N, H=H, W=W, C=C)
        g = torch.from_numpy(np.random.RandomState(2).rand(*x.shape)
                             .astype(np.float32))
        got = {}
        for name, lib in (("2", host_lib), (str(split), other)):
            with monkeypatch.context() as m:
                _kernel_path(m, lib)
                got[name] = _grads(dmll.nll, spec, x, l, g)
        for a, b in zip(*got.values()):
            assert torch.equal(a, b), (rgb, K, C, N, H, W)


def test_dmll_reads_the_nchw_planes_in_place(host_lib, monkeypatch):
    """The training forward hands l as the NHWC view of the classifier's
    NCHW output: K6 reads it without a copy and returns grad_l as the same
    view; an NHWC-contiguous l (the eval forward's) gives the same
    numbers."""
    x, l = dmll_inputs(False, 10, 5)
    l_nchw = l.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    view = l_nchw.permute(0, 2, 3, 1)
    with monkeypatch.context() as m:
        _kernel_path(m, host_lib)
        out = dmll.nll(BN, x, view)
        out.sum().backward()
        ref = _grads(dmll.nll, BN, x, l, torch.ones_like(x))
    assert torch.equal(out.detach(), ref[0])
    assert l_nchw.grad.is_contiguous()
    assert torch.equal(l_nchw.grad.permute(0, 2, 3, 1), ref[1])


def test_dmll_kernel_refuses_what_it_does_not_take(monkeypatch):
    """A CPU tensor takes the plain version through nll; the launchers
    themselves refuse CPU tensors and inconsistent shapes."""
    x, l = dmll_inputs(True, 2, 0)
    kernels.reset_launches()
    torch.testing.assert_close(dmll.nll(RGB, x, l), dmll.nll_plain(RGB, x, l),
                               rtol=0, atol=0)
    assert not kernels.launches
    l_nchw = l.permute(0, 3, 1, 2).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dmll_nll(l_nchw, x, True, 0.5, 0.001, 254.999)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(ValueError, match="planes"):
        kernels.dmll_nll(l_nchw[:, :-1].contiguous(), x, True, 0.5, 0.001,
                         254.999)
    with pytest.raises(ValueError, match="match"):
        kernels.dmll_nll(l_nchw, x[:, :-1].contiguous(), True, 0.5, 0.001,
                         254.999)


def test_dmll_kernel_takes_at_most_eight_channels(host_lib, monkeypatch):
    """A block of K6 runs 2 x 32 C threads, so it takes at most eight
    channels (kMaxC); a larger q.C runs one launch a group of eight behind
    the same wrapper call. C = 8 and 9 match the plain version through
    the wrappers."""
    _matches_plain(host_lib, monkeypatch, False, 2, 8, 1, 3, 5, 8)
    _matches_plain(host_lib, monkeypatch, False, 2, 9, 1, 3, 5, 9)


# q.C = 9 and 16 (two groups of channels, the second ragged or whole) at
# K <= 10; K = 12 and 16 (the generic variant) on both scales' layouts,
# with a ragged tile's worth of pixels
@pytest.mark.parametrize("rgb,K,C,N,H,W", [
    (False, 10, 9, 2, 5, 7), (False, 3, 16, 1, 8, 9),
    (True, 12, 3, 2, 5, 7), (False, 12, 5, 1, 4, 13),
    (True, 16, 3, 1, 6, 6), (False, 16, 9, 1, 3, 5)])
def test_dmll_source_beyond_the_tile(host_lib, monkeypatch, rgb, K, C, N, H,
                                     W):
    """K6 where the JAX package's sizes pass the tile's (C > 8, K > 10)
    against the plain version at the same bounds; one launch each way."""
    _matches_plain(host_lib, monkeypatch, rgb, K, C, N, H, W, 3 * K + C)


def test_dmll_channel_groups_are_the_one_group_kernel(host_lib, monkeypatch):
    """q.C = 16 runs two launches of eight channels: each group's outputs
    are those of a C = 8 call on its channels alone, bit for bit
    (bottleneck channels do not interact)."""
    spec = BN
    x, l = dmll_inputs(False, 4, 5, N=2, H=5, W=7, C=16)
    g = torch.from_numpy(np.random.RandomState(3).rand(*x.shape)
                         .astype(np.float32))
    K = 4
    lg = l.reshape(*l.shape[:3], 3, 16, K)
    with monkeypatch.context() as m:
        _kernel_path(m, host_lib)
        whole = _grads(dmll.nll, spec, x, l, g)
        for c0 in (0, 8):
            sub = lg[..., c0:c0 + 8, :].reshape(*l.shape[:3], -1)
            part = _grads(dmll.nll, spec, x[..., c0:c0 + 8].contiguous(),
                          sub.contiguous(), g[..., c0:c0 + 8].contiguous())
            assert torch.equal(part[0], whole[0][..., c0:c0 + 8])
            gl = whole[1].reshape(*l.shape[:3], 3, 16, K)[..., c0:c0 + 8, :]
            assert torch.equal(part[1], gl.reshape(*l.shape[:3], -1))
            assert torch.equal(part[2], whole[2][..., c0:c0 + 8])
