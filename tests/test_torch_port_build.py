"""The kernels' ctypes binding: signatures come from the CUDA sources, and
every wrapper passes its launcher the arguments the source declares.

Runs on the CPU: the C launchers are replaced by recorders, so nothing is
compiled or launched.
"""
import ctypes
import os
import types

import pytest
import torch

from l3c_torch.ops import int_coder as ic, kernels
from l3c_torch.ops.kernels import build

torch.set_num_threads(1)

LAUNCHERS = {"float_cdf": {"l3c_mixture_cdf_q", "l3c_fine_cdf_q"},
             "rans": {"l3c_rans_encode", "l3c_rans_decode"},
             "pack": {"l3c_pack_int"},
             "dmll": {"l3c_dmll_nll", "l3c_dmll_nll_grad"}}


@pytest.mark.parametrize("name", build.SOURCES)
def test_signatures_parsed_from_source(name):
    sigs = build.signatures(name)
    assert set(sigs) == LAUNCHERS[name]
    for argtypes in sigs.values():
        # pointers first, the stream last, all of a type ctypes can pass
        assert argtypes[0] is ctypes.c_void_p
        assert argtypes[-1] is ctypes.c_void_p
        assert set(argtypes) <= {ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_float}


def test_signature_parser_refuses_unknown_types(tmp_path, monkeypatch):
    (tmp_path / "odd.cu").write_text(
        'extern "C" int l3c_odd(const void* a, double b, void* stream) {}')
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    with pytest.raises(ValueError, match="double"):
        build.signatures("odd")


class _Recorder:
    def __init__(self, argtypes, calls, fn):
        self.argtypes, self.calls, self.fn = argtypes, calls, fn

    def __call__(self, *args):
        self.calls.append((self.fn, args))
        return 0


def _cpu_as_cuda(monkeypatch):
    """Let the wrappers run on CPU tensors against recorded launchers."""
    calls = []

    def fake_library(name):
        return types.SimpleNamespace(**{
            fn: _Recorder(at, calls, fn)
            for fn, at in build.signatures(name).items()})

    monkeypatch.setattr(build, "library", fake_library)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


def test_wrappers_pass_declared_arguments(monkeypatch):
    calls = _cpu_as_cuda(monkeypatch)
    P, K, L = 3, 2, 16
    f = torch.zeros((P, K))
    kernels.mixture_cdf_q(f, f, f, torch.zeros(L), L)
    kernels.fine_cdf_q(f, f, f, torch.zeros(P), 1.0, -0.5)
    # F = 2 groups of n = 3 pixels per channel, one stream each (T = 8)
    rgb = ic.IntParams(*[torch.zeros((3, K, 6)) for _ in range(5)])
    bn = ic.IntParams(*[torch.zeros((5, K, 6)) for _ in range(4)], None)
    u3 = torch.zeros((3, 6), dtype=torch.uint8)
    u5 = torch.zeros((5, 6), dtype=torch.uint8)
    words = lambda lanes: torch.zeros((lanes, 4), dtype=torch.int32)
    kernels.rans_encode("uniform", u5, 6, 8, 25)
    kernels.rans_encode("bn", u5, 3, 8, 25, bn, 2)
    kernels.rans_encode("rgb", u3, 3, 8, 16, rgb, 2)
    kernels.rans_decode("uniform", words(5), 6, 8, 25)
    kernels.rans_decode("bn", words(10), 3, 8, 25, bn, 2)
    kernels.rans_decode("rgb_coarse", words(2), 3, 8, 16, rgb, 2, 0)
    kernels.rans_decode("rgb_fine", words(2), 3, 8, 16, rgb, 2, 2, u3,
                        torch.zeros(6, dtype=torch.uint8))
    # the classifier's planes: (N, Kp, H, W), Kp = groups x C x K
    out = kernels.pack_int(torch.zeros((2, 4 * 3 * K, 1, 3)), 3, 0, True,
                           1.0, -0.5)
    assert [tuple(x.shape) for x in out] == [(3, K, 6)] * 5
    out = kernels.pack_int(torch.zeros((2, 3 * 5 * 10, 1, 3)), 5, 4, False,
                           0.08, -1.04)
    assert [tuple(x.shape) for x in out[:4]] == [(5, 4, 6)] * 4
    assert out[4] is None
    # K6: the classifier's planes and the NHWC target (bottleneck, C = 5)
    l = torch.zeros((2, 3 * 5 * K, 1, 3))
    x = torch.zeros((2, 1, 3, 5))
    assert kernels.dmll_nll(l, x, False, 0.04, -0.999, 0.999).shape == \
        x.shape
    gl, gx = kernels.dmll_nll_grad(l, x, x, False, 0.04, -0.999, 0.999)
    assert gl.shape == l.shape and gx.shape == x.shape
    assert [fn for fn, _ in calls] == [
        "l3c_mixture_cdf_q", "l3c_fine_cdf_q"] + ["l3c_rans_encode"] * 3 \
        + ["l3c_rans_decode"] * 4 + ["l3c_pack_int"] * 2 \
        + ["l3c_dmll_nll", "l3c_dmll_nll_grad"]
    sigs = {name: at for src in build.SOURCES
            for name, at in build.signatures(src).items()}
    for fn, args in calls:
        assert len(args) == len(sigs[fn])
        for a, t in zip(args, sigs[fn]):
            # an int slot never receives a pointer-sized value
            assert isinstance(a, float) == (t is ctypes.c_float)
            if t is ctypes.c_int:
                assert 0 <= a < 2 ** 31
    # the mode is the first int; the uniform mode passes no IntParams
    modes = [args[sigs[fn].index(ctypes.c_int)] for fn, args in calls[2:9]]
    assert modes == [0, 1, 2, 0, 1, 2, 3]
    assert calls[2][1][:5] == (None,) * 5
    # pack_int: (N, HW, C, K, K', lambda) after the six pointers; no w
    # pointer without the lambda slots
    assert calls[9][1][6:12] == (2, 3, 3, K, K, 1)
    assert calls[10][1][6:12] == (2, 3, 5, 10, 4, 0)
    assert calls[10][1][5] is None
    # K6: (N, HW, C, K, lambda) after its pointers, then the spec's floats
    assert calls[11][1][3:8] == (2, 3, 5, K, 0)
    assert calls[12][1][5:10] == (2, 3, 5, K, 0)


def test_wrappers_refuse_inconsistent_shapes(monkeypatch):
    _cpu_as_cuda(monkeypatch)
    bn = ic.IntParams(*[torch.zeros((5, 2, 6)) for _ in range(4)], None)
    u5 = torch.zeros((5, 6), dtype=torch.uint8)
    with pytest.raises(ValueError, match="pixels"):
        kernels.rans_encode("bn", u5, 4, 8, 25, bn, 2)      # F*n != N
    with pytest.raises(ValueError, match="groups"):
        kernels.rans_decode("bn", torch.zeros((9, 4), dtype=torch.int32),
                            3, 8, 25, bn, 2)               # 9 != 5 x 2
    with pytest.raises(ValueError, match="mode"):
        kernels.rans_encode("fine", u5, 3, 8, 25, bn, 2)
    with pytest.raises(ValueError, match="planes"):
        kernels.pack_int(torch.zeros((1, 31, 2, 2)), 5, 4, False, 0.08,
                         -1.04)                           # 31 != 3 x 5 x K
    with pytest.raises(ValueError, match="planes"):
        kernels.pack_int(torch.zeros((1, 40, 2, 2)), 5, 4, True, 1.0, -0.5)
    with pytest.raises(ValueError, match="planes"):
        kernels.dmll_nll(torch.zeros((1, 31, 2, 2)), torch.zeros(
            (1, 2, 2, 5)), False, 0.04, -0.999, 0.999)   # 31 != 3 x 5 x K
    with pytest.raises(ValueError, match="match"):
        kernels.dmll_nll(torch.zeros((1, 120, 2, 2)), torch.zeros(
            (1, 2, 3, 3)), True, 0.5, 0.001, 254.999)    # W 2 != 3
    with pytest.raises(ValueError, match="g"):
        kernels.dmll_nll_grad(torch.zeros((1, 120, 2, 2)), torch.zeros(
            (1, 2, 2, 3)), torch.zeros((1, 2, 2, 1)), True, 0.5, 0.001,
            254.999)


def test_wrappers_refuse_beyond_the_caps_that_remain(monkeypatch):
    """K3-K6 take K <= 255 (the JAX package's u8 component rank) and K3/K4
    L <= 256 symbols; beyond them the wrappers raise for a CUDA tensor and
    launch nothing (no plain version in the kernels' place)."""
    calls = _cpu_as_cuda(monkeypatch)
    K = kernels.MAX_K + 1
    bn = ic.IntParams(*[torch.zeros((1, K, 6)) for _ in range(4)], None)
    u1 = torch.zeros((1, 6), dtype=torch.uint8)
    words = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="256"):
        kernels.rans_encode("bn", u1, 3, 8, 25, bn, 2)
    with pytest.raises(ValueError, match="256"):
        kernels.rans_decode("bn", words, 3, 8, 25, bn, 2)
    L = kernels.MAX_L + 1
    with pytest.raises(ValueError, match=f"L={L}"):
        kernels.rans_encode("uniform", u1, 6, 8, L)
    with pytest.raises(ValueError, match=f"L={L}"):
        kernels.rans_decode("uniform", words[:1], 6, 8, L)
    with pytest.raises(ValueError, match="components"):
        kernels.pack_int(torch.zeros((1, 3 * K, 1, 2)), 1, 4, False, 0.08,
                         -1.04)
    with pytest.raises(ValueError, match="components"):
        kernels.dmll_nll(torch.zeros((1, 3 * K, 1, 2)),
                         torch.zeros((1, 1, 2, 1)), False, 0.04, -0.999,
                         0.999)
    assert calls == []


def test_call_refuses_wrong_argument_count(monkeypatch):
    _cpu_as_cuda(monkeypatch)
    with pytest.raises(TypeError, match="takes 17 arguments"):
        build.call("rans", "l3c_rans_encode", 0, 0, 0)


def test_library_name_hashes_included_headers(tmp_path, monkeypatch):
    """An edit to a header a source includes names a new library, so a
    stale build is never reused."""
    for f in ("rans.cu", "int_cdf.cuh"):
        (tmp_path / f).write_text(open(os.path.join(build.CSRC, f)).read())
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    assert build.sources_of("rans") == [str(tmp_path / "rans.cu"),
                                        str(tmp_path / "int_cdf.cuh")]
    before = build._lib_path("rans")
    with open(tmp_path / "int_cdf.cuh", "a") as f:
        f.write("// edited\n")
    assert build._lib_path("rans") != before
