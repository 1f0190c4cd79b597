"""The kernels' ctypes binding: signatures come from the CUDA sources, and
every wrapper passes its launcher the arguments the source declares.

Runs on the CPU: the C launchers are replaced by recorders, so nothing is
compiled or launched.
"""
import ctypes
import types

import pytest
import torch

from l3c_torch.ops import kernels
from l3c_torch.ops.kernels import build

torch.set_num_threads(1)

LAUNCHERS = {"float_cdf": {"l3c_mixture_cdf_q", "l3c_fine_cdf_q"},
             "rans": {"l3c_rans_encode", "l3c_rans_decode"}}


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
    P, K, L, ns, T = 3, 2, 16, 2, 5
    f = torch.zeros((P, K))
    kernels.mixture_cdf_q(f, f, f, torch.zeros(L), L)
    kernels.fine_cdf_q(f, f, f, torch.zeros(P), 1.0, -0.5)
    i = torch.zeros((ns, T), dtype=torch.int32)
    m = torch.ones((ns, T), dtype=torch.bool)
    kernels.rans_encode(i, i, m)
    kernels.rans_decode(torch.zeros((L, ns, T), dtype=torch.int32),
                        torch.zeros((ns, 4), dtype=torch.int32), m)
    assert [fn for fn, _ in calls] == [
        "l3c_mixture_cdf_q", "l3c_fine_cdf_q", "l3c_rans_encode",
        "l3c_rans_decode"]
    sigs = {**build.signatures("float_cdf"), **build.signatures("rans")}
    for fn, args in calls:
        assert len(args) == len(sigs[fn])
        for a, t in zip(args, sigs[fn]):
            # an int slot never receives a pointer-sized value
            assert isinstance(a, float) == (t is ctypes.c_float)
            if t is ctypes.c_int:
                assert 0 <= a < 2 ** 31


def test_call_refuses_wrong_argument_count(monkeypatch):
    _cpu_as_cuda(monkeypatch)
    with pytest.raises(TypeError, match="takes 8 arguments"):
        build.call("rans", "l3c_rans_encode", 0, 0, 0)
