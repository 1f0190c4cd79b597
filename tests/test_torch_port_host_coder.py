"""The port's host rANS backend (l3c_torch/ops/coder.py) against the JAX
package's (l3c_tpu/ops/coder.py), on the CPU.

- the port's C++ source is the JAX package's, byte for byte;
- the library builds into the kernels' build directory (not beside the
  source), its evaluator variant is JAX's, and a failed build raises with
  the compiler's log;
- on the same seeded (pi, mu, inv_s, lam, syms), MixtureCoder,
  UniformCoder, TableCoder and encode_table_ctx give data and chunk
  lengths byte-identical to JAX's binding, and each package decodes the
  other's streams;
- the scalar build (L3C_CODER_FORCE_SCALAR=1) gives the vectorised
  build's streams;
- both packages' libraries load into one process and keep their own
  symbols (-fno-gnu-unique: no STB_GNU_UNIQUE symbol in the port's).
"""
import os
import shutil
import subprocess

import numpy as np
import pytest

from l3c_tpu.ops import coder as jcoder
from l3c_torch.ops import coder as tcoder
from l3c_torch.ops.kernels.build import BUILD_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mixture_inputs(seed, C, HW, K, L, x_min, x_max, rgb):
    rng = np.random.RandomState(seed)
    pi = rng.dirichlet(np.ones(K), size=(C, HW)).astype(np.float32)
    mu = rng.uniform(x_min, x_max, (C, HW, K)).astype(np.float32)
    if rgb:
        mu *= np.float32(0.5)
    log_s = rng.uniform(-5, 1, (C, HW, K)).astype(np.float32)
    inv_s = np.exp(-np.maximum(log_s, -7.0)).astype(np.float32)
    lam = (rng.uniform(0, 1, (3, HW, K)).astype(np.float32) if rgb
           else None)
    syms = rng.randint(0, L, (C, HW)).astype(np.int32)
    return pi, mu, inv_s, lam, syms


def test_the_source_is_the_jax_packages_byte_for_byte():
    a = open(os.path.join(ROOT, "l3c_torch", "ops", "csrc",
                          "l3c_coder.cpp"), "rb").read()
    b = open(os.path.join(ROOT, "l3c_tpu", "ops", "csrc", "l3c_coder.cpp"),
             "rb").read()
    assert a == b


def test_builds_into_the_build_dir_with_jaxs_evaluator():
    lib = tcoder.get_lib()
    path = tcoder.lib_path(False)
    assert os.path.dirname(path) == BUILD_DIR and os.path.isfile(path)
    assert lib.l3c_coder_version() == jcoder.get_lib().l3c_coder_version()
    assert tcoder.eval_variant() == jcoder.eval_variant() == 1
    assert "-fno-gnu-unique" in tcoder.GXX_FLAGS
    assert not os.path.exists(os.path.join(ROOT, "l3c_torch", "ops", "csrc",
                                           "libl3c_coder.so"))


def test_a_failed_build_raises_with_the_log(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tcoder, "_SRC", str(bad))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        tcoder._build(str(tmp_path / "libbad.so"), False)
    assert not list(tmp_path.glob("libbad*"))


@pytest.mark.parametrize("L,x_min,x_max,C,K,rgb", [
    (25, -1.0, 1.0, 5, 10, False),          # a bottleneck scale
    (256, 0.0, 255.0, 3, 10, True),         # scale 0 with the lambda chain
    (256, 0.0, 255.0, 3, 3, True),          # K no multiple of 8 lanes
    (25, -1.0, 1.0, 2, 1, False),
])
def test_mixture_streams_equal_jax_both_ways(L, x_min, x_max, C, K, rgb):
    pi, mu, inv_s, lam, syms = _mixture_inputs(L + K, C, 333, K, L, x_min,
                                               x_max, rgb)
    t = tcoder.MixtureCoder(L, x_min, x_max)
    j = jcoder.MixtureCoder(L, x_min, x_max)
    td, tl = t.encode(pi, mu, inv_s, lam, syms)
    jd, jl = j.encode(pi, mu, inv_s, lam, syms)
    assert td == jd and np.array_equal(tl, jl)
    np.testing.assert_array_equal(t.decode(pi, mu, inv_s, lam, jd, jl), syms)
    np.testing.assert_array_equal(j.decode(pi, mu, inv_s, lam, td, tl), syms)


@pytest.mark.parametrize("L", [25, 256])
def test_uniform_and_table_streams_equal_jax(L):
    rng = np.random.RandomState(L)
    syms = rng.randint(0, L, 1001).astype(np.int32)
    td, tl = tcoder.UniformCoder(L).encode(syms)
    jd, jl = jcoder.UniformCoder(L).encode(syms)
    assert td == jd and np.array_equal(tl, jl)
    np.testing.assert_array_equal(
        jcoder.UniformCoder(L).decode(td, tl, syms.size), syms)
    np.testing.assert_array_equal(
        tcoder.UniformCoder(L).decode(jd, jl, syms.size), syms)
    f = np.maximum(1, rng.geometric(0.05, L)).astype(np.int64)
    f[0] += 65536 - f.sum()
    cum = np.concatenate([[0], np.cumsum(f)]).astype(np.uint32)
    td, tl = tcoder.TableCoder(cum).encode(syms)
    jd, jl = jcoder.TableCoder(cum).encode(syms)
    assert td == jd and np.array_equal(tl, jl)
    np.testing.assert_array_equal(
        jcoder.TableCoder(cum).decode(td, tl, syms.size), syms)
    np.testing.assert_array_equal(
        tcoder.TableCoder(cum).decode(jd, jl, syms.size), syms)


def test_table_ctx_and_med_helpers_equal_jax():
    from l3c_tpu.eval.classic import _tsgd_cum
    rng = np.random.RandomState(7)
    img = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    assert np.array_equal(tcoder.med_residuals(img),
                          jcoder.med_residuals(img))
    ctx_t, ctx_j = tcoder.med_contexts(img, 8), jcoder.med_contexts(img, 8)
    assert np.array_equal(ctx_t, ctx_j)
    res = tcoder.med_residuals(img)
    np.testing.assert_array_equal(tcoder.med_reconstruct(res, 13, 17), img)
    cums = np.stack([_tsgd_cum(16 * k + 3, 40 + k) for k in range(8)])
    td, tl = tcoder.encode_table_ctx(res[0], ctx_t[0], cums)
    jd, jl = jcoder.encode_table_ctx(res[0], ctx_j[0], cums)
    assert td == jd and np.array_equal(tl, jl)


def test_scalar_build_gives_the_vectorised_streams(monkeypatch):
    pi, mu, inv_s, lam, syms = _mixture_inputs(3, 3, 257, 10, 256, 0.0,
                                               255.0, True)
    coder = tcoder.MixtureCoder(256, 0.0, 255.0)
    vec = coder.encode(pi, mu, inv_s, lam, syms)
    monkeypatch.setenv("L3C_CODER_FORCE_SCALAR", "1")
    assert tcoder.get_lib() is not tcoder._libs[False]
    assert tcoder.lib_path(True) != tcoder.lib_path(False)
    sca = coder.encode(pi, mu, inv_s, lam, syms)
    assert vec[0] == sca[0] and np.array_equal(vec[1], sca[1])
    np.testing.assert_array_equal(
        coder.decode(pi, mu, inv_s, lam, *vec), syms)


def test_both_packages_libraries_in_one_process():
    """The JAX library and the port's export the same C symbols; loaded
    into one process each handle still runs its own code, and the port's
    has no STB_GNU_UNIQUE symbol that could bind across them."""
    t, j = tcoder.get_lib(), jcoder.get_lib()
    assert t._name != j._name
    assert os.path.realpath(t._name) != os.path.realpath(j._name)
    for lib in (t, j):
        assert lib.l3c_eval_variant() == 1
    pi, mu, inv_s, lam, syms = _mixture_inputs(9, 5, 64, 4, 25, -1.0, 1.0,
                                               False)
    a = tcoder.MixtureCoder(25, -1, 1).encode(pi, mu, inv_s, None, syms)
    b = jcoder.MixtureCoder(25, -1, 1).encode(pi, mu, inv_s, None, syms)
    assert a[0] == b[0]
    nm = shutil.which("nm")
    if nm is None:
        return
    out = subprocess.run([nm, "-D", "--defined-only", t._name],
                         capture_output=True, text=True, check=True).stdout
    kinds = {line.split()[1] for line in out.splitlines() if line.strip()}
    assert "u" not in kinds, out
