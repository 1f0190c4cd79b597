"""Plain versions of the four kernels vs the JAX package.

- plain rans_encode_plain / rans_decode_plain and the uniform coders vs
  l3c_tpu.ops.tpu_coder: words and lengths bytewise, symbols equal;
- plain mixture_cdf_q / fine_cdf_q (and the v7 row builders around them)
  vs the Pallas kernels of tools/pallas_cdf.py in interpret mode and vs
  tpu_coder's v7 builders: <= 1 quantization step (coarse), <= 2 steps on
  well-conditioned rows (fine); all rows strictly increasing.
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from l3c_tpu.models import dmll as jdmll  # noqa: E402
from l3c_tpu.ops import tpu_coder as tc  # noqa: E402
from l3c_torch.models import dmll as tdmll  # noqa: E402
from l3c_torch.ops import float_cdf, gpu_coder  # noqa: E402
from tools import pallas_cdf  # noqa: E402

torch.set_num_threads(1)


def _rows_sf(rng, ns, T, L):
    """(rows lane-major (L,NS,T), start, freq, syms) from random +2l rows
    with extreme frequencies mixed in."""
    c = np.sort(rng.randint(0, 65536 - 2 * L, (ns * T, L)), axis=1)
    c[: ns * T // 4, 1:] = 65536 - 2 * L          # one symbol takes ~all
    r = c + 2 * np.arange(L)
    r[:, 0] = 0
    syms = rng.randint(0, L, ns * T)
    st, fr = tc.table_lookup_symbol(jnp.asarray(r.astype(np.uint16)),
                                    jnp.asarray(syms, jnp.int32), L)
    rows = np.ascontiguousarray(r.reshape(ns, T, L).transpose(2, 0, 1))
    return (rows.astype(np.int32), np.asarray(st).reshape(ns, T),
            np.asarray(fr).reshape(ns, T), syms.reshape(ns, T))


@pytest.mark.parametrize("L,T", [(16, 64), (25, 128)])
def test_rans_plain_matches_tpu_coder(L, T):
    rng = np.random.RandomState(L)
    ns = 40
    rows, st, fr, syms = _rows_sf(rng, ns, T, L)
    mask = np.ones((ns, T), bool)
    mask[-3:, -11:] = False
    w_j, l_j = jax.jit(tc.rans_encode)(jnp.asarray(st), jnp.asarray(fr),
                                       jnp.asarray(mask))
    w_j, l_j = np.asarray(w_j), np.asarray(l_j)
    w_t, l_t = gpu_coder.rans_encode_plain(
        torch.from_numpy(st.astype(np.int32)),
        torch.from_numpy(fr.astype(np.int32)), torch.from_numpy(mask))
    np.testing.assert_array_equal(l_t.numpy(), l_j)
    for i in range(ns):   # JAX leaves packer garbage past each length
        np.testing.assert_array_equal(w_t.numpy()[i, :l_j[i]],
                                      w_j[i, :l_j[i]])
    assert (w_t.numpy()[np.arange(T + 2)[None] >= l_j[:, None]] == 0).all()
    mask_t = mask.reshape(ns, T // tc.UNROLL, tc.UNROLL).transpose(1, 2, 0)
    s_j = np.asarray(jax.jit(tc.rans_decode, static_argnums=3)(
        jnp.asarray(rows.astype(np.uint16)), jnp.asarray(w_j),
        jnp.asarray(mask_t), L))
    s_t = gpu_coder.rans_decode_plain(torch.from_numpy(rows), w_t,
                                      torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(s_t[mask], syms[mask])


def test_uniform_coders_match_tpu_coder():
    L, C, n, T = 25, 5, 3000, 1024
    syms = np.random.RandomState(3).randint(0, L, (C * n,))
    lay_j = tc.layout_for(n, C, T)
    w_j, l_j = jax.jit(lambda s: tc.encode_uniform(s, L, lay_j))(
        jnp.asarray(syms, jnp.int32))
    w_j, l_j = np.asarray(w_j), np.asarray(l_j)
    lay = gpu_coder.layout_for(n, C, T)
    w_t, l_t = gpu_coder.encode_uniform(torch.from_numpy(syms), L, lay)
    np.testing.assert_array_equal(l_t.numpy(), l_j)
    for i in range(len(l_j)):
        np.testing.assert_array_equal(w_t.numpy()[i, :l_j[i]],
                                      w_j[i, :l_j[i]])
    np.testing.assert_array_equal(gpu_coder.uniform_cdf_row(L),
                                  tc.uniform_cdf_row(L))
    out = gpu_coder.decode_uniform(w_t, L, lay).numpy()
    np.testing.assert_array_equal(out.reshape(-1), syms)
    assert gpu_coder.t_policy(512 * 512) == tc.t_policy(512 * 512,
                                                        "balanced") == 2048
    for prof in ("speed", "balanced", "size"):
        for n_ in (1000, 65536, 262144, 10 ** 7):
            assert gpu_coder.t_policy(n_, prof) == tc.t_policy(n_, prof)


def _mixture(rng, P, K):
    pi = rng.dirichlet(np.ones(K), size=P).astype(np.float32)
    mu = rng.uniform(-1, 1, (P, K)).astype(np.float32)
    inv_s = np.exp(-rng.uniform(-5, 1, (P, K))).astype(np.float32)
    return pi, mu, inv_s


@pytest.mark.parametrize("P,K,L", [(300, 10, 16), (64, 3, 25)])
def test_mixture_cdf_q_plain_matches_pallas(P, K, L):
    pi, mu, inv_s = _mixture(np.random.RandomState(P), P, K)
    bw = 2.0 / (L - 1)
    t = (np.arange(L, dtype=np.float32) * np.float32(bw)
         + np.float32(-1.0 - bw / 2.0))
    want = np.asarray(pallas_cdf.mixture_cdf_quantized(
        jnp.asarray(pi), jnp.asarray(mu), jnp.asarray(inv_s), t, L,
        interpret=True))
    got = float_cdf.mixture_cdf_q(torch.from_numpy(pi), torch.from_numpy(mu),
                                  torch.from_numpy(inv_s),
                                  torch.from_numpy(t), L).numpy()
    assert np.abs(got.astype(np.int64) - want).max() <= 1
    rows = float_cdf.finish_rows(torch.from_numpy(got)).numpy()
    full = np.asarray(tc.build_cdf_table(pi, mu, inv_s, -1.0, bw, L),
                      np.int64)
    assert np.abs(rows - full).max() <= 1
    d = np.diff(np.concatenate([rows, np.full((P, 1), 65536)], 1), axis=1)
    assert (d >= 1).all()


def _rgb_case(seed, h=16, w=16, K=4):
    rng = np.random.RandomState(seed)
    Kp = jdmll.non_shared_get_Kp(K, 3)
    l = rng.randn(1, h, w, Kp).astype(np.float32)
    dec = rng.randint(0, 256, (1, h, w, 3)).astype(np.float32)
    return l, dec


@pytest.mark.parametrize("c", [0, 2])
def test_rgb_coarse_rows_plain_match(c):
    l, dec = _rgb_case(3 + c)
    js, ts = jdmll.RGB_SPEC, tdmll.DMLLSpec(True)
    packed_j = jdmll.pack_coder_params(js, jnp.asarray(l), 3)
    packed_t = tdmll.pack_coder_params(ts, torch.from_numpy(l), 3)
    dj = jnp.asarray(dec)
    xla = np.asarray(tc.rgb_coarse_tables_packed(js, packed_j, c, dj),
                     np.int64)
    pls = np.asarray(pallas_cdf.rgb_coarse_tables_pallas(js, packed_j, c, dj),
                     np.int64)
    got = float_cdf.rgb_coarse_tables_packed(
        ts, packed_t, c, torch.from_numpy(dec)).numpy()
    assert np.abs(got - xla).max() <= 1
    assert np.abs(got - pls).max() <= 1


@pytest.mark.parametrize("c", [1, 2])
def test_rgb_fine_rows_plain_match(c):
    """Mirrors tests/test_tools_pallas_cdf.py::test_fine_kernel_matches_xla
    _path: realistic coarse symbols (the bin holding component 0's mean),
    compared on well-conditioned rows only."""
    l, dec = _rgb_case(10 + c, h=25, w=25)
    n = 25 * 25
    js, ts = jdmll.RGB_SPEC, tdmll.DMLLSpec(True)
    pi0, mu0, inv0 = tc._channel_params(js, jnp.asarray(l), c, 3,
                                        jnp.asarray(dec))
    a = np.clip((np.asarray(mu0)[:, 0] - js.x_min) / js.bin_width / 16.0,
                0, 15).astype(np.int32)
    xla = np.asarray(tc.rgb_fine_tables(js, jnp.asarray(l), c, 3,
                                        jnp.asarray(dec), jnp.asarray(a)),
                     np.int64)
    pls = np.asarray(pallas_cdf.rgb_fine_tables_pallas(
        js, jnp.asarray(l), c, 3, jnp.asarray(dec), jnp.asarray(a)),
        np.int64)
    packed_t = tdmll.pack_coder_params(ts, torch.from_numpy(l), 3)
    got = float_cdf.rgb_fine_tables_packed(
        ts, packed_t, c, torch.from_numpy(dec), torch.from_numpy(a)).numpy()
    k = jnp.arange(17, dtype=jnp.float32)
    t = ((jnp.asarray(a).reshape(-1, 1).astype(jnp.float32) * 16.0 + k)
         * np.float32(js.bin_width) + np.float32(js.x_min - js.bin_width / 2))
    cv = np.asarray(tc.edge_cdf(pi0, mu0, inv0, t))
    good = (cv[:, -1] - cv[:, 0]) > 1e-2
    assert good.sum() > n // 3
    assert np.abs(got[good] - xla[good]).max() <= 2
    assert np.abs(got[good] - pls[good]).max() <= 2
    d = np.diff(np.concatenate([got, np.full((n, 1), 65536)], 1), axis=1)
    assert (d >= 1).all()
