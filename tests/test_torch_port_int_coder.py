"""l3c_torch.ops.int_coder vs l3c_tpu.ops.int_coder.

- int_sigmoid: bitwise over its whole domain.
- rows and 2-edge lookups: bitwise, given the SAME IntParams.
- pack_int_params (the one float stage): every entry within 1 of JAX's,
  mismatch fraction stated and bounded; equal on these inputs.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l3c_tpu.models import dmll as jdmll
from l3c_tpu.ops import int_coder as jic
from l3c_torch.models import dmll as tdmll
from l3c_torch.ops import int_coder as tic

torch.set_num_threads(1)


def test_int_sigmoid_whole_domain_bitwise():
    z = np.arange(-(jic.Z_SAT + 64), jic.Z_SAT + 65, dtype=np.float32)
    got = tic.int_sigmoid(torch.from_numpy(z)).numpy()
    want = np.asarray(jax.jit(jic.int_sigmoid)(jnp.asarray(z)))
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got) >= 0).all() and (got + got[::-1] == 4096).all()


def _rand_ip(n, K, rgb, seed):
    """Random IntParams within the evaluator's documented ranges, with
    sharp and flat mixtures mixed."""
    rng = np.random.RandomState(seed)
    C = 3 if rgb else 5
    pi = rng.dirichlet(np.ones(K) * rng.choice([0.05, 0.5]), (C, n))
    a_hat = np.clip(np.exp(rng.uniform(-6, 5, (C, n, K))), jic.A_MIN,
                    jic.A_MAX)
    hi = 300 if rgb else 30
    m_hat = rng.uniform(-10, hi, (C, n, K))
    p = np.round(pi * jic.PI_Q)
    a = np.round(a_hat * 1024)
    sc = np.round(a_hat * 16 * 1024)
    v = np.clip(np.round(m_hat * a_hat * 1024), -jic.V_CLAMP, jic.V_CLAMP)
    w = None
    if rgb:
        lam = rng.uniform(0, 1, (3, n, K))
        w = np.round(lam * a_hat[[1, 2, 2]] * 1024)
    lm = lambda x: None if x is None else \
        np.ascontiguousarray(x.transpose(0, 2, 1)).astype(np.float32)
    arrs = [lm(x) for x in (p, a, sc, v, w)]
    j = jic.IntParams(*[None if x is None else jnp.asarray(x)
                        for x in arrs])
    t = tic.IntParams(*[None if x is None else torch.from_numpy(x)
                        for x in arrs])
    return j, t


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def test_bn_rows_and_lookups_bitwise():
    n, K, L, C = 400, 4, 25, 5
    jip, tip = _rand_ip(n, K, rgb=False, seed=1)
    _eq(tic.bn_rows(tip, C, L).numpy(),
        jax.jit(lambda ip: jic.bn_rows(ip, C, L))(jip))
    syms = np.random.RandomState(2).randint(0, L, (C, n))
    s_t, f_t = tic.bn_lookup(tip, torch.from_numpy(syms), C, L)
    s_j, f_j = jax.jit(lambda ip, s: jic.bn_lookup(ip, s, C, L))(
        jip, jnp.asarray(syms, jnp.int32))
    _eq(s_t.numpy(), s_j)
    _eq(f_t.numpy(), f_j)
    assert (f_t > 0).all()


@pytest.mark.parametrize("c", [0, 1, 2])
def test_rgb_rows_and_lookups_bitwise(c):
    n, K = 300, 4
    jip, tip = _rand_ip(n, K, rgb=True, seed=3 + c)
    rng = np.random.RandomState(c)
    t = rng.randint(0, 256, (3, n))
    dec_t = tuple(torch.from_numpy(t[j]) for j in range(c))
    dec_j = tuple(jnp.asarray(t[j], jnp.int32) for j in range(c))
    a, b = t[c] >> 4, t[c] & 15
    at, aj = torch.from_numpy(a), jnp.asarray(a, jnp.int32)
    bt, bj = torch.from_numpy(b), jnp.asarray(b, jnp.int32)
    _eq(tic.rgb_coarse_rows(tip, c, dec_t).numpy(),
        jax.jit(lambda ip, d: jic.rgb_coarse_rows(ip, c, d))(jip, dec_j))
    _eq(tic.rgb_fine_rows(tip, c, dec_t, at).numpy(),
        jax.jit(lambda ip, d, a_: jic.rgb_fine_rows(ip, c, d, a_))(
            jip, dec_j, aj))
    for got, want in zip(
            tic.rgb_coarse_lookup(tip, c, dec_t, at),
            jax.jit(lambda ip, d, a_: jic.rgb_coarse_lookup(ip, c, d, a_))(
                jip, dec_j, aj)):
        _eq(got.numpy(), want)
    for got, want in zip(
            tic.rgb_fine_lookup(tip, c, dec_t, at, bt),
            jax.jit(lambda ip, d, a_, b_: jic.rgb_fine_lookup(
                ip, c, d, a_, b_))(jip, dec_j, aj, bj)):
        _eq(got.numpy(), want)


@pytest.mark.parametrize("rgb,topk", [(True, 0), (True, 4), (False, 0),
                                      (False, 4)])
def test_pack_int_params_vs_jax(rgb, topk):
    """The float boundary: softmax/exp/sigmoid of the two libraries may
    round differently, which can move an entry by one at a rounding
    boundary. Measured on these inputs: 0 mismatches of 11520 entries per
    case (mismatch fraction 0). Bound: all within 1, fraction <= 1e-3."""
    K, C = 10, (3 if rgb else 5)
    js = jdmll.DMLLSpec(True) if rgb else jdmll.DMLLSpec(False, -1.0, 1.0,
                                                          25)
    ts = tdmll.DMLLSpec(True) if rgb else tdmll.DMLLSpec(False, -1.0, 1.0,
                                                          25)
    l = (np.random.RandomState(7).randn(2, 8, 12, jdmll.non_shared_get_Kp(
        K, C)) * 2.0).astype(np.float32)
    want = jax.jit(lambda x: jic.pack_int_params(js, x, C, topk))(
        jnp.asarray(l))
    got = tic.pack_int_params(ts, torch.from_numpy(l), C, topk)
    n_bad = n_all = 0
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        d = np.abs(g.numpy() - np.asarray(w))
        assert d.max() <= 1
        n_bad += int((d > 0).sum())
        n_all += d.size
    frac = n_bad / n_all
    print(f"pack_int_params rgb={rgb} topk={topk}: {n_bad}/{n_all} "
          f"entries differ ({frac:.2e})")
    assert frac <= 1e-3


def test_topk_rank_matches_stable_argsort():
    rng = np.random.RandomState(5)
    pi = rng.randint(0, 4, (3, 10, 50)).astype(np.float32)  # many ties
    rank = tic.topk_rank(torch.from_numpy(pi)).numpy()
    np.testing.assert_array_equal(
        rank, np.asarray(jic.topk_rank(jnp.asarray(pi))))
    idx = tic.topk_index(torch.from_numpy(rank), 4).numpy()
    order = np.argsort(-pi, axis=1, kind="stable")[:, :4]
    np.testing.assert_array_equal(idx, order)
