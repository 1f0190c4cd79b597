"""The channel-level coder functions of l3c_torch (ops/gpu_coder.py) on the
CPU vs the JAX package's in-program coder paths, bit for bit.

Each port function takes IntParams and symbols; on the card it is one
kernel launch (csrc/rans.cu), on the CPU its plain version. Here the plain
versions are held against what l3c_tpu/codec/bitcoding2.py runs inside its
coder programs, on the same inputs made with numpy from a seed:
- decode_bn       vs dec_bn_unit's ic.bn_rows + tc.decode_channels;
- decode_rgb_*    vs dec_rgb_channel's coarse / fine rows + scans, per
                  channel with the lambda chain on the decoded symbols;
- encode_bn/_rgb  vs enc_bn_unit / enc_rgb_units: 2-edge lookups +
                  tc.encode_sf, words and lengths bytewise;
- the uniform unit.
Small sizes: F = 2 groups per channel of n = 150 pixels in streams of
T = 64 (three streams per group, the last one padded). The symbols are
the encoded ones, so every decode must also return them.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l3c_tpu.ops import int_coder as jic
from l3c_tpu.ops import tpu_coder as tc
from l3c_torch.ops import gpu_coder as gc
from l3c_torch.ops import int_coder as tic

torch.set_num_threads(1)

F, n, T, L_BN = 2, 150, 64, 25
N = F * n


def _int_params(K, rgb, seed):
    """Random IntParams (C, K, N) within the evaluator's documented ranges,
    sharp and flat mixtures mixed: (JAX IntParams, port IntParams)."""
    rng = np.random.RandomState(seed)
    C = 3 if rgb else 5
    pi = rng.dirichlet(np.ones(K) * rng.choice([0.05, 0.5]), (C, N))
    a_hat = np.clip(np.exp(rng.uniform(-6, 5, (C, N, K))), jic.A_MIN,
                    jic.A_MAX)
    m_hat = rng.uniform(-10, 300 if rgb else 30, (C, N, K))
    v = np.clip(np.round(m_hat * a_hat * 1024), -jic.V_CLAMP, jic.V_CLAMP)
    w = (np.round(rng.uniform(0, 1, (3, N, K)) * a_hat[[1, 2, 2]] * 1024)
         if rgb else None)
    fields = [None if x is None else np.ascontiguousarray(
        x.transpose(0, 2, 1)).astype(np.float32) for x in
        (np.round(pi * jic.PI_Q), np.round(a_hat * 1024),
         np.round(a_hat * 16 * 1024), v, w)]
    return (jic.IntParams(*[None if x is None else jnp.asarray(x)
                            for x in fields]),
            tic.IntParams(*[None if x is None else torch.from_numpy(x)
                            for x in fields]))


def _eq_coded(got, want):
    """Port (words, lengths) vs JAX's: lengths equal, each stream's words
    equal up to its length (past it neither is specified)."""
    (w_t, l_t), (w_j, l_j) = got, want
    l_j = np.asarray(l_j)
    np.testing.assert_array_equal(l_t.numpy(), l_j)
    keep = np.arange(w_t.shape[1])[None] < l_j[:, None]
    np.testing.assert_array_equal(w_t.numpy()[keep],
                                  np.asarray(w_j).astype(np.int64)[keep])


def _words(coded):
    """The encoder's word matrix cut to the longest stream, as the decoder
    receives it."""
    w, ln = coded
    return w[:, :int(ln.max())].contiguous()


@pytest.mark.parametrize("K", [2, 4])
def test_bn_unit_matches_jax(K):
    _bn_unit_matches_jax(K, L_BN)


# where the kernels run their generic variants: K' = 12 and 16, L = 40
@pytest.mark.parametrize("K,L", [(12, 25), (16, 40)])
def test_bn_unit_matches_jax_beyond_the_tiles(K, L):
    _bn_unit_matches_jax(K, L)


def _bn_unit_matches_jax(K, L_BN):
    jip, tip = _int_params(K, False, seed=K)
    C = 5
    syms = np.random.RandomState(10 + K).randint(0, L_BN, (C, N))
    lay = gc.layout_for(n, C * F, T)
    coded = gc.encode_bn(tip, torch.from_numpy(syms), L_BN, lay)
    start, freq = jax.jit(lambda ip, s: jic.bn_lookup(ip, s, C, L_BN))(
        jip, jnp.asarray(syms, jnp.int32))
    _eq_coded(coded, jax.jit(lambda s, f: tc.encode_sf(s, f, lay))(
        start, freq))
    words = _words(coded)
    got = gc.decode_bn(tip, words, L_BN, lay)
    want = jax.jit(lambda ip, w: tc.decode_channels(
        jic.bn_rows(ip, C, L_BN), w, L_BN, lay))(
        jip, jnp.asarray(words.numpy().astype(np.uint16)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().reshape(C, N), syms)


def test_rgb_units_encode_matches_jax():
    """encode_rgb's stacked coarse + fine units vs enc_rgb_units: per
    channel the 2-edge lookups with the lambda chain on the true channel
    symbols, one scan over the 6F groups."""
    _rgb_units_encode_matches_jax(4)


def test_rgb_units_encode_matches_jax_beyond_the_tiles():
    """The same at K' = 12, where the kernels run their generic variant."""
    _rgb_units_encode_matches_jax(12)


def _rgb_units_encode_matches_jax(K):
    jip, tip = _int_params(K, True, seed=20)
    img = np.random.RandomState(21).randint(0, 256, (3, N))
    lay6 = gc.layout_for(n, 6 * F, T)

    def jax_units(ip, t):
        a, b = t >> 4, t & 15
        sc_, fc_, sf_, ff_ = [], [], [], []
        for c in range(3):
            dec = tuple(t[j] for j in range(c))
            s1, f1 = jic.rgb_coarse_lookup(ip, c, dec, a[c])
            s2, f2 = jic.rgb_fine_lookup(ip, c, dec, a[c], b[c])
            sc_.append(s1), fc_.append(f1), sf_.append(s2), ff_.append(f2)
        return tc.encode_sf(jnp.concatenate(sc_ + sf_),
                            jnp.concatenate(fc_ + ff_), lay6)

    _eq_coded(gc.encode_rgb(tip, torch.from_numpy(img), lay6),
              jax.jit(jax_units)(jip, jnp.asarray(img, jnp.int32)))


@pytest.mark.parametrize("c", [0, 1, 2])
def test_rgb_channel_decode_matches_jax(c):
    """decode_rgb_coarse / decode_rgb_fine of channel c vs dec_rgb_channel:
    coarse rows from the IntParams and the decoded channels < c, coarse
    scan -> a, conditional fine rows from a, fine scan -> b."""
    jip, tip = _int_params(4, True, seed=30 + c)
    img = np.random.RandomState(40 + c).randint(0, 256, (3, N))
    lay6 = gc.layout_for(n, 6 * F, T)
    w6, l6 = gc.encode_rgb(tip, torch.from_numpy(img), lay6)
    lay = gc.layout_for(n, F, T)
    ns, half = F * lay.ns_c, lay6.lanes // 2
    wc = _words((w6[c * ns:(c + 1) * ns], l6[c * ns:(c + 1) * ns]))
    wf = _words((w6[half + c * ns:half + (c + 1) * ns],
                 l6[half + c * ns:half + (c + 1) * ns]))
    dec = torch.from_numpy(img.astype(np.uint8))
    a = gc.decode_rgb_coarse(tip, c, dec, wc, lay)
    b = gc.decode_rgb_fine(tip, c, dec, a, wf, lay)

    def jax_channel(ip, t, w_c, w_f):
        d = tuple(t[j] for j in range(c))
        a_ = tc.decode_channels(jic.rgb_coarse_rows(ip, c, d), w_c,
                                tc.N_COARSE, lay).reshape(-1)
        b_ = tc.decode_channels(jic.rgb_fine_rows(ip, c, d, a_), w_f,
                                1 << tc.FINE_BITS, lay).reshape(-1)
        return a_, b_

    a_j, b_j = jax.jit(jax_channel)(
        jip, jnp.asarray(img, jnp.int32),
        jnp.asarray(wc.numpy().astype(np.uint16)),
        jnp.asarray(wf.numpy().astype(np.uint16)))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_j))
    np.testing.assert_array_equal((a.numpy() << 4) | b.numpy(), img[c])


def test_uniform_unit_matches_jax():
    _uniform_unit_matches_jax(L_BN)


def test_uniform_unit_matches_jax_at_forty_symbols():
    """L = 40: beyond the decode tiles' 33 symbols."""
    _uniform_unit_matches_jax(40)


def _uniform_unit_matches_jax(L_BN):
    C = 5
    syms = np.random.RandomState(50).randint(0, L_BN, (C * F * n,))
    lay = gc.layout_for(n, C * F, T)
    coded = gc.encode_uniform(torch.from_numpy(syms), L_BN, lay)
    _eq_coded(coded, jax.jit(lambda s: tc.encode_uniform(s, L_BN, lay))(
        jnp.asarray(syms, jnp.int32)))
    words = _words(coded)
    got = gc.decode_uniform(words, L_BN, lay)
    want = jax.jit(lambda w: tc.decode_uniform(w, L_BN, lay))(
        jnp.asarray(words.numpy().astype(np.uint16)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().reshape(-1), syms)
