"""l3c_torch numerics core vs the JAX package on the same seeded inputs:
grids, quantizer, pad, dmll.nll / bitcost / pack_coder_params (atol 1e-5;
the float32 transcendentals of the two libraries differ by a few ulp)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l3c_tpu.models import dmll as jdmll
from l3c_tpu.models import grids as jgrids
from l3c_tpu.models import quantizer as jquant
from l3c_tpu.utils import pad as jpad
from l3c_torch.models import dmll as tdmll
from l3c_torch.models import grids as tgrids
from l3c_torch.models import quantizer as tquant
from l3c_torch.utils import pad as tpad

torch.set_num_threads(1)


@pytest.mark.parametrize("x_min,x_max,L", [(-1.0, 1.0, 25), (0.0, 255.0, 256),
                                           (-2.0, 3.0, 7)])
def test_grids_match(x_min, x_max, L):
    assert tgrids.bin_width(x_min, x_max, L) == jgrids.bin_width(
        x_min, x_max, L)
    np.testing.assert_array_equal(tgrids.levels(x_min, x_max, L),
                                  jgrids.levels(x_min, x_max, L))
    np.testing.assert_array_equal(tgrids.targets_grid(x_min, x_max, L),
                                  jgrids.targets_grid(x_min, x_max, L))
    x = np.random.RandomState(L).uniform(x_min - 1, x_max + 1, 500) \
        .astype(np.float32)
    s_j = np.asarray(jgrids.to_sym(jnp.asarray(x), x_min, x_max, L))
    s_t = tgrids.to_sym(torch.from_numpy(x), x_min, x_max, L).numpy()
    np.testing.assert_array_equal(s_t, s_j)
    # levels[s] == to_bn(s) bit for bit (the value<->symbol contract)
    np.testing.assert_array_equal(
        tgrids.to_bn(torch.from_numpy(s_t), x_min, x_max, L).numpy(),
        tgrids.levels(x_min, x_max, L)[s_t])


def test_quantizer_matches():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1.3, 1.3, (2, 5, 7, 5)).astype(np.float32)
    lv = jgrids.levels(-1.0, 1.0, 25)
    q_j = jax.jit(lambda a: jquant.quantize(a, jnp.asarray(lv), 2.0))(
        jnp.asarray(x))
    q_t = tquant.quantize(torch.from_numpy(x), torch.from_numpy(lv))
    np.testing.assert_array_equal(q_t.syms.numpy(), np.asarray(q_j.syms))
    np.testing.assert_array_equal(q_t.bn_q.numpy(), np.asarray(q_j.bn_q))
    np.testing.assert_array_equal(
        tquant.levels_select(torch.from_numpy(lv), q_t.syms).numpy(),
        np.asarray(jquant.levels_select(jnp.asarray(lv),
                                        jnp.asarray(q_t.syms.numpy()))))


@pytest.mark.parametrize("h,w,mode", [
    (19, 45, "replicate"), (17, 8, "constant"), (16, 24, "constant")])
def test_pad_matches(h, w, mode):
    img = np.random.RandomState(h).randint(0, 256, (1, h, w, 3)) \
        .astype(np.uint8)
    assert tpad.padding_for(h, w, 8) == jpad.padding_for(h, w, 8)
    p_t, tup_t = tpad.pad(img, 8, mode)
    p_j, tup_j = jpad.pad(img, 8, mode)
    assert tup_t == tup_j
    np.testing.assert_array_equal(p_t, np.asarray(p_j))
    np.testing.assert_array_equal(tpad.undo_pad(p_t, *tup_t), img)


def _dmll_inputs(rgb, seed=0):
    rng = np.random.RandomState(seed)
    K, C = 3, (3 if rgb else 5)
    spec_args = ((True, 0.0, 255.0, 256) if rgb else (False, -1.0, 1.0, 25))
    Kp = jdmll.non_shared_get_Kp(K, C)
    l = (rng.randn(2, 4, 6, Kp) * 2).astype(np.float32)
    if rgb:
        x = rng.randint(0, 256, (2, 4, 6, C)).astype(np.float32)
        x[0, 0, 0] = 0.0          # exercise both open tails
        x[0, 0, 1] = 255.0
    else:
        x = jgrids.levels(-1.0, 1.0, 25)[rng.randint(0, 25, (2, 4, 6, C))]
    return spec_args, l, x, C


@pytest.mark.parametrize("rgb", [True, False])
def test_dmll_nll_and_bitcost_match(rgb):
    spec_args, l, x, C = _dmll_inputs(rgb)
    js = jdmll.DMLLSpec(*spec_args)
    ts = tdmll.DMLLSpec(*spec_args)
    # JAX eager, op by op as the port computes: under jit XLA fuses the
    # sigmoid/log chain and moves single elements by up to 1.4e-4 here
    n_j = np.asarray(jdmll.nll(js, jnp.asarray(x), jnp.asarray(l)))
    n_t = tdmll.nll(ts, torch.from_numpy(x), torch.from_numpy(l)).numpy()
    # atol 1e-5 on well-conditioned elements; far-tail elements (up to
    # ~140 nats here) lose digits to cancellation in log(sigmoid) terms,
    # where the two libraries' ulp-level sigmoid/softplus differences
    # show up as <= 1.1e-5 relative (measured)
    np.testing.assert_allclose(n_t, n_j, atol=1e-5, rtol=2e-5)
    # bitcost: compared with the float64 sum of the JAX per-element nll
    # (float32 sums of the two libraries take different orders)
    np.testing.assert_allclose(
        float(tdmll.bitcost(ts, torch.from_numpy(x), torch.from_numpy(l))),
        n_j.astype(np.float64).sum(), rtol=1e-6)


@pytest.mark.parametrize("rgb", [True, False])
def test_pack_coder_params_match(rgb):
    spec_args, l, _, C = _dmll_inputs(rgb, seed=1)
    got = tdmll.pack_coder_params(tdmll.DMLLSpec(*spec_args),
                                  torch.from_numpy(l), C)
    want = jdmll.pack_coder_params(jdmll.DMLLSpec(*spec_args),
                                   jnp.asarray(l), C)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
