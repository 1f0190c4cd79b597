"""l3c_torch network, weights and blueprint vs the JAX package.

- a tiny network (Cf=8, 1+1 blocks, K=2, S=3) with the JAX params carried
  across by params_from_jax: Out.S equal, Out.P per scale close, total
  bpsp within rel 1e-5;
- the pure-Python msgpack reader vs msgpack on the r5b checkpoint: all
  258 parameter leaves (and the rest of the file) equal.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l3c_tpu import blueprint as jbp
from l3c_tpu.config import DecConfig, EncConfig, MsConfig, ProbConfig, \
    QConfig
from l3c_tpu.models import dmll as jdmll
from l3c_tpu.models.network import MultiscaleNetwork as JNet
from l3c_torch import blueprint as tbp
from l3c_torch import config as tcfg
from l3c_torch.models.network import MultiscaleNetwork as TNet
from l3c_torch.models.weights import params_from_jax, read_checkpoint

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5B = os.path.join(ROOT, "models_zoo",
                   "0820_0345 cr oi_offline r@0819_0307 r5b", "ckpts",
                   "ckpt_0000246250.ckpt")


def tiny_cfgs():
    j = MsConfig(num_scales=3, Cf=8, enc=EncConfig(num_blocks=1),
                 dec=DecConfig(num_blocks=1), q=QConfig(C=5, L=25),
                 prob=ProbConfig(K=2))
    t = tcfg.MsConfig(num_scales=3, Cf=8, enc=tcfg.EncConfig(num_blocks=1),
                      dec=tcfg.DecConfig(num_blocks=1),
                      q=tcfg.QConfig(C=5, L=25), prob=tcfg.ProbConfig(K=2))
    return j, t


@pytest.fixture(scope="module")
def tiny():
    jc, tc = tiny_cfgs()
    jn = JNet(jc)
    params = jax.jit(jn.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 3)))
    tn = TNet(tc)
    tn.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jc, jn, params, tc, tn.eval()


def test_tiny_network_matches_jax(tiny):
    jc, jn, params, tc, tn = tiny
    img = np.random.RandomState(0).randint(0, 256, (2, 32, 40, 3)) \
        .astype(np.float32)
    jo = jax.jit(lambda p, x: jn.apply(p, x))(params, jnp.asarray(img))
    with torch.no_grad():
        to = tn(torch.from_numpy(img))
    for i in range(3):
        np.testing.assert_array_equal(to.S[i].numpy(), np.asarray(jo.S[i]))
        np.testing.assert_array_equal(to.bn[i].numpy(), np.asarray(jo.bn[i]))
        p_j = np.asarray(jo.P[i])
        np.testing.assert_allclose(to.P[i].numpy(), p_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(p_j).max())
    # total bpsp: the port's vs the JAX per-element nll summed in float64
    # (XLA's float32 sum of the 7680 scale-0 terms is itself off by ~4e-5
    # relative, so it is no reference at 1e-5)
    conv = np.log(2.0) * img.size
    specs = [jbp.rgb_spec(jc)] + [jbp.bn_spec(jc)] * 2
    targets = [np.asarray(jo.S[0], np.float32)] + \
        [np.asarray(jo.bn[i]) for i in (1, 2)]
    ref = sum(np.asarray(jdmll.nll(s, jnp.asarray(x), jo.P[i]),
                         np.float64).sum()
              for i, (s, x) in enumerate(zip(specs, targets))) / conv
    ref += jbp.uniform_tail_nats(jc, jo, 3) / conv
    got = float(tbp.total_bpsp(tbp.compute_loss(tc, to)))
    assert abs(got - ref) / ref < 1e-5, (got, ref)
    # the JAX package's own float32 total, within its sum's error
    want = float(jbp.total_bpsp(jbp.compute_loss(jc, jo)))
    assert abs(got - want) / want < 1e-4


def test_get_P_matches_jax(tiny):
    jc, jn, params, tc, tn = tiny
    rng = np.random.RandomState(1)
    lv = np.linspace(-1, 1, 25).astype(np.float32)
    bn = lv[rng.randint(0, 25, (1, 4, 5, 5))]
    l_j, F_j = jax.jit(lambda p, b: jn.apply(p, 2, b, None,
                                             method=JNet.get_P))(
        params, jnp.asarray(bn))
    l2_j, _ = jax.jit(lambda p, b, f: jn.apply(p, 1, b, f,
                                               method=JNet.get_P))(
        params, jnp.asarray(np.repeat(np.repeat(bn, 2, 1), 2, 2)), F_j)
    with torch.no_grad():
        l_t, F_t = tn.get_P(2, torch.from_numpy(bn))
        l2_t, _ = tn.get_P(1, torch.from_numpy(
            np.repeat(np.repeat(bn, 2, 1), 2, 2)), F_t)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-6)
    np.testing.assert_allclose(l2_t.numpy(), np.asarray(l2_j), atol=1e-6)
    np.testing.assert_allclose(F_t.permute(0, 2, 3, 1).numpy(),
                               np.asarray(F_j), atol=1e-6)


def test_checkpoint_reader_matches_msgpack():
    msgpack = pytest.importorskip("msgpack")
    raw = open(R5B, "rb").read()

    def ext(code, data):
        assert code == 1
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape)

    want = msgpack.unpackb(raw, ext_hook=ext, strict_map_key=False)
    got = read_checkpoint(R5B)

    def leaves(t, pre=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{pre}/{k}")
        else:
            yield pre, t

    g, w = dict(leaves(got)), dict(leaves(want))
    assert sorted(g) == sorted(w)
    assert sum(1 for k in g if k.startswith("/params/")) == 258
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k])
    # and the state_dict it maps to fits the full cr.cf network
    net = TNet(tcfg.MsConfig())
    net.load_state_dict(params_from_jax(got["params"]), strict=True)
    k0 = got["params"]["params"]["dec0"]["tail"]["up0"]["kernel"]
    np.testing.assert_array_equal(net.dec0.tail.up0.weight.detach().numpy(),
                                  k0.transpose(3, 2, 0, 1))
