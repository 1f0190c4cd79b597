"""l3c_torch/parallel/spatial.py against l3c_tpu/parallel/spatial.py, on
the CPU, over several `cpu` device slots (the JAX package over the
conftest's virtual CPU devices).

- halo_exchange: each slab's halo rows are exactly its neighbours' edge
  rows, the global edges zeros (tests/test_spatial.py's case);
- _check_geometry: the same cases and errors as JAX's;
- spatial_bpsp against JAX's spatial_bpsp at the same n and halo, within
  1e-5 relative (the float32 sums of the two libraries);
- against the port's own unsharded forward at JAX's gate: H 1024, W 32,
  halo 128, 8 slabs, 2e-3 relative (the global-edge effect the JAX
  package measured);
- the tester's spatial_shard against auto-crop tiling (rtol 0.05, as JAX
  holds it), with the sharded fn cached per padded shape.

tests/test_spatial.py's small config; weights from JAX's init through
params_from_jax.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l3c_tpu.config import (DecConfig, EncConfig, MsConfig, ProbConfig,
                            QConfig)
from l3c_tpu.models.network import MultiscaleNetwork as JNet
from l3c_tpu.parallel import mesh as jmesh
from l3c_tpu.parallel import spatial as jspatial
from l3c_torch import blueprint
from l3c_torch import config as tcfg
from l3c_torch.data.images import write_png
from l3c_torch.eval.tester import MultiscaleTester
from l3c_torch.models.network import MultiscaleNetwork as TNet
from l3c_torch.models.weights import params_from_jax
from l3c_torch.parallel import mesh, spatial

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def nets():
    jc = MsConfig(num_scales=3, Cf=16, enc=EncConfig(num_blocks=2),
                  dec=DecConfig(num_blocks=2), q=QConfig(C=5, L=25),
                  prob=ProbConfig(K=3))
    tc = tcfg.MsConfig(num_scales=3, Cf=16, enc=tcfg.EncConfig(num_blocks=2),
                       dec=tcfg.DecConfig(num_blocks=2),
                       q=tcfg.QConfig(C=5, L=25), prob=tcfg.ProbConfig(K=3))
    jn = JNet(jc)
    params = jax.jit(jn.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 3)))
    tn = TNet(tc)
    tn.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    return dict(jc=jc, jn=jn, params=params, tc=tc, tn=tn)


def _smooth(H, W, seed=0):
    """A smooth-ish image (blocks of 32 x 8), as tests/test_spatial.py."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (H // 32, W // 8, 3)).astype(np.float32)
    return np.kron(base, np.ones((32, 8, 1))).astype(np.uint8)[None]


def test_halo_exchange_rows():
    n, h, W = 4, 8, 4
    x = np.arange(n * h * W, dtype=np.float32).reshape(n, 1, h, W, 1)
    out = [o.numpy() for o in spatial.halo_exchange(
        [torch.from_numpy(s) for s in x], halo=2)]
    assert all(o.shape == (1, h + 4, W, 1) for o in out)
    for i in range(n):
        np.testing.assert_array_equal(out[i][:, 2:-2], x[i])
    # interior slab 1: top halo == slab 0's last rows, bottom == slab 2's
    np.testing.assert_array_equal(out[1][:, :2], x[0][:, -2:])
    np.testing.assert_array_equal(out[1][:, -2:], x[2][:, :2])
    assert (out[0][:, :2] == 0).all() and (out[3][:, -2:] == 0).all()


def test_spatial_geometry_checks(nets):
    tc, tn = nets["tc"], nets["tn"]
    with pytest.raises(ValueError, match="divide"):
        spatial.spatial_bpsp_fn(tc, tn, ["cpu"] * 8, H=100, W=32, halo=16)
    with pytest.raises(ValueError, match="multiples"):
        spatial.spatial_bpsp_fn(tc, tn, ["cpu"] * 8, H=256, W=32, halo=12)
    with pytest.raises(ValueError, match="exceeds slab height"):
        spatial.spatial_bpsp_fn(tc, tn, ["cpu"] * 8, H=256, W=32, halo=64)
    assert spatial._check_geometry(tc, 256, 8, 32) == 32


def test_spatial_bpsp_matches_jax(nets):
    img = _smooth(256, 32, seed=1)
    jm = jmesh.make_mesh(jax.devices()[:4])
    want = jspatial.spatial_bpsp(nets["jc"], nets["jn"], nets["params"], jm,
                                 img, halo=32)
    got = spatial.spatial_bpsp(nets["tc"], nets["tn"], ["cpu"] * 4, img,
                               halo=32)
    assert got == pytest.approx(want, rel=1e-5)


def test_spatial_bpsp_matches_the_unsharded_forward(nets):
    tc, tn = nets["tc"], nets["tn"]
    img = _smooth(1024, 32)
    with torch.inference_mode():
        ref = float(blueprint.total_bpsp(blueprint.compute_loss(
            tc, tn(torch.from_numpy(img).float(), train=False))))
    got = spatial.spatial_bpsp(tc, tn, ["cpu"] * 8, img, halo=128)
    assert got == pytest.approx(ref, rel=2e-3), (got, ref)
    # one slab: the same global zero rows, nothing exchanged
    one = spatial.spatial_bpsp(tc, tn, ["cpu"], img, halo=128)
    assert got == pytest.approx(one, rel=1e-5)


def test_tester_spatial_shard_matches_auto_crop(nets, tmp_path, monkeypatch):
    monkeypatch.setenv("AC_NEEDS_CROP_DIM", "48,48")  # force tiny limit
    monkeypatch.setattr(mesh, "local_devices",
                        lambda device=None: [torch.device("cpu")] * 8)
    rng = np.random.RandomState(11)
    base = rng.randint(60, 200, (1, 1, 1, 3))
    img = np.clip(base + rng.randint(-40, 40, (1, 64, 64, 3)),
                  0, 255).astype(np.uint8)
    write_png(str(tmp_path / "big.png"), img[0])

    class OneImg:
        id = "one"

        def __iter__(self):
            return iter([str(tmp_path / "big.png")])

    tc, tn = nets["tc"], nets["tn"]
    t_ac = MultiscaleTester(tc, tn, use_cache=False, device="cpu")
    t_sp = MultiscaleTester(tc, tn, use_cache=False, spatial_shard=True,
                            spatial_halo=16, device="cpu")
    assert t_sp.spatial_shard and not t_ac.spatial_shard
    b_ac = t_ac.test(OneImg()).mean_bpsp()
    b_sp = t_sp.test(OneImg()).mean_bpsp()
    assert list(t_sp._spatial_cache) == [(64, 64)]
    np.testing.assert_allclose(b_sp, b_ac, rtol=0.05)
    monkeypatch.setattr(mesh, "local_devices",
                        lambda device=None: [torch.device("cpu")])
    assert not MultiscaleTester(tc, tn, use_cache=False, spatial_shard=True,
                                device="cpu").spatial_shard
