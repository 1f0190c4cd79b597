"""l3c_torch/parallel/fanout.py against l3c_tpu/parallel/fanout.py, on the
CPU, over several `cpu` device slots (the JAX package over the conftest's
virtual CPU devices).

- CodecFanout over two slots, group 2: the files decode bit-exactly with
  the slots rotated (group 0, encoded on slot 0, decodes on slot 1), and
  each is byte-identical to a single TorchBitcoding.encode_batch of the
  same group; slots that mix device kinds are refused;
- eval_testset_sharded against JAX's over 8 and 3 devices on 11 crops (a
  ragged tail each time, padded with its first crop): within 1e-5
  relative, and equal to the port's own per-image mean;
- cli.test --write_to_files --fanout (mesh.local_devices giving two cpu
  slots): every image bit-exact, the files byte-identical to the run
  without --fanout, both slots' codecs used.

The tiny configs of tests/test_fanout.py; weights from JAX's init through
params_from_jax.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l3c_tpu.config import (DecConfig, EncConfig, MsConfig, ProbConfig,
                            QConfig)
from l3c_tpu.models.network import MultiscaleNetwork as JNet
from l3c_tpu.parallel import fanout as jfanout
from l3c_tpu.parallel import mesh as jmesh
from l3c_torch import config as tcfg
from l3c_torch.cli import test as test_cli
from l3c_torch.codec.bitcoding2 import TorchBitcoding
from l3c_torch.data.images import write_png
from l3c_torch.models.network import MultiscaleNetwork as TNet
from l3c_torch.models.weights import params_from_jax
from l3c_torch.parallel import fanout, mesh
from l3c_torch.train.saver import Saver

torch.set_num_threads(1)


def _cfgs():
    j = MsConfig(num_scales=2, Cf=8, enc=EncConfig(num_blocks=1),
                 dec=DecConfig(num_blocks=1), q=QConfig(C=2, L=25),
                 prob=ProbConfig(K=2))
    t = tcfg.MsConfig(num_scales=2, Cf=8, enc=tcfg.EncConfig(num_blocks=1),
                      dec=tcfg.DecConfig(num_blocks=1),
                      q=tcfg.QConfig(C=2, L=25), prob=tcfg.ProbConfig(K=2))
    return j, t


def _batch(n, crop, seed=0):
    """tests/test_fanout.py's recipe: gradients plus noise, uint8."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 255, size=(n, 1, 1, 3))
    gy = np.linspace(0, 1, crop)[None, :, None, None]
    gx = np.linspace(0, 1, crop)[None, None, :, None]
    img = (a * gy + (255 - a) * gx) / (gy + gx + 1e-9).clip(min=1)
    return np.clip(img + rng.randn(n, crop, crop, 3) * 4, 0,
                   255).astype(np.uint8)


@pytest.fixture(scope="module")
def nets():
    jc, tc = _cfgs()
    jn = JNet(jc)
    params = jax.jit(lambda: jn.init(jax.random.PRNGKey(1),
                                     jnp.zeros((1, 16, 16, 3))))()
    tn = TNet(tc)
    tn.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    return dict(jc=jc, jn=jn, params=params, tc=tc, tn=tn)


def test_codec_fanout_rotated_bit_exact_and_files_as_one_codec(nets,
                                                               tmp_path):
    tc, tn = nets["tc"], nets["tn"]
    imgs = [_batch(1, 32, seed=i) for i in range(4)]
    pouts = [str(tmp_path / f"i{i}.l3c") for i in range(4)]
    fo = fanout.CodecFanout(tc, tn, ["cpu", "cpu"], group=2)
    assert len(fo.codecs) == 2 and fo.codecs[0] is not fo.codecs[1]
    bpsps = fo.encode_paths(imgs, pouts)
    assert all(b > 0 for b in bpsps) and len(fo.last_unit_bytes) == 4
    rot = fanout.CodecFanout(tc, tn, ["cpu", "cpu"][::-1], group=2)
    used = []
    for k, bc in enumerate(rot.codecs):
        orig = bc.decode_batch_async
        bc.decode_batch_async = (lambda pins, k=k, orig=orig:
                                 used.append(k) or orig(pins))
    for im, out in zip(imgs, rot.decode_paths(pouts)):
        np.testing.assert_array_equal(out, im)
    assert used == [0, 1]
    one = TorchBitcoding(tc, tn, device="cpu")
    for g in range(2):
        paths = [str(tmp_path / f"one{g}_{b}.l3c") for b in range(2)]
        assert one.encode_batch(imgs[2 * g: 2 * g + 2], paths) \
            == bpsps[2 * g: 2 * g + 2]
        for b, p in enumerate(paths):
            assert open(p, "rb").read() == open(pouts[2 * g + b],
                                                 "rb").read()
    with pytest.raises(ValueError, match="mix kinds"):
        fanout.CodecFanout(tc, tn, ["cpu", "cuda:0"], group=2)
    with pytest.raises(ValueError, match="images"):
        fo.encode_paths(imgs, pouts[:3])


@pytest.mark.parametrize("n_dev", [8, 3])
def test_eval_testset_sharded_matches_jax(nets, n_dev):
    crops = [_batch(1, 16, seed=i)[0] for i in range(11)]
    jm = jmesh.make_mesh(jax.devices()[:n_dev])
    want = jfanout.eval_testset_sharded(nets["jc"], nets["jn"],
                                        nets["params"], jm, crops)
    got = fanout.eval_testset_sharded(nets["tc"], nets["tn"],
                                      ["cpu"] * n_dev, crops)
    assert got == pytest.approx(want, rel=1e-5)
    fwd = fanout._per_example_bpsp_fwd(nets["tc"], nets["tn"])
    one = np.mean([float(fwd(torch.from_numpy(c[None]).float())[0])
                   for c in crops])
    assert got == pytest.approx(one, rel=1e-6)
    with pytest.raises(ValueError, match="does not split"):
        fanout.sharded_eval_fn(nets["tc"], nets["tn"], ["cpu"] * n_dev)(
            np.stack(crops[:n_dev + 1]))


def test_cli_write_to_files_fanout(nets, tmp_path, monkeypatch, capsys):
    """A log dir with the tiny model's checkpoint, four 20x24 PNGs and one
    17x30: --fanout codes the 20x24 group of four as two groups of two,
    one a slot."""
    cfg_root = tmp_path / "configs"
    (cfg_root / "ms").mkdir(parents=True)
    (cfg_root / "dl").mkdir()
    (cfg_root / "ms" / "tiny.cf").write_text(
        "num_scales = 2\nCf = 8\nenc.num_blocks = 1\ndec.num_blocks = 1\n"
        "q.C = 2\nq.L = 25\nprob.K = 2\n")
    (cfg_root / "dl" / "tinydl.cf").write_text("crop_size = 16\n")
    log_dir = tmp_path / "logs" / "0102_0304 tiny tinydl"
    Saver(str(log_dir)).save({"params": jax.tree_util.tree_map(
        np.asarray, nets["params"]), "opt_state": {},
        "step": np.asarray(7, np.int32)}, 7)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.RandomState(3)
    for i, (h, w) in enumerate([(20, 24)] * 4 + [(17, 30)]):
        write_png(str(imgs / f"im{i}.png"),
                  rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    monkeypatch.setattr(mesh, "local_devices",
                        lambda device=None: [torch.device("cpu")] * 2)
    calls = []
    orig = fanout.CodecFanout.encode_paths
    monkeypatch.setattr(fanout.CodecFanout, "encode_paths",
                        lambda self, i, p: calls.append(len(i))
                        or orig(self, i, p))
    args = [str(tmp_path / "logs"), "0102", str(imgs), "--config_roots",
            str(cfg_root), "--device", "cpu", "--reset_cache",
            "--eval_batch", "2", "--compare_theory"]
    out = {}
    for name, extra in (("plain", []), ("fan", ["--fanout"])):
        d = tmp_path / name
        assert test_cli.main(args + ["--write_to_files", str(d)]
                             + extra) == 0
        out[name] = capsys.readouterr().out.strip().splitlines()[-1]
        assert sorted(os.listdir(d)) == [f"im{i}.l3c" for i in range(5)]
    assert calls == [1, 4]          # the 17x30 image, the 20x24 group
    assert out["fan"] == out["plain"]
    for i in range(5):
        a = open(tmp_path / "plain" / f"im{i}.l3c", "rb").read()
        assert a == open(tmp_path / "fan" / f"im{i}.l3c", "rb").read()
