"""The port's checkpoint importer (l3c_torch/convert/torch_import.py) and
convert CLI (l3c_torch/cli/convert.py) against the JAX package's, on the
CPU, on the oracle layouts tests/test_torch_import.py builds (torch
modules named exactly as the reference's state_dict; the repo holds no
released weights):

- import_state_dict gives the JAX importer's flax-layout leaves bit for
  bit (same keys, dtypes and bytes) for the small config, the flagship
  cr.cf shape and both RGB baselines, and params_from_jax carries them
  into the port's MultiscaleNetwork strictly;
- load_torch_checkpoint reads the three blob layouts and the itr from the
  file name; drifted MeanShift constants or level tables raise;
- the convert CLI writes the JAX CLI's checkpoint file byte for byte, and
  its log dir restores through the port's tester at the same itr, whose
  forward matches the torch oracle at the JAX test's tolerance.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from l3c_tpu import config as jcfg
from l3c_tpu.convert import torch_import as jimport
from l3c_torch import config as tcfg
from l3c_torch.convert import torch_import as timport
from l3c_torch.models import layers
from l3c_torch.models.network import MultiscaleNetwork
from l3c_torch.models.weights import params_from_jax, read_checkpoint
from test_torch_import import TBicubicNet, TNet

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ("num_scales = 2\nCf = 8\nenc.num_blocks = 2\ndec.num_blocks = 2\n"
         "q.C = 4\nq.L = 25\nprob.K = 2\n")


def _cfgs(name, tmp_path):
    """(JAX config, port config) of a layout's .cf."""
    if name == "small":
        p = tmp_path / "small.cf"
        p.write_text(SMALL)
        return jcfg.load_ms_config(str(p)), tcfg.load_ms_config(str(p))
    return (jcfg.load_ms_config(os.path.join(ROOT, "l3c_tpu", "configs",
                                             "ms", name)),
            tcfg.load_ms_config(os.path.join(ROOT, "l3c_torch", "configs",
                                             "ms", name)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _same_leaves(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k
    return len(fa)


@pytest.mark.parametrize("name", ["small", "cr.cf", "cr_rgb.cf",
                                  "cr_rgb_shared.cf"])
def test_import_state_dict_equals_jax_bitwise(name, tmp_path):
    jc, tc = _cfgs(name, tmp_path)
    torch.manual_seed(3)
    oracle = (TBicubicNet(jc) if jc.rgb_bicubic_baseline else TNet(jc))
    sd = {k: v.detach().numpy() for k, v in oracle.state_dict().items()}
    got = timport.import_state_dict(sd, tc)
    n = _same_leaves(got, jimport.import_state_dict(sd, jc))
    net = MultiscaleNetwork(tc)
    net.load_state_dict(params_from_jax(got), strict=True)
    assert n == len(net.state_dict())
    # the three blob layouts of a reference .pt; itr stored or from the name
    optim = torch.optim.RMSprop(oracle.parameters(), lr=1e-4)
    blobs = {"net": {"net": oracle.state_dict(),
                     "optim": optim.state_dict()},
             "modules": {"modules": {"net": oracle.state_dict()},
                         "itr": 1234},
             "bare": oracle.state_dict()}
    for kind, blob in blobs.items():
        pt = str(tmp_path / "ckpt_0000500000.pt")
        torch.save(blob, pt)
        itr, variables = timport.load_torch_checkpoint(pt, tc)
        assert itr == (1234 if kind == "modules" else 500000)
        assert (itr, n) == (jimport.load_torch_checkpoint(pt, jc)[0],
                            _same_leaves(variables, got))


def test_drifted_fixed_convs_and_levels_raise(tmp_path):
    jc, tc = _cfgs("small", tmp_path)
    torch.manual_seed(0)
    sd = {k: v.detach().numpy().copy()
          for k, v in TNet(jc).state_dict().items()}
    timport.import_state_dict(sd, tc)
    for key in ("heads.0.head.0.weight", "nets.1.enc.levels"):
        bad = dict(sd)
        bad[key] = sd[key] + np.float32(1e-3)
        with pytest.raises(AssertionError):
            timport.import_state_dict(bad, tc)
    bad = dict(sd)
    bad["sub_rgb_mean.weight"] = np.eye(3, dtype=np.float32).reshape(
        3, 3, 1, 1) * 2
    bad["sub_rgb_mean.bias"] = np.zeros(3, np.float32)
    with pytest.raises(AssertionError):
        timport.import_state_dict(bad, tc)


def test_convert_cli_round_trip(tmp_path):
    """.pt -> cli.convert (both packages) -> the same checkpoint bytes; the
    port's tester restores it at the .pt's itr and its forward is the
    torch oracle's."""
    from l3c_tpu.cli.convert import main as jconvert
    from l3c_torch.cli.convert import main as tconvert
    from l3c_torch.eval.tester import MultiscaleTester
    cfg_root = tmp_path / "configs"
    (cfg_root / "ms").mkdir(parents=True)
    (cfg_root / "dl").mkdir()
    ms_p = str(cfg_root / "ms" / "small.cf")
    open(ms_p, "w").write(SMALL)
    # the default --dl_config_p: dl/oi.cf beside the ms config's directory
    shutil.copy(os.path.join(ROOT, "l3c_torch", "configs", "dl", "oi.cf"),
                cfg_root / "dl" / "oi.cf")
    jc, tc = _cfgs("small", tmp_path)
    torch.manual_seed(1)
    oracle = TNet(jc).eval()
    pt = str(tmp_path / "ckpt_0000600000.pt")
    torch.save({"net": oracle.state_dict(), "optim": {}}, pt)
    files = {}
    for tag, main in (("port", tconvert), ("jax", jconvert)):
        logs = tmp_path / f"logs_{tag}"
        assert main([pt, ms_p, str(logs)]) == 0
        (name,) = os.listdir(logs)
        assert name.split()[1:] == ["small", "oi", "imported"]
        ck = logs / name / "ckpts" / "ckpt_0000600000.ckpt"
        files[tag] = (str(logs / name), ck.read_bytes())
    assert files["port"][1] == files["jax"][1]
    saved = read_checkpoint(str(tmp_path / files["port"][0] / "ckpts" /
                                "ckpt_0000600000.ckpt"))
    assert saved["opt_state"] == {} and int(saved["step"]) == 600000
    tester = MultiscaleTester.from_log_dir(files["port"][0], [str(cfg_root)],
                                           use_cache=False, device="cpu")
    assert tester.restore_itr == 600000
    img = np.random.RandomState(7).randint(0, 256, (1, 16, 16, 3)).astype(
        np.float32)
    x_norm = img - np.float32(255.0) * layers.RGB_MEAN
    with torch.no_grad():
        _, t_Ps = oracle(torch.from_numpy(x_norm.transpose(0, 3, 1, 2)))
        out = tester.net(torch.from_numpy(img))
    for s in range(tc.num_scales):
        np.testing.assert_allclose(
            out.P[s].numpy(), t_Ps[s].numpy().transpose(0, 2, 3, 1),
            atol=2e-4, rtol=1e-4)
