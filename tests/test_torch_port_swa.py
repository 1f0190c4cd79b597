"""The port's SWA builder (l3c_torch/tools/swa.py) against tools/swa.py,
on the CPU.

For the same persistent checkpoints, written by the port's Saver (the JAX
package's file format), the port's output file is byte-identical to
tools/swa.py's run in-process, with --last picking the newest K; the
averaged leaves are the float64 mean of the inputs cast back; the output
restores through the port's tester into a network strictly.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from l3c_torch import config as tcfg
from l3c_torch.models import weights
from l3c_torch.models.network import MultiscaleNetwork
from l3c_torch.tools import swa as tswa
from l3c_torch.train.saver import Saver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_swa():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_swa", os.path.join(ROOT, "tools", "swa.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A training run's log dir: five persistent checkpoints (and a
    temporary one, which SWA ignores) of a tiny network's parameters,
    float32, with an optimizer state and a step."""
    d = tmp_path_factory.mktemp("swa")
    cfg = tcfg.MsConfig(num_scales=2, Cf=8, enc=tcfg.EncConfig(num_blocks=1),
                        dec=tcfg.DecConfig(num_blocks=1),
                        q=tcfg.QConfig(C=4, L=25), prob=tcfg.ProbConfig(K=2))
    net = MultiscaleNetwork(cfg)
    log_dir = d / "0101_0000 tiny tinydl"
    saver = Saver(str(log_dir), keep_tmp_itr=10, keep_every=1)
    g = torch.Generator().manual_seed(0)
    trees = []
    for i in range(5):
        net.init_weights(g)
        tree = weights.params_to_jax({k: v.clone() for k, v in
                                      net.state_dict().items()})
        for leaf in weights._flatten(tree).values():
            leaf += np.float32(0.01 * (i + 1))     # biases move too
        trees.append(tree)
        saver.save({"params": tree, "opt_state": {"0": {"count": np.int32(
            i)}}, "step": 10 * (i + 1)}, 10 * (i + 1))
    tmp = Saver(str(log_dir), keep_tmp_itr=10, keep_every=100)
    tmp.save({"params": trees[0], "opt_state": {}, "step": 60}, 60)
    return dict(cfg=cfg, log_dir=str(log_dir), trees=trees, root=d)


@pytest.mark.parametrize("last", [3, 10])
def test_output_byte_identical_to_tools_swa(run, last, monkeypatch, capsys):
    out_t = os.path.join(run["root"], f"0102_0000 tiny tinydl swa{last}")
    out_j = os.path.join(run["root"], f"jax{last}", "0102_0000 tiny tinydl")
    assert tswa.main([run["log_dir"], out_t, "--last", str(last)]) == 0
    monkeypatch.setattr(sys, "argv", ["swa.py", run["log_dir"], out_j,
                                      "--last", str(last)])
    _jax_swa().main()
    assert "averaging" in capsys.readouterr().out
    (name,) = os.listdir(os.path.join(out_t, "ckpts"))
    assert name == "ckpt_0000000050.ckpt"
    a = open(os.path.join(out_t, "ckpts", name), "rb").read()
    b = open(os.path.join(out_j, "ckpts", name), "rb").read()
    assert a == b
    # the float64 mean of the newest `last`, cast back to float32
    picked = run["trees"][-last:]
    got = weights._flatten(weights.unpackb(a)["params"])
    for k, v in got.items():
        want = (sum(weights._flatten(t)[k].astype(np.float64)
                    for t in picked) / float(len(picked))).astype(np.float32)
        assert v.dtype == np.float32 and np.array_equal(v, want), k
    assert weights.unpackb(a)["step"] == 50
    assert set(weights.unpackb(a)) == {"params", "step"}


def test_output_restores_through_the_tester(run):
    from l3c_torch.eval.tester import MultiscaleTester
    out = os.path.join(run["root"], "0103_0000 tiny tinydl swa")
    tswa.main([run["log_dir"], out, "--last", "2"])
    itr, sd = weights.restore_params_only(out)
    assert itr == 50
    net = MultiscaleNetwork(run["cfg"])
    net.load_state_dict(sd, strict=True)
    tester = MultiscaleTester(run["cfg"], net, device="cpu", restore_itr=itr)
    img = np.random.RandomState(0).randint(0, 256, (1, 16, 16, 3))
    with torch.inference_mode():
        bpsp = float(tester._scale_bpsps(img.astype(np.uint8)).sum())
    assert np.isfinite(bpsp) and bpsp > 0


def test_no_persistent_checkpoint_raises(tmp_path):
    (tmp_path / "ckpts").mkdir()
    (tmp_path / "ckpts" / "ckpt_0000000010.ckpt.tmp").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="no persistent"):
        tswa.main([str(tmp_path), str(tmp_path / "out")])
