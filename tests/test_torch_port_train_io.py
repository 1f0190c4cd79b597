"""l3c_torch's training input and output against the JAX package's, on
the CPU: the data config, the image listing and the training batches, the
checkpoints (each package restores the other's), the keep policy, the
restore flags, and `cli.train --device cpu` on a tiny `.cf` pair whose
checkpoint both packages' testers then read.

The images are PNGs from a numpy seed, written by the port's writer (the
JAX package reads them with Pillow).
"""
import dataclasses
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import flax.serialization as fser
import pytest
import torch

from l3c_tpu import config as jconfig
from l3c_tpu.data import images as jimages
from l3c_tpu.eval.tester import MultiscaleTester as JTester
from l3c_tpu.models.network import MultiscaleNetwork as JNet
from l3c_tpu.train.saver import Restorer as JRestorer
from l3c_tpu.train.saver import Saver as JSaver
from l3c_tpu.train.trainer import Trainer as JTrainer
from l3c_torch import config as tcfg
from l3c_torch.cli import test as test_cli
from l3c_torch.cli import train as train_cli
from l3c_torch.data import images as timages
from l3c_torch.eval.tester import MultiscaleTester as TTester
from l3c_torch.models.network import MultiscaleNetwork as TNet
from l3c_torch.train.saver import Restorer, Saver
from l3c_torch.train.trainer import Trainer as TTrainer
from tests.test_torch_port_train import (assert_tree_close, batches, np_tree,
                                         tiny_cfgs)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_MS = ("num_scales = 2\nCf = 8\nenc.num_blocks = 1\n"
           "dec.num_blocks = 1\nq.C = 2\nq.L = 25\nprob.K = 2\n"
           "lr.schedule = 'exp_0.9_i1'\n")


def _pngs(d, sizes, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([yy * 5, xx * 7, (yy + xx) * 3], -1)
        img = ((base + rng.randint(0, 24, base.shape)) % 256).astype(
            np.uint8)
        timages.write_png(os.path.join(d, f"im{i}.png"), img)
    return d


def test_dl_config_matches_jax():
    for name in ("oi_offline.cf",):
        j = jconfig.load_dl_config(os.path.join(
            ROOT, "l3c_tpu", "configs", "dl", name), {"num_val_batches": 3})
        t = tcfg.load_dl_config(os.path.join(
            ROOT, "l3c_torch", "configs", "dl", name), {"num_val_batches": 3})
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(ValueError, match="Unknown dl config keys"):
        tcfg.dl_config_from_dict({"crop": 3})


@pytest.mark.parametrize("aug_strong", [False, True])
def test_train_batches_bitwise_equal_jax(tmp_path, aug_strong):
    """Same PNGs, seed and flags: the same batches, bit for bit, images
    smaller than the crop (reflection-padded) included; the listing with
    its min-size filter and cache as JAX's."""
    d = _pngs(str(tmp_path / "imgs"), [(40, 52), (20, 24), (33, 17),
                                       (64, 64), (18, 45)], 3)
    for min_size in (None, 30):
        paths = timages.ImagesCached(d, str(tmp_path / "t.pkl"),
                                     min_size).paths()
        assert paths == jimages.ImagesCached(d, str(tmp_path / "j.pkl"),
                                             min_size).paths()
        # the second call reads the cache
        assert timages.ImagesCached(d, str(tmp_path / "t.pkl"),
                                    min_size).paths() == paths
    paths = timages.ImagesCached(d).paths()
    tb = timages.TrainBatches(paths, 3, 24, seed=5, aug_strong=aug_strong)
    jb = jimages.TrainBatches(paths, 3, 24, seed=5, aug_strong=aug_strong)
    try:
        assert tb.epoch_len == jb.epoch_len
        for _, got, want in zip(range(5), iter(tb), iter(jb)):
            assert got.dtype == want.dtype == np.uint8
            assert got.shape == (3, 24, 24, 3)
            np.testing.assert_array_equal(got, want)
    finally:
        tb.close()
        jb.close()


def test_train_batches_raise_what_the_reader_raised(tmp_path):
    (tmp_path / "bad.png").write_bytes(b"not a png")
    tb = timages.TrainBatches([str(tmp_path / "bad.png")], 1, 8)
    try:
        with pytest.raises(RuntimeError, match="training batch"):
            next(iter(tb))
    finally:
        tb.close()


def _tiny_trainers():
    jc, tc = tiny_cfgs()
    jdl = jconfig.DlConfig(batchsize_train=2, batchsize_val=2, crop_size=16)
    tdl = tcfg.DlConfig(batchsize_train=2, batchsize_val=2, crop_size=16)
    return jc, tc, jdl, tdl


def test_port_checkpoint_read_by_jax_restorer(tmp_path):
    """Two port steps, saved; the JAX package's Restorer.restore(strict=
    True) into its own trainer's state gives every leaf as the port wrote
    it, and the JAX step from there runs."""
    jc, tc, jdl, tdl = _tiny_trainers()
    bs = batches(3)
    tr = TTrainer(tc, tdl, TNet(tc), iter(bs), out_dir=str(tmp_path),
                  epoch_len=10, device="cpu")
    tr.train(2, log_every=0, val_every=0)
    want = tr.state_tree()
    jtr = JTrainer(jc, jdl, JNet(jc), iter(bs), epoch_len=10)
    itr, got = JRestorer(str(tmp_path)).restore(jax.device_get(jtr.state),
                                                strict=True)
    assert itr == 2
    got = np_tree(got)
    assert_tree_close(got, want, 0)
    jtr.state = jax.device_put(jax.tree_util.tree_map(
        jnp.asarray, fser.from_state_dict(jax.device_get(jtr.state), got)))
    _, m = jtr._step(jtr.state, jnp.asarray(bs[2]))
    assert np.isfinite(float(m["loss_bpsp"]))


def test_jax_checkpoint_read_by_port_next_step_equal(tmp_path):
    """Three JAX steps, saved by its Saver (the final checkpoint at 3); the
    port restores it strictly and its next step equals JAX's next step
    (loss 1e-5 relative, nu and parameters as test_one_train_step)."""
    jc, tc, jdl, tdl = _tiny_trainers()
    bs = batches(4, seed=7)
    jtr = JTrainer(jc, jdl, JNet(jc), iter(bs), out_dir=str(tmp_path),
                   epoch_len=10)
    jtr.train(3, log_every=0, val_every=0)
    tr = TTrainer(tc, tdl, TNet(tc), iter([]), epoch_len=10, device="cpu")
    assert tr.restore(Restorer(str(tmp_path))) == 3
    assert tr.step == 3 and tr.count == 3
    assert_tree_close(tr.state_tree(), np_tree(jtr.state), 0)
    m = tr.train_step(bs[3])
    jtr.state, mj = jtr._step(jtr.state, jnp.asarray(bs[3]))
    assert float(m["loss_bpsp"]) == pytest.approx(float(mj["loss_bpsp"]),
                                                  rel=1e-5)
    assert m["lr"] == pytest.approx(float(mj["lr"]), rel=1e-6)
    got, want = tr.state_tree(), np_tree(jtr.state)
    assert int(got["step"]) == 4
    assert_tree_close(got["opt_state"], want["opt_state"], 2e-4)
    lr = float(mj["lr"])
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(want["params"])):
        assert np.abs(a - b).max() <= 2 * lr * 10 * (1 + 1e-3)


def test_saver_keep_policy_as_jax(tmp_path):
    """The port's Saver keeps the files JAX's keeps (tests/test_training.py
    ::test_saver_keep_policy), and the port's Restorer picks as JAX's."""
    names = {}
    for pkg, saver_cls in (("port", Saver), ("jax", JSaver)):
        out = str(tmp_path / pkg)
        saver = saver_cls(out, keep_tmp_itr=10, keep_every=3,
                          keep_tmp_last=2)
        for itr in range(10, 101, 10):
            assert saver.save_due(itr)
            saver.save({"params": {"w": np.zeros(3, np.float32)},
                        "opt_state": {}, "step": np.asarray(itr, np.int32)},
                       itr)
        names[pkg] = sorted(os.listdir(os.path.join(out, "ckpts")))
    assert names["port"] == names["jax"] == [
        "ckpt_0000000030.ckpt", "ckpt_0000000060.ckpt",
        "ckpt_0000000090.ckpt", "ckpt_0000000100.ckpt.tmp"]
    tmpl = {"params": {"w": np.zeros(3, np.float32)}, "opt_state": {},
            "step": np.zeros((), np.int32)}
    r = Restorer(str(tmp_path / "port"))
    for want_itr, ask in ((100, -1), (60, 65), (30, 5)):
        itr, got = r.restore(tmpl, itr=ask)
        assert itr == want_itr and int(got["step"]) == want_itr
    # the files themselves are flax's bytes for the same tree
    with open(tmp_path / "port" / "ckpts" / "ckpt_0000000060.ckpt",
              "rb") as f, open(tmp_path / "jax" / "ckpts" /
                               "ckpt_0000000060.ckpt", "rb") as g:
        assert f.read() == g.read()


def test_restore_non_strict_and_restart(tmp_path):
    """strict=False adopts the leaves whose shapes match and keeps the
    fresh ones elsewhere (a changed classifier); strict raises there;
    restart keeps the params only (fresh optimizer state, step 0)."""
    _, tc, _, tdl = _tiny_trainers()
    bs = batches(2)
    tr = TTrainer(tc, tdl, TNet(tc), iter(bs), out_dir=str(tmp_path),
                  epoch_len=10, device="cpu")
    tr.train(2, log_every=0, val_every=0)
    saved = tr.state_tree()
    tc3 = dataclasses.replace(tc, prob=tcfg.ProbConfig(K=3))
    tr3 = TTrainer(tc3, tdl, TNet(tc3), iter([]), epoch_len=10, seed=4,
                   device="cpu")
    fresh = tr3.state_tree()
    with pytest.raises(ValueError, match="shape"):
        tr3.restore(Restorer(str(tmp_path)))
    assert tr3.restore(Restorer(str(tmp_path)), strict=False) == 2
    got = tr3.state_tree()
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    g, s, f = flat(got["params"]), flat(saved["params"]), flat(fresh["params"])
    adopted = [k for k in g if np.array_equal(g[k], s.get(k))]
    kept = [k for k in g if np.array_equal(g[k], f[k])
            and not np.array_equal(g[k], s.get(k))]
    assert len(adopted) + len(kept) == len(g) and kept and adopted
    assert all("clf" in jax.tree_util.keystr(k) for k in kept)
    assert int(got["step"]) == 2
    tr_r = TTrainer(tc, tdl, TNet(tc), iter([]), epoch_len=10, device="cpu")
    assert tr_r.restore(Restorer(str(tmp_path)), restart=True) == 0
    assert tr_r.step == tr_r.count == tr_r.start_itr == 0
    assert not any(np.any(v) for v in jax.tree_util.tree_leaves(
        tr_r.state_tree()["opt_state"]))
    assert_tree_close(tr_r.state_tree()["params"], saved["params"], 0)


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    cfgs = root / "configs"
    (cfgs / "ms").mkdir(parents=True)
    (cfgs / "dl").mkdir()
    (cfgs / "ms" / "tiny.cf").write_text(TINY_MS)
    _pngs(str(root / "train"), [(40, 52), (20, 24), (33, 37), (64, 48)], 1)
    _pngs(str(root / "val"), [(24, 24), (30, 28)], 2)
    (cfgs / "dl" / "tinydl.cf").write_text(
        "batchsize_train = 2\nbatchsize_val = 2\ncrop_size = 16\n"
        f"train_imgs_glob = '{root / 'train'}'\nval_glob = '{root / 'val'}'\n"
        "num_val_batches = 1\naug_strong = True\nreal_oversample = 2\n")
    return dict(root=str(root), ms=str(cfgs / "ms" / "tiny.cf"),
                dl=str(cfgs / "dl" / "tinydl.cf"), cfgs=str(cfgs),
                logs=str(root / "logs"))


def _train(w, *extra):
    return train_cli.main([w["ms"], w["dl"], w["logs"], "--device", "cpu",
                           "--log_train", "1", "--log_val", "2", *extra])


def test_cli_train_on_cpu_then_both_testers_read_it(cli_world, capsys):
    """cli.train --device cpu: 3 steps, a checkpoint at 3 in a new log dir
    named after the configs; cli.test and the JAX tester read it, with
    theory bpsp within 1e-4 relative of each other; --debug takes one step
    and one validation pass; --log_train_heavy trains with the heavy
    summaries in a log dir of its own, and -p compute_dtype='bfloat16'
    trains a step in another."""
    w = cli_world
    assert _train(w, "--num_itr", "3") == 0
    out = capsys.readouterr().out
    assert "real_oversample=2" in out and "VAL bpsp=" in out
    (log_dir,) = os.listdir(w["logs"])
    assert log_dir.endswith(" tiny tinydl")
    assert os.listdir(os.path.join(w["logs"], log_dir, "ckpts")) == [
        "ckpt_0000000003.ckpt.tmp"]
    date = log_dir.split()[0]
    assert test_cli.main([w["logs"], date, os.path.join(w["root"], "val"),
                          "--config_roots", w["cfgs"], "--device", "cpu",
                          "--reset_cache"]) == 0
    shown = float(capsys.readouterr().out.strip().splitlines()[-1].split()[-1])
    ld = os.path.join(w["logs"], log_dir)
    tt = TTester.from_log_dir(ld, [w["cfgs"]], use_cache=False, device="cpu")
    jt = JTester.from_log_dir(ld, [w["cfgs"]], use_cache=False)
    assert tt.restore_itr == jt.restore_itr == 3
    ts = timages.Testset(os.path.join(w["root"], "val"))
    t_bpsp = tt.test(ts).mean_bpsp()
    j_bpsp = jt.test(jimages.Testset(os.path.join(w["root"], "val"))
                     ).mean_bpsp()
    assert t_bpsp == pytest.approx(j_bpsp, rel=1e-4)
    assert f"{t_bpsp:.4f}" == f"{shown:.4f}"

    assert _train(w, "--debug") == 0
    out = capsys.readouterr().out
    assert "'val_bpsp'" in out and "'loss_bpsp'" in out
    # --log_train_heavy (once refused) trains with the heavy summaries on
    n_dirs = len(os.listdir(w["logs"]))
    assert _train(w, "--num_itr", "2", "--log_train_heavy", "1") == 0
    out = capsys.readouterr().out
    assert np.isfinite(float(out.split(" loss=")[1].split()[0]))
    assert len(os.listdir(w["logs"])) == n_dirs + 1
    n_dirs = len(os.listdir(w["logs"]))
    assert _train(w, "--num_itr", "1", "-p", "compute_dtype='bfloat16'") == 0
    out = capsys.readouterr().out
    loss = float(out.split(" loss=")[1].split()[0])
    assert np.isfinite(loss)
    assert len(os.listdir(w["logs"])) == n_dirs + 1


def test_cli_train_restore_flags(cli_world, capsys):
    """--restore continues at the restored step (r@DATE in the new log
    dir's name), --restore_continue trains in the restored dir,
    --restore_restart starts at 0 with the restored params, and
    --restore_strict 0 warm-starts a changed classifier. Each restore runs
    in a log root of its own holding a copy of the first run (two log dirs
    of one minute make its date ambiguous, in both packages)."""
    w = dict(cli_world, logs=os.path.join(cli_world["root"], "logs_first"))
    assert _train(w, "--num_itr", "2") == 0
    (first,) = os.listdir(w["logs"])
    date = first.split()[0]

    def restored(name, *extra):
        root = os.path.join(cli_world["root"], name)
        shutil.copytree(os.path.join(w["logs"], first),
                        os.path.join(root, first))
        capsys.readouterr()
        assert _train(dict(w, logs=root), "--restore", date, *extra) == 0
        return root, capsys.readouterr().out

    root, out = restored("logs_cont", "--num_itr", "2", "--restore_continue")
    assert "restored itr 2" in out and "       4 loss=" in out
    assert os.listdir(root) == [first]
    assert sorted(os.listdir(os.path.join(root, first, "ckpts"))) == [
        "ckpt_0000000002.ckpt.tmp", "ckpt_0000000004.ckpt.tmp"]
    root, out = restored("logs_new", "--num_itr", "1")
    assert "restored itr 2" in out and "       3 loss=" in out
    assert sorted(d.split(" ", 1)[1] for d in os.listdir(root)) == [
        "tiny tinydl", f"tiny tinydl r@{date}"]
    _, out = restored("logs_restart", "--num_itr", "1", "--restore_restart")
    assert "restored itr 0" in out and "       1 loss=" in out
    with pytest.raises(ValueError, match="shape"):
        restored("logs_strict", "--num_itr", "1", "-p", "prob.K=3")
    _, out = restored("logs_loose", "--num_itr", "1", "-p", "prob.K=3",
                      "--restore_strict", "0")
    assert "restored itr 2" in out and "       3 loss=" in out
