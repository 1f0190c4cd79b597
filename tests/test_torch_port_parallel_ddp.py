"""Data-parallel training (DDP over gloo ranks started by the spawn method)
against the JAX package's data-parallel step, on the CPU.

- two ranks, one step on the same batch from the same state as JAX's
  data_parallel_jit over make_mesh(jax.devices()[:2]): the loss within
  1e-5 relative, every parameter within rtol 2e-4 / atol 2e-6 (JAX's own
  single- vs multi-device tolerances, tests/test_fanout.py). The state is
  the one after a single-device JAX step, so RMSprop's nu is not 0: its
  first update from nu = 0 is ~lr * 10 * sign(g), which turns a last-ulp
  difference of a near-zero gradient between the two libraries into a
  step of up to 2 lr 10 (test_torch_port_train.test_one_train_step_
  matches_jax compares that step with its own mask);
- one rank: every step's loss and parameters equal the plain Trainer's
  bit for bit (DDP's allreduce over one rank and its division by 1 change
  nothing);
- cli.train in two ranks (the CLI's own rank entry): one log dir, rank 0's
  checkpoint restored strictly by JAX's Restorer, its leaves the
  single-process run's names;
- every parameter of cr.cf, cr_rgb.cf and cr_rgb_shared.cf takes part in
  a training forward (so DDP needs no search for unused parameters);
- cli.train under L3C_COORDINATOR / L3C_NUM_PROCS / L3C_PROC_ID with
  --device cpu (gloo, one rank): its checkpoint equals the single-process
  run's bit for bit, and the process group is gone after it.

The tiny configs of tests/test_fanout.py; the ranks import no test module
and no JAX (their worker is l3c_torch.parallel.mesh.train_steps).
"""
import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from l3c_tpu.config import DlConfig as JDl
from l3c_tpu.models.network import MultiscaleNetwork as JNet
from l3c_tpu.parallel import mesh as jmesh
from l3c_tpu.train import optim as joptim
from l3c_tpu.train import schedule as jsched
from l3c_tpu.train.saver import Restorer as JRestorer
from l3c_tpu.train.trainer import Trainer as JTrainer
from l3c_tpu.train.trainer import make_train_state, make_train_step
from l3c_torch import config as tcfg
from l3c_torch.cli import train as train_cli
from l3c_torch.models.network import MultiscaleNetwork as TNet
from l3c_torch.models.weights import params_to_jax, read_checkpoint
from l3c_torch.parallel import mesh
from l3c_torch.train.trainer import Trainer as TTrainer
from tests.test_torch_port_train import batches, np_tree, tiny_cfgs
from tests.test_torch_port_train_io import TINY_MS, _pngs

torch.set_num_threads(1)
TDL = tcfg.DlConfig(batchsize_train=8, batchsize_val=8, crop_size=16)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    return [(path, np.asarray(tree))]


def test_two_ranks_match_jax_data_parallel_step():
    jc, tc = tiny_cfgs()
    net = JNet(jc)
    opt = joptim.make_optimizer(jc, epoch_len=10)
    lr_fn = jsched.from_spec(jc.lr_schedule, jc.lr_initial, 10)
    first, batch = batches(2, B=8)
    step = make_train_step(jc, net, opt, lr_fn)
    state0, _ = jax.jit(step)(make_train_state(
        jc, net, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), opt),
        jnp.asarray(first))
    jm = jmesh.make_mesh(jax.devices()[:2])
    dp = jmesh.data_parallel_jit(step, jm, donate_state=False)
    s2, m2 = dp(jax.device_put(state0, jmesh.replicated(jm)),
                jmesh.shard_batch(jm, batch.astype(np.float32)))
    want = np_tree(s2["params"])

    res = mesh.spawn(mesh.train_steps, 2, "gloo", ["cpu", "cpu"],
                     (tc, TDL, np_tree(state0), [batch]), timeout=300)
    for r in res:
        assert r["losses"][0] == pytest.approx(float(m2["loss_bpsp"]),
                                               rel=1e-5)
    got = [_leaves(r["params"][0]) for r in res]
    assert [p for p, _ in got[0]] == [p for p, _ in _leaves(want)]
    for (p, a), (_, b), (_, w) in zip(got[0], got[1], _leaves(want)):
        np.testing.assert_array_equal(a, b)       # the ranks' replicas
        np.testing.assert_allclose(a, w, rtol=2e-4, atol=2e-6, err_msg=p)


def test_one_rank_equals_the_plain_trainer_bit_for_bit():
    _, tc = tiny_cfgs()
    tr = TTrainer(tc, TDL, TNet(tc), [], epoch_len=10, device="cpu")
    state = copy.deepcopy(tr.state_tree())
    bs = batches(3, B=8, seed=1)
    losses, params = [], []
    for b in bs:
        losses.append(float(tr.train_step(b)["loss_bpsp"]))
        params.append(_leaves(params_to_jax(
            {k: v.clone() for k, v in tr.net.state_dict().items()})))
    # one rank needs no second process: this one joins a group of one
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{mesh.free_port()}")
    try:
        got = mesh.train_steps(0, 1, torch.device("cpu"), tc, TDL, state, bs)
    finally:
        dist.destroy_process_group()
    assert got["losses"] == losses
    for want, p in zip(params, got["params"]):
        for (pa, a), (pb, b) in zip(_leaves(p), want):
            assert pa == pb
            np.testing.assert_array_equal(a, b, err_msg=pa)


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_cli")
    (root / "ms").mkdir()
    (root / "dl").mkdir()
    (root / "ms" / "tiny.cf").write_text(TINY_MS)
    _pngs(str(root / "train"), [(40, 52), (20, 24), (33, 37), (64, 48)], 1)
    _pngs(str(root / "val"), [(24, 24), (30, 28)], 2)
    (root / "dl" / "tinydl.cf").write_text(
        "batchsize_train = 4\nbatchsize_val = 2\ncrop_size = 16\n"
        f"train_imgs_glob = '{root / 'train'}'\nval_glob = '{root / 'val'}'\n"
        "num_val_batches = 1\n")
    return root


def _argv(root, logs, n):
    return [str(root / "ms" / "tiny.cf"), str(root / "dl" / "tinydl.cf"),
            str(root / logs), "--device", "cpu", "--num_itr", str(n),
            "--log_train", "1", "--log_val", "2", "--keep_tmp_itr", "2"]


def _ckpt(root, logs, itr):
    (log_dir,) = os.listdir(root / logs)
    return os.path.join(root / logs, log_dir), read_checkpoint(os.path.join(
        root / logs, log_dir, "ckpts", f"ckpt_{itr:010d}.ckpt.tmp"))


def test_cli_two_ranks_checkpoint_restored_by_jax(cli_world):
    """Rank 0 alone creates the log dir and saves (at 2 by the interval, at
    3 at the end), rank 1 saves on the same schedule into it; JAX restores
    the last strictly."""
    root = cli_world
    mesh.spawn(train_cli._rank_main, 2, "gloo", ["cpu", "cpu"],
               (_argv(root, "logs2", 3),), timeout=300)
    log_dir, saved = _ckpt(root, "logs2", 3)
    assert sorted(os.listdir(os.path.join(log_dir, "ckpts"))) == [
        "ckpt_0000000002.ckpt.tmp", "ckpt_0000000003.ckpt.tmp"]
    jc, _ = tiny_cfgs(lr_schedule="exp_0.9_i1")
    jtr = JTrainer(jc, JDl(batchsize_train=4, crop_size=16), JNet(jc),
                   iter([]), epoch_len=10)
    itr, got = JRestorer(log_dir).restore(jax.device_get(jtr.state),
                                          strict=True)
    assert itr == 3 and int(got["step"]) == 3
    assert train_cli.main(_argv(root, "logs1", 3)) == 0
    _, single = _ckpt(root, "logs1", 3)
    assert [p for p, _ in _leaves(saved)] == [p for p, _ in _leaves(single)]
    for (p, a), (_, b) in zip(_leaves(np_tree(got)), _leaves(saved)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=p)
        assert np.isfinite(b).all(), p


def test_cli_under_l3c_variables_one_rank(cli_world, monkeypatch, capsys):
    root = cli_world
    monkeypatch.setenv("L3C_COORDINATOR", f"127.0.0.1:{mesh.free_port()}")
    monkeypatch.setenv("L3C_NUM_PROCS", "1")
    monkeypatch.setenv("L3C_PROC_ID", "0")
    assert train_cli.main(_argv(root, "env1", 2)) == 0
    assert not dist.is_initialized()
    assert "VAL bpsp=" in capsys.readouterr().out
    for k in mesh.ENV:
        monkeypatch.delenv(k)
    assert train_cli.main(_argv(root, "plain1", 2)) == 0
    _, ddp = _ckpt(root, "env1", 2)
    _, plain = _ckpt(root, "plain1", 2)
    for (pa, a), (pb, b) in zip(_leaves(ddp), _leaves(plain)):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=pa)


@pytest.mark.parametrize("cf", ["cr.cf", "cr_rgb.cf", "cr_rgb_shared.cf"])
def test_every_parameter_takes_part_in_a_training_forward(cf):
    """Why data_parallel does not search for unused parameters: every
    parameter of the shipped configs (at a narrow width) gets a gradient
    from one training step's loss."""
    import dataclasses
    from l3c_torch import blueprint
    from l3c_torch.cli.l3c import default_config_roots
    cfg = tcfg.load_ms_config(os.path.join(default_config_roots()[0], "ms",
                                           cf))
    cfg = dataclasses.replace(
        cfg, Cf=8, enc=dataclasses.replace(cfg.enc, num_blocks=1),
        dec=dataclasses.replace(cfg.dec, num_blocks=1))
    net = TNet(cfg)
    net.init_weights(torch.Generator().manual_seed(0))
    out = net(torch.from_numpy(batches(1, B=2, crop=32)[0]).float(),
              train=True)
    blueprint.compute_loss(cfg, out).loss_pc.backward()
    unused = [n for n, p in net.named_parameters() if p.grad is None]
    assert not unused and len(list(net.parameters())) > 10
