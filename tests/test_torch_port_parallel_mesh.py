"""l3c_torch/parallel/mesh.py against l3c_tpu/parallel/mesh.py, on the CPU.

- maybe_init_distributed: the three cases of JAX's tests/test_fanout.py
  (a no-op without the L3C_* variables, the exact arguments with them, a
  KeyError without the count), with init_process_group monkeypatched;
- shard_batch: rank r's rows are exactly the rows that the JAX package's
  shard_batch (NamedSharding(P('data'))) places on device r of 2 and 4
  devices of the conftest mesh; a batch that does not split raises;
- the device slots: backends by device kind, mixed kinds refused;
- spawn: a rank that raises makes spawn raise with its traceback (gloo
  ranks started by the spawn method).
"""
import numpy as np
import jax
import pytest
import torch
import torch.distributed as dist

from l3c_tpu.parallel import mesh as jmesh
from l3c_torch.parallel import mesh

torch.set_num_threads(1)


def test_maybe_init_distributed_noop_when_unset(monkeypatch):
    """No env vars -> returns False and never touches torch.distributed."""
    for k in mesh.ENV:
        monkeypatch.delenv(k, raising=False)
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: called.append(kw))
    assert mesh.maybe_init_distributed("cpu") is False
    assert called == []


def test_maybe_init_distributed_calls_init_process_group(monkeypatch):
    """The coordinator, count and rank go to init_process_group exactly,
    with the CPU's backend (gloo)."""
    monkeypatch.setenv("L3C_COORDINATOR", "10.0.0.7:8476")
    monkeypatch.setenv("L3C_NUM_PROCS", "4")
    monkeypatch.setenv("L3C_PROC_ID", "2")
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: called.append(kw))
    assert mesh.maybe_init_distributed("cpu") is True
    assert called == [{"backend": "gloo",
                       "init_method": "tcp://10.0.0.7:8476",
                       "world_size": 4, "rank": 2}]


def test_maybe_init_distributed_missing_count_raises(monkeypatch):
    """A coordinator with no process count is a config error, not a
    silent single-process run."""
    monkeypatch.setenv("L3C_COORDINATOR", "10.0.0.7:8476")
    monkeypatch.delenv("L3C_NUM_PROCS", raising=False)
    monkeypatch.setenv("L3C_PROC_ID", "0")
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: None)
    with pytest.raises(KeyError):
        mesh.maybe_init_distributed("cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_shard_batch_rows_are_jax_device_rows(n):
    batch = np.arange(8 * 4 * 4 * 3, dtype=np.float32).reshape(8, 4, 4, 3)
    devices = jax.devices()[:n]
    arr = jmesh.shard_batch(jmesh.make_mesh(devices), batch)
    seen = 0
    for shard in arr.addressable_shards:
        r = devices.index(shard.device)
        np.testing.assert_array_equal(mesh.shard_batch(batch, r, n),
                                      np.asarray(shard.data))
        seen += 1
    assert seen == n
    t = torch.from_numpy(batch)
    assert torch.equal(mesh.shard_batch(t, n - 1, n),
                       torch.from_numpy(mesh.shard_batch(batch, n - 1, n)))


def test_shard_batch_that_does_not_split_raises():
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(np.zeros((6, 2, 2, 3)), 0, 4)


def test_backends_and_slots():
    """nccl for CUDA, gloo for the CPU, nothing else; slots of one kind."""
    assert mesh.backend_for("cuda:0") == "nccl"
    assert mesh.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError, match="backend"):
        mesh.backend_for("meta")
    assert mesh.local_devices("cpu") == [torch.device("cpu")]
    assert mesh.check_slots(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="mix kinds"):
        mesh.check_slots(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="no device slots"):
        mesh.check_slots([])
    with pytest.raises(ValueError, match="2 devices for 3 ranks"):
        mesh.spawn(mesh.train_steps, 3, "gloo", ["cpu", "cpu"])


def test_spawn_raises_what_a_rank_raised():
    """A batch of 3 rows over 2 ranks: each rank's shard_batch raises, and
    spawn raises with the rank's error in its message."""
    from l3c_torch.config import (DecConfig, DlConfig, EncConfig, MsConfig,
                                  ProbConfig, QConfig)
    cfg = MsConfig(num_scales=2, Cf=8, enc=EncConfig(num_blocks=1),
                   dec=DecConfig(num_blocks=1), q=QConfig(C=2, L=25),
                   prob=ProbConfig(K=2))
    from l3c_torch.models.network import MultiscaleNetwork
    from l3c_torch.train.trainer import Trainer
    tr = Trainer(cfg, DlConfig(crop_size=16), MultiscaleNetwork(cfg), [],
                 epoch_len=10, device="cpu")
    with pytest.raises(Exception, match="does not split over 2 ranks"):
        mesh.spawn(mesh.train_steps, 2, "gloo", ["cpu", "cpu"],
                   (cfg, DlConfig(crop_size=16), tr.state_tree(),
                    [np.zeros((3, 16, 16, 3), np.uint8)]), timeout=120)
