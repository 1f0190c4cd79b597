"""Process groups, device slots and data-parallel training (DDP).

Port of `l3c_tpu/parallel/mesh.py`. The JAX package's unit is one process
a host: `jax.distributed` joins the hosts and one jitted step runs over a
`Mesh` of every chip, batch sharded, parameters replicated, the gradient
psum inserted by XLA. The port's unit is one process a card: DDP drives
one device a process, and NCCL refuses two ranks on one card ("Duplicate
GPU detected"). So `maybe_init_distributed` makes this process one rank
of a `torch.distributed` process group, `data_parallel` wraps the network
in DDP (the gradient allreduce), and every rank takes its rows of the same
global batch (`shard_batch`), the rows `NamedSharding(P('data'))` puts on
device r.

The paths that need no gradient collective (the codec fan-out, sharded
eval, spatial sharding) stay in one process, as in JAX, over a list of
device slots (`local_devices`); two slots may name one card.
"""
from __future__ import annotations

import contextlib
import copy
import os
import socket
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve

ENV = ("L3C_COORDINATOR", "L3C_NUM_PROCS", "L3C_PROC_ID")
# the process group's backend for a device kind: explicit, and an NCCL
# that fails raises (no fallback to gloo)
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device: DeviceLike) -> str:
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {kind!r}")
    return BACKENDS[kind]


def maybe_init_distributed(device: DeviceLike = None) -> bool:
    """Make this process one rank of a process group, from the environment.

    Set L3C_COORDINATOR=host:port (rank 0's address), L3C_NUM_PROCS (the
    number of ranks) and L3C_PROC_ID (this rank) in every process: one
    process a card, where the JAX package starts one a host. The backend is
    nccl for a CUDA device and gloo for the CPU; on CUDA the rank takes card
    L3C_PROC_ID % the host's card count (ranks numbered host by host). A
    no-op returning False when L3C_COORDINATOR is unset; a coordinator
    without the count or the rank raises KeyError."""
    addr = os.environ.get(ENV[0])
    if not addr:
        return False
    world = int(os.environ[ENV[1]])
    rank = int(os.environ[ENV[2]])
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend=backend_for(dev),
                            init_method=f"tcp://{addr}", world_size=world,
                            rank=rank)
    return True


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """The device slots of one process: every card for CUDA, [cpu] for the
    CPU (`make_mesh`'s device list)."""
    dev = resolve(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def check_slots(devices: Sequence[DeviceLike]) -> List[torch.device]:
    """devices as torch.devices; raises ValueError when they are none or
    mix device kinds (v8 files do not cross between device kinds)."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("no device slots")
    kinds = {d.type for d in devs}
    if len(kinds) > 1:
        raise ValueError(f"device slots mix kinds {sorted(kinds)}: files "
                         "do not cross between device kinds")
    return devs


def on(device: torch.device):
    """The context that makes `device` current: the kernels launch on the
    current card's stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replicas(net: torch.nn.Module, devices: Sequence[torch.device]
             ) -> List[torch.nn.Module]:
    """One network a slot: `net` moved to the first slot's device, a copy
    for each other device; slots on one device share one module."""
    by_dev = {}
    out = []
    for d in devices:
        if d not in by_dev:
            by_dev[d] = (net.to(d) if not by_dev
                         else copy.deepcopy(net).to(d)).eval()
        out.append(by_dev[d])
    return out


def shard_batch(batch, rank: int, world: int):
    """Rank `rank`'s rows of a global batch of `world` equal shards (numpy
    array or tensor, rows on axis 0)."""
    B = batch.shape[0]
    if B % world:
        raise ValueError(f"batch of {B} does not split over {world} ranks")
    n = B // world
    return batch[rank * n: (rank + 1) * n]


def data_parallel(module: torch.nn.Module, device: DeviceLike
                  ) -> torch.nn.parallel.DistributedDataParallel:
    """`module` (on `device`) under DDP over the default process group:
    construction broadcasts rank 0's parameters, every backward averages
    the gradients over the ranks. Every parameter of cr.cf, cr_rgb and
    cr_rgb_shared takes part in a training forward, so unused parameters
    are not searched for; the only buffers are the quantizers' constant
    levels, so none are broadcast."""
    dev = torch.device(device)
    ids = None
    if dev.type == "cuda":
        ids = [dev.index if dev.index is not None
               else torch.cuda.current_device()]
    return torch.nn.parallel.DistributedDataParallel(
        module, device_ids=ids, broadcast_buffers=False)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank, fn, world, backend, devices, port, threads, queue, args):
    torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        queue.put((rank, fn(rank, world, device, *args)))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str,
          devices: Sequence[DeviceLike], args: tuple = (),
          timeout: Optional[float] = None) -> List[Any]:
    """Run fn(rank, world, device, *args) in `world` processes started by
    the spawn method (never fork: a parent with threads can deadlock a
    forked child), each a rank of a process group over localhost with
    `backend` on devices[rank] (its current device), with this process's
    intra-op thread count (CPU sums are ordered by it). fn is pickled by
    its import path. Returns the ranks' results in rank order. A rank that
    raises makes spawn raise with its traceback, after the others are
    stopped; past `timeout` seconds every rank is stopped and spawn raises
    TimeoutError."""
    import time

    import torch.multiprocessing as mp
    devs = [str(torch.device(d)) for d in devices]
    if len(devs) != world:
        raise ValueError(f"{len(devs)} devices for {world} ranks")
    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _rank, args=(fn, world, backend, devs, free_port(),
                     torch.get_num_threads(), queue, args),
        nprocs=world, join=False, start_method="spawn")
    results = {}
    deadline = None if timeout is None else time.monotonic() + timeout

    def drain():          # before joining: a rank may block writing
        while not queue.empty():
            r, out = queue.get()
            results[r] = out

    try:
        while not ctx.join(timeout=0.2):
            drain()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    drain()
    return [results[r] for r in range(world)]


def train_steps(rank: int, world: int, device: torch.device, cfg, dl_cfg,
                state: dict, batches: Sequence, epoch_len: int = 10
                ) -> dict:
    """Rank worker of a data-parallel run: a Trainer over the process group
    from `state` (a train-state tree, {'params', 'opt_state', 'step'}),
    one step per global batch of `batches`. Returns {'losses': the global
    loss_bpsp of each step, 'params': the parameter tree (numpy) after each
    step, 'ms': each step's milliseconds (host clock, ending when its loss
    is read), 'launches': the kernel launches of the steps}."""
    import time

    from ..device import numerics_guard
    from ..models.network import MultiscaleNetwork
    from ..models.weights import params_to_jax
    from ..ops import kernels
    from ..train.trainer import Trainer
    numerics_guard()
    tr = Trainer(cfg, dl_cfg, MultiscaleNetwork(cfg), [],
                 epoch_len=epoch_len, device=device, world=world)
    tr.load_state_tree(state)
    losses, params, ms = [], [], []
    kernels.reset_launches()
    for b in batches:
        t0 = time.perf_counter()
        m = tr.global_metrics(tr.train_step(b))
        losses.append(float(m["loss_bpsp"]))      # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        params.append(params_to_jax({k: v.clone() for k, v in
                                     tr.net.state_dict().items()}))
    return {"losses": losses, "params": params, "ms": ms,
            "launches": dict(kernels.launches)}
