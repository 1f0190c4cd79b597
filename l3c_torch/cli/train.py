"""Training CLI.

Port of `l3c_tpu/cli/train.py`:
    python -m l3c_torch.cli.train MS_CONFIG DL_CONFIG LOG_DIR_ROOT \
        [-p key=value ...] [--restore DATE ...] [--num_itr N] [--debug]
        [--log_train_heavy N] [--device cpu]
The same flags and behaviour; the checkpoints are the JAX package's
format, and each package restores the other's. Runs on the first CUDA
card and raises when there is none; `--device cpu` runs the plain
versions on the CPU.

Data-parallel (DDP, one process a card; parallel/mesh.py): with
L3C_COORDINATOR=host:port, L3C_NUM_PROCS and L3C_PROC_ID set, this
process is that rank (nccl on CUDA, gloo with --device cpu); without them
and with more than one card, it starts one rank a card on localhost.
Rank 0 creates the log dir, saves and logs.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ms_config_p")
    p.add_argument("dl_config_p")
    p.add_argument("log_dir_root")
    p.add_argument("--postfix", default=None)
    p.add_argument("-p", "--params", action="append", default=[],
                   help="override config: -p key=value")
    p.add_argument("--restore", metavar="LOG_DATE", default=None,
                   help="restore a previous experiment for training")
    p.add_argument("--restore_continue", action="store_true",
                   help="continue in the restored log dir")
    p.add_argument("--restore_restart", action="store_true",
                   help="restart at itr 0, skip optimizer state")
    p.add_argument("--restore_itr", type=int, default=-1)
    p.add_argument("--restore_strict", type=str, default="1",
                   choices=("0", "1"),
                   help="0 = partial restore: adopt matching subtrees, "
                        "keep fresh init elsewhere")
    p.add_argument("--num_itr", type=int, default=None,
                   help="iterations to train (default: until killed)")
    p.add_argument("--log_train", type=int, default=100)
    p.add_argument("--log_val", type=int, default=500)
    p.add_argument("--log_train_heavy", type=int, default=0,
                   help="heavy summaries (images, histograms, figures) "
                        "every N steps; 0 = off")
    p.add_argument("--keep_tmp_itr", type=int, default=250)
    p.add_argument("--keep_every", type=int, default=10)
    p.add_argument("--keep_tmp_last", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug", action="store_true",
                   help="one train step + one val pass, then exit")
    p.add_argument("--device", default=None,
                   help="torch device; default: the first CUDA card "
                        "(an error without one). 'cpu' on request")
    argv = sys.argv[1:] if argv is None else list(argv)
    flags = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..parallel import mesh

    joined = mesh.maybe_init_distributed(flags.device)
    if (not dist.is_initialized() and flags.device is None
            and torch.cuda.device_count() > 1):
        n = torch.cuda.device_count()     # rank 0 says so
        mesh.spawn(_rank_main, n, "nccl",
                   [torch.device("cuda", i) for i in range(n)], (argv,))
        return 0
    try:
        return _train(flags)
    finally:
        if joined:
            dist.destroy_process_group()


def _rank_main(rank, world, device, argv):
    """One rank of a data-parallel run that `mesh.spawn` started."""
    if main(argv):
        raise RuntimeError(f"rank {rank} of {world} failed")


def _train(flags) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from .. import config as config_mod
    from ..data.images import ImagesCached, TrainBatches, load_image_uint8
    from ..device import numerics_guard, resolve
    from ..models.network import MultiscaleNetwork
    from ..train.saver import Restorer, Saver
    from ..train.trainer import Trainer
    from ..utils import logdir as logdir_mod
    from ..utils.summarizer import SafeWriter

    overrides = config_mod.parse_overrides(flags.params)
    ms_over = {k: v for k, v in overrides.items()
               if not k.startswith("dl.")}
    dl_over = {k[3:]: v for k, v in overrides.items()
               if k.startswith("dl.")}
    cfg = config_mod.load_ms_config(flags.ms_config_p, ms_over)
    dl = config_mod.load_dl_config(flags.dl_config_p, dl_over)
    device = resolve(flags.device)
    numerics_guard()      # float32 convolutions (no TF32), deterministic
    world = dist.get_world_size() if dist.is_initialized() else None
    rank = dist.get_rank() if world else 0
    if world and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    print_ = print if rank == 0 else (lambda *a, **k: None)
    if world and world > 1:
        print_(f"data-parallel over {world} devices")

    train_paths = ImagesCached(dl.train_imgs_glob,
                               dl.image_cache_pkl).paths()
    val_paths = ImagesCached(dl.val_glob, dl.image_cache_pkl,
                             dl.val_glob_min_size).paths()
    print_(f"{len(train_paths)} train / {len(val_paths)} val images")
    if dl.real_oversample > 1:
        real = [q for q in train_paths
                if not os.path.basename(q).startswith("x_synth")]
        train_paths = train_paths + real * (dl.real_oversample - 1)
        print_(f"real_oversample={dl.real_oversample}: {len(real)} real "
              f"tiles -> {len(train_paths)} sampled paths "
              f"({len(real) * dl.real_oversample / len(train_paths):.0%}"
              " real)")

    batches = TrainBatches(train_paths, dl.batchsize_train, dl.crop_size,
                           seed=flags.seed, aug_strong=dl.aug_strong)
    try:
        val_gen = TrainBatches(val_paths, dl.batchsize_val, dl.crop_size,
                               seed=flags.seed + 1)
        val_it = iter(val_gen)
        val_batches = [next(val_it) for _ in range(dl.num_val_batches)]
        val_gen.close()

        # a fixed first validation image (center crop) keeps the
        # summaries comparable across runs
        fixed = dl.val_fixed_first
        if fixed is None:
            for cand_dir in {os.path.dirname(q) for q in val_paths[:1]}:
                for ext in ("jpg", "png"):
                    cand = os.path.join(cand_dir, f"fixedimg.{ext}")
                    if os.path.isfile(cand):
                        fixed = cand
        if fixed and val_batches:
            im = load_image_uint8(fixed)
            ch, cw = val_batches[0].shape[1:3]
            t = max(0, (im.shape[0] - ch) // 2)
            l = max(0, (im.shape[1] - cw) // 2)
            crop = im[t: t + ch, l: l + cw]
            if crop.shape[:2] == (ch, cw):
                val_batches[0] = val_batches[0].copy()
                val_batches[0][0] = crop
                print_(f"pinned fixed first val image: {fixed}")

        restore_dir = None
        if flags.restore:
            restore_dir = logdir_mod.find_log_dir(flags.log_dir_root,
                                                  flags.restore)
        if flags.restore_continue and restore_dir:
            log_dir = restore_dir
        elif rank == 0:
            log_dir = logdir_mod.create_unique_log_dir(
                flags.log_dir_root, [flags.ms_config_p, flags.dl_config_p],
                postfix=[flags.postfix] if flags.postfix else None,
                restore_dir=restore_dir)
        if world:      # every rank saves on rank 0's schedule into its dir
            shared = [log_dir if rank == 0 else None]
            dist.broadcast_object_list(shared, src=0)
            log_dir = shared[0]
        print_(f"log dir: {log_dir}")

        # rank 0 writes the summaries; SafeWriter no-ops without tensorboard
        sw = SafeWriter(log_dir) if rank == 0 else None
        trainer = Trainer(cfg, dl, MultiscaleNetwork(cfg), batches,
                          val_batches=val_batches, epoch_len=batches.epoch_len,
                          seed=flags.seed, summary_writer=sw, device=device,
                          world=world)
        trainer.saver = Saver(log_dir, flags.keep_tmp_itr, flags.keep_every,
                              flags.keep_tmp_last)

        if restore_dir:
            got = trainer.restore(Restorer(restore_dir), flags.restore_itr,
                                  restart=flags.restore_restart,
                                  strict=flags.restore_strict == "1")
            print_(f"restored itr {got} from {restore_dir}")

        if flags.debug:
            m = trainer.global_metrics(trainer.debug_step())
            print_({k: float(np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                             .reshape(-1)[0]) for k, v in m.items()})
            return 0

        num_itr = flags.num_itr if flags.num_itr is not None else 10 ** 9
        try:
            trainer.train(num_itr, log_every=flags.log_train,
                          val_every=flags.log_val,
                          heavy_every=flags.log_train_heavy)
        except KeyboardInterrupt:
            print_("interrupted; saving final checkpoint")
            if rank == 0:
                trainer.saver.save(trainer.state_tree(), trainer.step)
        if sw is not None:
            sw.close()
    finally:
        batches.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
