"""Convert a released reference PyTorch checkpoint into a log dir.

Port of `l3c_tpu/cli/convert.py`:
    python -m l3c_torch.cli.convert CKPT.pt MS_CONFIG OUT_LOG_DIR_ROOT \
        [--dl_config_p DL_CONFIG] [--postfix imported]

Writes a log dir named so cli.test / cli.l3c restore from it, holding the
imported parameters as one persistent checkpoint {'params', 'opt_state',
'step'} in the JAX package's file format (train/saver.py), e.g.:

    python -m l3c_torch.cli.convert ckpt_0500000.pt \
        l3c_torch/configs/ms/cr.cf logs
    python -m l3c_torch.cli.test logs <printed date> /data/val500
Touches no device.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ckpt_pt")
    p.add_argument("ms_config_p")
    p.add_argument("log_dir_root")
    p.add_argument("--dl_config_p", default=None,
                   help="dl config to include in the log dir name "
                        "(cosmetic; defaults to dl/oi.cf beside the ms "
                        "config's directory)")
    p.add_argument("--postfix", default="imported")
    flags = p.parse_args(argv)

    from ..config import load_ms_config
    from ..convert.torch_import import load_torch_checkpoint
    from ..train.saver import Saver
    from ..utils import logdir as logdir_mod

    cfg = load_ms_config(flags.ms_config_p)
    itr, variables = load_torch_checkpoint(flags.ckpt_pt, cfg)
    itr = max(itr, 1)
    dl_p = flags.dl_config_p or os.path.join(
        os.path.dirname(flags.ms_config_p), "..", "dl", "oi.cf")
    log_dir = logdir_mod.create_unique_log_dir(
        flags.log_dir_root, [flags.ms_config_p, dl_p],
        postfix=[flags.postfix])
    # the flax variables under 'params', as the trainer's checkpoints; an
    # empty optimizer state, which flax serialises as an empty map
    Saver(log_dir, keep_tmp_itr=1, keep_every=1).save(
        {"params": variables, "opt_state": {}, "step": itr}, itr)
    print(f"imported {flags.ckpt_pt} (itr {itr}) -> {log_dir}")
    print(f"log date: {logdir_mod.log_date_from_log_dir(log_dir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
