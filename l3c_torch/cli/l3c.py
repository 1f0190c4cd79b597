"""Practical codec CLI: encode/decode a single image.

Port of `l3c_tpu/cli/l3c.py`:
    python -m l3c_torch.cli.l3c LOG_DIR_ROOT LOG_DATE enc IMG.png OUT.l3c
    python -m l3c_torch.cli.l3c LOG_DIR_ROOT LOG_DATE dec IN.l3c OUT.png
`--codec_backend host` encodes format v1 (rANS on the host); dec decodes
either format, chosen by the file's version byte.
Runs on the first CUDA card and raises when there is none; `--device cpu`
runs the plain versions on the CPU. Images are 8-bit PNGs (data/images).
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def default_config_roots():
    return [os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "configs")]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("log_dir_root")
    p.add_argument("log_date")
    p.add_argument("mode", choices=["enc", "dec"])
    p.add_argument("inp")
    p.add_argument("out")
    p.add_argument("--restore_itr", type=int, default=-1)
    p.add_argument("--overwrite", "-f", action="store_true")
    p.add_argument("--config_roots", default=None)
    p.add_argument("--codec_backend", default="auto",
                   choices=["auto", "host"],
                   help="entropy backend of enc: 'auto' (format v8, "
                        "rANS on the card) or 'host' (format v1, rANS on "
                        "the host); dec reads the format from the file")
    p.add_argument("--device", default=None,
                   help="torch device; default: the first CUDA card "
                        "(an error without one). 'cpu' on request")
    flags = p.parse_args(argv)

    from ..eval.tester import MultiscaleTester
    from ..utils import logdir as logdir_mod

    config_roots = (flags.config_roots.split(":") if flags.config_roots
                    else default_config_roots())
    log_dir = logdir_mod.find_log_dir(flags.log_dir_root, flags.log_date)
    tester = MultiscaleTester.from_log_dir(
        log_dir, config_roots, restore_itr=flags.restore_itr,
        use_cache=False, codec_backend=flags.codec_backend,
        device=flags.device)
    if flags.overwrite and os.path.exists(flags.out):
        os.remove(flags.out)

    t0 = time.time()
    if flags.mode == "enc":
        bpsp = tester.encode_file(flags.inp, flags.out)
        print(f"encoded {flags.inp} -> {flags.out}: {bpsp:.4f} bpsp "
              f"({time.time() - t0:.2f}s)")
    else:
        tester.decode_file(flags.inp, flags.out)
        print(f"decoded {flags.inp} -> {flags.out} "
              f"({time.time() - t0:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
