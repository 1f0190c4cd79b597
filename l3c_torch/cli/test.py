"""Evaluation CLI.

Port of `l3c_tpu/cli/test.py`:
    python -m l3c_torch.cli.test LOG_DIR_ROOT LOG_DATES IMG_DIRS \
        [--names ...] [--restore_itr ...] [--write_to_files OUT]
        [--sample OUT] [--max_imgs_per_folder N] [--recursive N|auto]
        [--time_report PATH] [--compare_theory] [--sort_output ...]
        [--spatial_shard] [--fanout] [--device cpu]
Runs on the first CUDA card and raises when there is none; `--device cpu`
runs the plain versions on the CPU. --codec_backend host codes format v1
(rANS on the host). --spatial_shard and --fanout use every card of the
host (parallel/); on one card they take the single-device paths.
"""
from __future__ import annotations

import argparse
import os
import sys

from .l3c import default_config_roots


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("log_dir_root")
    p.add_argument("log_dates", help="comma-separated MMDD_HHMM prefixes")
    p.add_argument("img_dirs", help="comma-separated image dirs/globs")
    p.add_argument("--names", default=None,
                   help="comma-separated display names for img_dirs")
    p.add_argument("--restore_itr", default="-1",
                   help="comma-separated iterations to evaluate")
    p.add_argument("--match_filenames", "-fns", nargs="+",
                   metavar="FILTER", default=None,
                   help="keep only images whose (extension-less) "
                        "filename is listed")
    p.add_argument("--crop", type=int, default=None,
                   help="center-crop all images to CROP x CROP")
    p.add_argument("--max_imgs_per_folder", type=int, default=None)
    p.add_argument("--write_to_files", metavar="OUT_DIR", default=None,
                   help="real encode+decode round-trip per image")
    p.add_argument("--sample", metavar="OUT_DIR", default=None)
    p.add_argument("--recursive", default="0",
                   help="'auto' or an int; extra recursions (RGB Shared)")
    p.add_argument("--time_report", default=None)
    p.add_argument("--compare_theory", action="store_true")
    p.add_argument("--sort_output", "-s",
                   choices=["testset", "exp", "itr", "res"],
                   default="testset",
                   help="sort the summary by testset name, experiment, "
                        "iteration, or result")
    p.add_argument("--reset_cache", action="store_true")
    p.add_argument("--spatial_shard", action="store_true",
                   help="evaluate above-auto-crop-threshold images by "
                        "height-sharding over the device mesh (ICI halo "
                        "exchange) instead of independent auto-crop "
                        "tiles; needs >1 device")
    p.add_argument("--config_roots", default=None,
                   help="colon-separated roots to resolve .cf names")
    p.add_argument("--codec_backend", default="auto",
                   choices=["auto", "host"],
                   help="entropy backend for --write_to_files: 'auto' "
                        "(format v8, rANS on the card) or 'host' (format "
                        "v1, rANS on the host)")
    p.add_argument("--fanout", action="store_true",
                   help="--write_to_files: round-robin same-shape image "
                        "groups across all mesh devices (one codec "
                        "instance per chip; degenerates to the single-"
                        "device batched path on one chip)")
    p.add_argument("--eval_batch", type=int, default=8,
                   help="--write_to_files: images per batched codec "
                        "group (same-shape images are coded together)")
    p.add_argument("--device", default=None,
                   help="torch device; default: the first CUDA card "
                        "(an error without one). 'cpu' on request")
    flags = p.parse_args(argv)

    from ..data.images import Testset
    from ..eval.tester import MultiscaleTester
    from ..utils import logdir as logdir_mod
    from ..utils.printer import AlignedPrinter

    config_roots = (flags.config_roots.split(":") if flags.config_roots
                    else default_config_roots())

    names = flags.names.split(",") if flags.names else None
    testsets = []
    for i, d in enumerate(flags.img_dirs.split(",")):
        ts = Testset(d, max_imgs=flags.max_imgs_per_folder,
                     name=names[i] if names else None,
                     append_id=(f"_crop{flags.crop}" if flags.crop
                                else None))
        if flags.match_filenames:
            ts.filter_filenames(flags.match_filenames)
        testsets.append(ts)

    table = AlignedPrinter()
    table.append("log_dir", "itr", "testset", "bpsp")
    rows = []
    for log_date in flags.log_dates.split(","):
        log_dir = logdir_mod.find_log_dir(flags.log_dir_root, log_date)
        for itr_s in flags.restore_itr.split(","):
            tester = MultiscaleTester.from_log_dir(
                log_dir, config_roots, restore_itr=int(itr_s),
                use_cache=not flags.reset_cache,
                recursive=flags.recursive,
                codec_backend=flags.codec_backend, crop=flags.crop,
                spatial_shard=flags.spatial_shard, device=flags.device)
            for ts in testsets:
                if flags.write_to_files:
                    res = tester.write_to_files(
                        ts, flags.write_to_files,
                        time_report=flags.time_report,
                        compare_theory=flags.compare_theory,
                        group=flags.eval_batch, fanout=flags.fanout)
                else:
                    res = tester.test(ts)
                rows.append((os.path.basename(log_dir),
                             str(tester.restore_itr), ts.id,
                             f"{res.mean_bpsp():.4f}"))
                if flags.sample:
                    tester.sample(ts, flags.sample)
    col = {"exp": 0, "itr": 1, "testset": 2, "res": 3}[flags.sort_output]
    if flags.sort_output == "itr":
        rows.sort(key=lambda r: int(r[col]))  # numeric: '9' < '10'
    else:
        rows.sort(key=lambda r: r[col])
    for r in rows:
        table.append(*r)
    table.print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
