#!/usr/bin/env python3
"""Fresh training on the card through cli.train from several seeds, with
the mixture loss through K6 or through its plain version: the validation
bpsp before and after, per run.

    python3 train_fresh.py [--seeds 0,1,2] [--steps 40]
        [--nll k6,plain,k6_split]

Each run is chip_smoke.py's fresh run (cli.train.main at full cr.cf width,
oi_offline.cf's batch 16 x 128^2 and schedule, on chip_smoke.train_pngs'
seeded PNGs) with `--seed` set, which draws the initial weights and the
batches. `k6` is the port's path on the card; `plain` routes
models/dmll.nll to nll_plain, so autograd differentiates the plain
version there; `k6_split` is K6 built from a copy of dmll.cu whose sums
over k are split (each lane adds its own components, then the lanes'
partial sums are added), as K6's first design summed: the same terms in
another order, so its results differ from K6's by roundings. It prints a
line per run and, as the last line, a JSON list of {nll, seed, before,
after, losses, k6_launches}. Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

import torch

from chip_smoke import card_line, patched, run_cli, train_pngs
from l3c_torch.cli import l3c as l3c_cli
from l3c_torch.cli import train as train_cli
from l3c_torch.models import dmll
from l3c_torch.ops import kernels
from l3c_torch.ops.kernels import build
from l3c_torch.train.trainer import Trainer
from profile_k6 import nvcc, using

SUM_HEAD = "__device__ __forceinline__ float ordered_sum("
SPLIT_SUM = SUM_HEAD + """const float (&v)[kSlots], int K,
                                             int s) {
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    if (s + kSplit * j < K) sum = sum + v[j];
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1)
    sum = sum + __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}
"""


def split_sum_library(tmp: str):
    """dmll.cu with SPLIT_SUM in place of ordered_sum, built and bound."""
    src = open(os.path.join(build.CSRC, "dmll.cu")).read()
    start = src.index(SUM_HEAD)
    end = src.index("\n}\n", start) + 3
    path, so = os.path.join(tmp, "dmll_split.cu"), os.path.join(
        tmp, "libdmll_split.so")
    open(path, "w").write(src[:start] + SPLIT_SUM + src[end:])
    nvcc(path, so)
    return build._bind("dmll", so)


def fresh_run(nll: str, seed: int, steps: int, out_dir: str, data,
              split_lib=None):
    """Validation bpsp before and after `steps` steps, the train losses,
    the K6 launches; `k6_split` launches split_lib's kernels."""
    root = l3c_cli.default_config_roots()[0]
    vals, losses = {}, []

    def train(orig):
        def run(self, *a, **k):
            vals["before"] = self.validation_loop()
            got = orig(self, *a, **k)
            vals["after"] = self.validation_loop()
            return got
        return run

    def step(orig):
        def run(self, batch):
            m = orig(self, batch)
            losses.append(float(m["loss_bpsp"]))
            return m
        return run

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(Trainer, "train", train))
        stack.enter_context(patched(Trainer, "train_step", step))
        if nll == "plain":
            stack.enter_context(patched(dmll, "nll",
                                        lambda orig: dmll.nll_plain))
        if nll == "k6_split":
            stack.enter_context(using(split_lib))
        kernels.reset_launches()
        run_cli(train_cli.main, [
            os.path.join(root, "ms", "cr.cf"),
            os.path.join(root, "dl", "oi_offline.cf"), out_dir, *data,
            "--seed", str(seed), "--num_itr", str(steps), "--log_train",
            "10", "--log_val", "0"])
    return dict(nll=nll, seed=seed, before=vals["before"],
                after=vals["after"], losses=losses,
                k6_launches=sum(v for k, v in kernels.launches.items()
                                if k.startswith("dmll")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--nll", default="k6,plain")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_fresh: no CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    results = []
    with tempfile.TemporaryDirectory(prefix="l3c_fresh_") as d:
        train_dir, val_dir = train_pngs(d)
        data = ["-p", f"dl.train_imgs_glob='{train_dir}'", "-p",
                f"dl.val_glob='{val_dir}'", "-p", "dl.image_cache_pkl=None"]
        nlls = args.nll.split(",")
        split_lib = split_sum_library(d) if "k6_split" in nlls else None
        for nll in nlls:
            for seed in map(int, args.seeds.split(",")):
                r = fresh_run(nll, seed, args.steps,
                              os.path.join(d, f"{nll}_{seed}"), data,
                              split_lib)
                results.append(r)
                print(f"{nll} seed {seed}: validation bpsp {r['before']:.4f}"
                      f" -> {r['after']:.4f}; train loss "
                      f"{[round(v, 3) for v in r['losses'][::5]]} (every "
                      f"5th); K6 launches {r['k6_launches']}", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
