#!/usr/bin/env python3
"""Time the loader's AVIF decoding (l3c_torch/data/avif.py, av1_*.py,
avif_yuv.py) on this host against another tree's, in one run.

    python3 profile_avif.py --baseline OTHER_TREE [--rounds 4] [--decodes 3]

OTHER_TREE is the root of another checkout (e.g. an earlier commit
unpacked beside this one). Each round decodes the 8-bit files below
(chip_smoke's phase avif's coded 512 x 512 saves and lossless file, two
filtered fixtures), each --decodes times in a fresh process per tree,
and keeps the fastest; the trees take turns in the order this, baseline,
baseline, this, ... It checks both trees give the same pixels, and
prints each decode rate (MP/s) by round, the median by tree and this
tree's median over the baseline's, with the host CPU. The 10-bit 512 x
512 default save (fixtures/avif_deep) is timed on this tree only: an
earlier tree may refuse it.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures")
FILES = ("avif/x_coded_default_512_420.avif",
         "avif/w_coded_grain_512_420.avif",
         "avif/y_coded_lossy_512_420.avif",
         "avif/z_coded_lossless_444.avif", "avif/o_cdef_422.avif",
         "avif/p_lr_q60_switchable.avif")
DEEP = ("avif_deep/x_coded_default_512_420_10.avif",)

CHILD = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
from l3c_torch.data import avif
out = {}
for name in json.loads(sys.argv[2]):
    blob = open(name, "rb").read()
    best = float("inf")
    for _ in range(int(sys.argv[3])):
        t0 = time.perf_counter()
        px = avif.decode_avif(blob, name)
        best = min(best, time.perf_counter() - t0)
    out[name] = (px.shape[0] * px.shape[1] / best / 1e6,
                 hashlib.sha256(px.tobytes()).hexdigest())
print(json.dumps(out))
"""


def decode_rates(tree: str, files: list, decodes: int) -> dict:
    run = subprocess.run([sys.executable, "-c", CHILD, tree,
                          json.dumps(files), str(decodes)],
                         capture_output=True, text=True, check=True)
    return json.loads(run.stdout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="root of another tree to time against")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--decodes", type=int, default=3)
    args = ap.parse_args(argv)
    both = [os.path.join(FIXTURES, f) for f in FILES]
    mine = [os.path.join(FIXTURES, f) for f in DEEP]
    rates = {"this": [], "baseline": []}
    for r in range(args.rounds):
        order = ("this", "baseline") if r % 2 == 0 else ("baseline", "this")
        for side in order:
            tree = ROOT if side == "this" else os.path.abspath(args.baseline)
            got = decode_rates(tree, both + (mine if side == "this" else []),
                               args.decodes)
            rates[side].append(got)
            print(f"round {r} {side}: " + "; ".join(
                f"{os.path.basename(k)} {v[0]:.4f} MP/s"
                for k, v in got.items()), flush=True)
    for k in rates["baseline"][0]:
        digests = {g[k][1] for side in rates.values() for g in side}
        if len(digests) != 1:
            print(f"{k}: the trees' pixels differ", file=sys.stderr)
            return 1
    from chip_smoke import host_cpu     # cpuid where /proc hides it
    print(f"host {host_cpu()}; fastest of {args.decodes} decodes a round, "
          f"median over {args.rounds} rounds:")
    for k in rates["this"][0]:
        this = statistics.median(g[k][0] for g in rates["this"])
        line = f"  {os.path.basename(k)}: this {this:.4f} MP/s"
        if k in rates["baseline"][0]:
            base = statistics.median(g[k][0] for g in rates["baseline"])
            line += f", baseline {base:.4f}, ratio {this / base:.4f}"
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
