#!/usr/bin/env python3
"""Time the loader's JPEG decoding (l3c_torch/data/jpeg.py) on this host
against another tree's, on the 1024 x 768 rate fixtures, in one run.

    python3 profile_jpeg.py --baseline OTHER_TREE [--rounds 4] [--decodes 3]

OTHER_TREE is the root of another checkout (e.g. an earlier commit
unpacked beside this one). Each round decodes the clean baseline
(l3c_torch/data/fixtures/rate/p_1024x768_q90.jpg) and progressive
(fixtures/formats_rate/r_prog_1024x768_q90.jpg) files, each --decodes
times in a fresh process per tree, and keeps the fastest; the trees take
turns in the order this, baseline, baseline, this, ... It checks both
trees give the same pixels, and prints each decode rate (MP/s) by round,
the median by tree and this tree's median over the baseline's, with
the host CPU. The damaged copies of phase damaged (expected.json's
`rate`) are timed on this tree only: another tree may refuse them.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures")
FILES = ("rate/p_1024x768_q90.jpg", "formats_rate/r_prog_1024x768_q90.jpg")

CHILD = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
from l3c_torch.data import jpeg
out = {}
for name, at, xor in json.loads(sys.argv[2]):
    blob = bytearray(open(name, "rb").read())
    if at >= 0:
        blob[at] ^= xor
    blob = bytes(blob)
    best = float("inf")
    for _ in range(int(sys.argv[3])):
        t0 = time.perf_counter()
        px = jpeg.decode_jpeg(blob, name)
        best = min(best, time.perf_counter() - t0)
    out[f"{name}@{at}"] = (px.shape[0] * px.shape[1] / best / 1e6,
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
    clean = [(os.path.join(FIXTURES, f), -1, 0) for f in FILES]
    with open(os.path.join(FIXTURES, "damaged", "expected.json")) as f:
        hurt = [(os.path.join(FIXTURES, rel), e["at"], e["xor"])
                for rel, e in sorted(json.load(f)["rate"].items())]
    rates = {"this": [], "baseline": []}
    for r in range(args.rounds):
        order = ("this", "baseline") if r % 2 == 0 else ("baseline", "this")
        for side in order:
            tree = ROOT if side == "this" else os.path.abspath(args.baseline)
            got = decode_rates(tree, clean + (hurt if side == "this" else
                                              []), args.decodes)
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
    print(f"host {host_cpu()}; fastest of "
          f"{args.decodes} decodes a round, median over {args.rounds} "
          "rounds:")
    for k in rates["this"][0]:
        mine = statistics.median(g[k][0] for g in rates["this"])
        line = f"  {os.path.basename(k)}: this {mine:.4f} MP/s"
        if k in rates["baseline"][0]:
            base = statistics.median(g[k][0] for g in rates["baseline"])
            line += f", baseline {base:.4f}, ratio {mine / base:.4f}"
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
