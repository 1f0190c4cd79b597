"""Stochastic-weight-averaging checkpoint builder.

Port of `tools/swa.py`:
    python -m l3c_torch.tools.swa LOG_DIR OUT_LOG_DIR [--last K]

Averages the `params` tree of the last K persistent checkpoints of a
training run (uniform SWA; Izmailov et al. 2018) and writes the result as
a new single-checkpoint log dir that cli.test and the codecs restore like
any trained model. Host work only: numpy over the msgpack trees
(models/weights), no device, no training. Every leaf is accumulated in
float64 over the checkpoints oldest first, divided by K and cast back to
its dtype, so the file is byte for byte the one `tools/swa.py` writes.

OUT_LOG_DIR's basename must parse as a log dir name (e.g.
"0818_0000 cr oi_offline swa10") so the tester can recover the config.
The checkpoint carries step = the newest averaged itr and only
{'params', 'step'}: the optimizer state is dropped, as for released
models.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Any, Dict

import numpy as np

from ..models.weights import packb, read_checkpoint

CKPT_RE = re.compile(r"ckpt_(\d{10})\.ckpt$")


def _leaves(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def average(ckpt_paths) -> Dict[str, Any]:
    """The mean `params` tree of the checkpoint files, in the given
    order, each leaf in its own dtype."""
    acc, template = None, None
    for path in ckpt_paths:
        params = read_checkpoint(path)["params"]
        leaves = _leaves(params)
        if acc is None:
            acc, template = leaves, params
            continue
        if acc.keys() != leaves.keys():
            raise ValueError(f"{path}: another parameter tree")
        for k in acc:
            acc[k] += leaves[k]
    n = float(len(ckpt_paths))

    def rebuild(tree, prefix=""):
        return {k: (rebuild(v, prefix + k + "/") if isinstance(v, dict)
                    else (acc[prefix + k] / n).astype(np.asarray(v).dtype))
                for k, v in tree.items()}
    return rebuild(template)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("log_dir")
    ap.add_argument("out_log_dir")
    ap.add_argument("--last", type=int, default=10,
                    help="number of most-recent persistent ckpts")
    args = ap.parse_args(argv)

    ckpt_dir = os.path.join(args.log_dir, "ckpts")
    itrs = sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  if (m := CKPT_RE.match(f)))
    picked = itrs[-args.last:]
    if not picked:
        raise FileNotFoundError(f"no persistent ckpts in {ckpt_dir}")
    print(f"averaging {len(picked)} ckpts: {picked[0]}..{picked[-1]}")
    avg = average([os.path.join(ckpt_dir, f"ckpt_{itr:010d}.ckpt")
                   for itr in picked])
    out_ckpts = os.path.join(args.out_log_dir, "ckpts")
    os.makedirs(out_ckpts, exist_ok=True)
    blob = packb({"params": avg, "step": picked[-1]})
    out_p = os.path.join(out_ckpts, f"ckpt_{picked[-1]:010d}.ckpt")
    with open(out_p, "wb") as f:
        f.write(blob)
    print(f"wrote {out_p} ({len(blob) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
