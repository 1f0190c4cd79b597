"""Classical-baseline bpsp report: MED+rANS (.medl).

Port of `l3c_tpu/cli/classic.py`:
    python -m l3c_torch.cli.classic --no_png IMG_DIR [IMG_DIR ...]

Prints each directory's mean bpsp of the in-repo MED/JPEG-LS-style codec
(eval.classic; every image's round trip is asserted bit-exact) and the
mean milliseconds an image of its encode and decode. Images are read
with the port's loader (data/images: PNG, binary PNM, BMP).

The JAX package's CLI also reports Pillow's optimized PNG, which the
port cannot compute: it does not import Pillow, and a PNG size computed
any other way would differ from that column silently. So `--no_png` is
required, and the CLI refuses to run without it. Touches no device.
"""
from __future__ import annotations

import argparse
import sys
import time

NO_PNG_REQUIRED = (
    "the optimized-PNG column needs Pillow, which l3c_torch does not "
    "import (a PNG size computed otherwise would differ from the JAX "
    "package's column); pass --no_png for the .medl column alone")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dirs", nargs="+")
    p.add_argument("--no_png", action="store_true",
                   help="required: report the .medl column only")
    flags = p.parse_args(argv)
    if not flags.no_png:
        print(f"cli.classic: {NO_PNG_REQUIRED}", file=sys.stderr)
        return 2

    from ..data.images import iter_images_in, load_image_uint8
    from ..eval import classic

    for d in flags.dirs:
        paths = iter_images_in(d)
        if not paths:
            print(f"{d}: no images", file=sys.stderr)
            continue
        med_bits = subpix = 0
        secs = 0.0
        for q in paths:
            img = load_image_uint8(q)
            t0 = time.perf_counter()
            blob = classic.encode(img)
            out = classic.decode(blob)
            secs += time.perf_counter() - t0
            if not (out.shape == img.shape and (out == img).all()):
                raise RuntimeError(f"MED round-trip failed: {q}")
            med_bits += len(blob) * 8
            subpix += img.size
        print(f"{d}: n={len(paths)} med_bpsp={med_bits / subpix:.4f} "
              f"enc+dec_ms={1e3 * secs / len(paths):.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
