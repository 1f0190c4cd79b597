"""Classical-baseline bpsp report: MED+rANS (.medl) and optimized PNG.

Port of `l3c_tpu/cli/classic.py`:
    python -m l3c_torch.cli.classic [--no_png] IMG_DIR [IMG_DIR ...]

Prints each directory's mean bpsp of (a) the in-repo MED/JPEG-LS-style
codec (eval.classic; every image's round trip is asserted bit-exact) and
(b) Pillow's optimized PNG (`optimize=True`), the two classical anchors
the JAX package quotes against the learned models, then the mean
milliseconds an image of the .medl encode and decode. Images are read
with the port's loader (data/images). The PNG column is computed without
Pillow (eval.classic.png_size: Pillow's filter choice and deflate
settings); its deflate is zlib's, whose version the line names, so its
byte counts are Pillow's where both run one zlib. --no_png leaves the
column out. Touches no device.
"""
from __future__ import annotations

import argparse
import sys
import time
import zlib


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dirs", nargs="+")
    p.add_argument("--no_png", action="store_true",
                   help="leave the optimized-PNG column out")
    flags = p.parse_args(argv)

    from ..data.images import iter_images_in, load_image_uint8
    from ..eval import classic

    for d in flags.dirs:
        paths = iter_images_in(d)
        if not paths:
            print(f"{d}: no images", file=sys.stderr)
            continue
        med_bits = png_bits = subpix = 0
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
            if not flags.no_png:
                png_bits += classic.png_size(img) * 8
        line = f"{d}: n={len(paths)} med_bpsp={med_bits / subpix:.4f}"
        if not flags.no_png:
            line += (f" png_bpsp={png_bits / subpix:.4f}"
                     f" zlib={zlib.ZLIB_RUNTIME_VERSION}")
        print(f"{line} enc+dec_ms={1e3 * secs / len(paths):.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
