"""Offline training-data preparation (Open Images style).

Port of `l3c_tpu/data/prep.py`, with the port's own image reader
(data/images: PNG, JPEG, WebP, PNM, BMP), Lanczos resample
(data/resample, Pillow's bit for bit) and PNG writer in place of Pillow:
the same kept / skipped decisions and, for a kept image, the same pixels
(the PNG bytes differ). The reference importer's rules
(import_train_images.py):
- a random Lanczos downscale so the short side is >= `min_res` (default
  512), taken only when the scale factor is <= 0.8: never upscale, never
  barely downscale (that keeps resampling noise out of the data);
- non-RGB images (by the mode Pillow would open them in) and saturated
  ones (mean HSV saturation > 0.9 or mean value > 0.8) are discarded;
- the result is saved as PNG (import_train_images.py:131).
A damaged file is read as Pillow reads it (libjpeg-turbo's recovery
from corrupt JPEG data, Pillow's PNG CRC rule); one Pillow refuses (cut
short, a broken header, or a variant it does not decode, such as
hierarchical JPEG) is skipped with a "skipping PATH: REASON" line on
stderr, as the JAX package skips it.

CLI:
    python -m l3c_torch.data.prep IN_DIR OUT_DIR [--min_res 512]
        [--max_imgs N] [--workers N] [--update_cache CACHE_PKL]
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np


def should_discard(img_rgb: np.ndarray) -> bool:
    """Mean-HSV saturation/value filter (import_train_images.py:170-184)."""
    arr = img_rgb.astype(np.float32) / 255.0
    mx = arr.max(-1)
    mn = arr.min(-1)
    sat = np.where(mx > 0, (mx - mn) / np.maximum(mx, 1e-9), 0.0)
    return bool(sat.mean() > 0.9 or mx.mean() > 0.8)


def random_scale_for(short_side: int, min_res: int, rng,
                     max_scale: float = 0.8) -> Optional[float]:
    """A random downscale factor, or None to skip this image."""
    smallest = min_res / short_side  # scale that makes short side min_res
    if smallest > max_scale:
        return None  # would need upscaling or near-identity resize
    return float(rng.uniform(smallest, max_scale))


def process_one(args: Tuple[str, str, int, int]) -> Optional[str]:
    """(path, out_dir, min_res, seed) -> the PNG written, or None."""
    from .images import image_mode, image_size, load_image_uint8, write_png
    from .resample import resize
    path, out_dir, min_res, seed = args
    try:
        if image_mode(path) != "RGB":
            return None
        rng = np.random.RandomState(seed)
        h, w = image_size(path)
        scale = random_scale_for(min(w, h), min_res, rng)
        if scale is None:
            return None
        arr = resize(load_image_uint8(path), (max(1, round(w * scale)),
                                              max(1, round(h * scale))))
        if should_discard(arr):
            return None
        name = os.path.splitext(os.path.basename(path))[0] + ".png"
        out_p = os.path.join(out_dir, name)
        write_png(out_p, arr)
        return out_p
    except Exception as e:  # corrupt inputs are expected in web dumps
        print(f"skipping {path}: {e}", file=sys.stderr)
        return None


def _one_thread():
    import torch
    torch.set_num_threads(1)


def process_all(work: Sequence[Tuple[str, str, int, int]], workers: int
                ) -> List[Optional[str]]:
    """process_one over `work`, in a pool of `workers` forked processes
    (as the JAX package's, so a worker costs no import) with one torch
    thread each."""
    if workers <= 1 or len(work) <= 1:
        return [process_one(w) for w in work]
    ctx = multiprocessing.get_context("fork")
    with ctx.Pool(min(workers, len(work)), initializer=_one_thread) as pool:
        return pool.map(process_one, work)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("inp_dir")
    p.add_argument("out_dir")
    p.add_argument("--min_res", type=int, default=512)
    p.add_argument("--max_imgs", type=int, default=None)
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--update_cache", default=None,
                   help="also (re)build an ImagesCached pkl for OUT_DIR")
    flags = p.parse_args(argv)

    from .images import ImagesCached, iter_images_in
    os.makedirs(flags.out_dir, exist_ok=True)
    paths = iter_images_in(flags.inp_dir)
    if flags.max_imgs:
        paths = paths[: flags.max_imgs]
    work = [(q, flags.out_dir, flags.min_res, i)
            for i, q in enumerate(paths)]
    results = process_all(work, flags.workers or max(1, os.cpu_count() or 1))
    kept = [r for r in results if r]
    print(f"kept {len(kept)}/{len(paths)} images in {flags.out_dir}")
    if flags.update_cache:
        ImagesCached(flags.out_dir,
                     flags.update_cache).paths(update_cache=True)
        print(f"updated cache {flags.update_cache}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
