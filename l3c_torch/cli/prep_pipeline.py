"""Data-prep pipeline orchestrator (prep_openimages.sh equivalent).

Port of `l3c_tpu/cli/prep_pipeline.py` on the port's own readers (no
Pillow): the reference shell pipeline (prep_openimages.sh:39-100) runs
four stages: [1] aws download of Open Images train_0/1/2 + validation,
[2] unpack, [3] import_train_images.py (downscale/discard/PNG), [4]
file-list cache build. This orchestrator reproduces stages 2-4 for an
existing dump (stage 1 needs network: it is replaced either by --inp_dir
pointing at a pre-downloaded dump of PNG, JPEG, WebP, PNM or BMP
files, or by --offline, which assembles the photographic corpus bundled
in installed packages, data.offline_corpus).

Usage:
    python -m l3c_torch.cli.prep_pipeline --offline OUT_ROOT \
        [--synth_families N --synth_tiles T]
    python -m l3c_torch.cli.prep_pipeline --inp_dir DUMP OUT_ROOT \
        [--val_frac 0.02] [--min_res 512] [--workers N]
"""
from __future__ import annotations

import argparse
import os
import sys

def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_root")
    p.add_argument("--inp_dir", default=None,
                   help="pre-downloaded image dump (stage-1 output)")
    p.add_argument("--offline", action="store_true",
                   help="assemble the zero-egress package corpus instead")
    p.add_argument("--min_res", type=int, default=512)
    p.add_argument("--val_frac", type=float, default=0.02)
    p.add_argument("--max_imgs", type=int, default=None)
    p.add_argument("--workers", type=int, default=1,
                   help="--inp_dir: processes importing images (the "
                        "output does not depend on it)")
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--noise_frac", type=float, default=0.3,
                   help="fraction of offline train tiles given sensor-"
                        "like noise (robustness augmentation)")
    p.add_argument("--extra_train_dirs", default=None,
                   help="colon-separated dirs of ready tiles to mix in")
    p.add_argument("--synth_families", type=int, default=0,
                   help="generate N procedural photo-statistics "
                        "families (data.synth) and mix them into the "
                        "offline corpus as extra training sources")
    p.add_argument("--synth_tiles", type=int, default=40,
                   help="tiles per synthetic family")
    p.add_argument("--tiles_scene", type=int, default=24,
                   help="offline corpus: tiles per scene source")
    p.add_argument("--tiles_texture", type=int, default=40,
                   help="offline corpus: tiles per texture source")
    flags = p.parse_args(argv)

    if flags.offline:
        from ..data.offline_corpus import build_corpus
        extra = (flags.extra_train_dirs.split(":")
                 if flags.extra_train_dirs else [])
        if flags.synth_families:
            from ..data.synth import FAMILIES, generate_families
            fams = list(FAMILIES)[: flags.synth_families]
            synth_dir = os.path.join(flags.out_root, "synth")
            n = len(generate_families(synth_dir, flags.synth_tiles,
                                      n=flags.tile, families=fams))
            print(f"[synth] {n} tiles across {len(fams)} families "
                  f"-> {synth_dir}")
            extra = extra + [synth_dir]
        extra = extra or None
        train_dir, val_dir, _ = build_corpus(
            flags.out_root, tile=flags.tile, noise_frac=flags.noise_frac,
            tiles_scene=flags.tiles_scene,
            tiles_texture=flags.tiles_texture,
            extra_train_dirs=extra)
    elif flags.inp_dir:
        from ..data import prep
        from ..data.images import iter_images_in
        train_dir = os.path.join(flags.out_root, "train")
        val_dir = os.path.join(flags.out_root, "val")
        # deterministic split BY SOURCE IMAGE before importing
        paths = iter_images_in(flags.inp_dir)
        if flags.max_imgs:
            paths = paths[: flags.max_imgs]
        n_val = max(1, int(len(paths) * flags.val_frac))
        val_set = set(paths[:: max(1, len(paths) // n_val)][:n_val])
        for sub, sub_paths in (("train",
                                [q for q in paths if q not in val_set]),
                               ("val", sorted(val_set))):
            out_dir = os.path.join(flags.out_root, sub)
            os.makedirs(out_dir, exist_ok=True)
            work = [(q, out_dir, flags.min_res, i)
                    for i, q in enumerate(sub_paths)]
            kept = [r for r in prep.process_all(work, flags.workers) if r]
            print(f"[{sub}] kept {len(kept)}/{len(sub_paths)}")
    else:
        p.error("need --inp_dir or --offline")

    # stage 4: file-list caches (prep_openimages.sh:95-100)
    from ..data.images import ImagesCached
    cache = os.path.join(flags.out_root, "cache.pkl")
    for d in (train_dir, val_dir):
        ImagesCached(d, cache).paths(update_cache=True)
    print(f"caches -> {cache}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
