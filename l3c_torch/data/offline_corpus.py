"""Zero-egress photographic corpus assembly.

Port of `l3c_tpu/data/offline_corpus.py`, with the port's own reader,
Lanczos resample and PNG writer in place of Pillow: for the same sources
and seed the same tiles, pixel for pixel. The reference pipeline starts
with an aws download of Open Images (prep_openimages.sh:39-61); without
network this module substitutes that FETCH stage with a curated manifest
of real photographic content bundled inside installed python packages
(photos: sklearn's china/flower, matplotlib's grace_hopper, pygame's
webcam docs shots; material photo-textures: dm_control /
gymnasium_robotics wood, marble, foil, skin, grass; the sky faces of
dm_control's outdoor skybox). A source whose package is not installed is
reported and skipped.

`build_corpus` tiles and augments each source (the offline pool is ~20
sources rather than 300k): many random-scale crops (flips for all,
90-degree rotations for textures only), and VAL SOURCES ARE HELD OUT
ENTIRELY - val tiles and val full images come from sources the train set
never saw.

CLI: python -m l3c_torch.cli.prep_pipeline --offline OUT_ROOT
"""
from __future__ import annotations

import os
import shutil
import sys
import sysconfig
from typing import Dict, List, Optional, Tuple

import numpy as np

from .images import iter_images_in, load_image_uint8, write_png
from .resample import resize

_SP = None


def _site_packages() -> str:
    """Where the manifest's packages are installed (settable via _SP)."""
    global _SP
    if _SP is None:
        _SP = sysconfig.get_paths()["purelib"]
    return _SP


# kind: 'scene' (no rotations) | 'texture' (rotation augmentation OK)
# split: 'train' | 'val' (val sources are fully held out)
MANIFEST: List[Tuple[str, str, str]] = [
    ("sklearn/datasets/images/flower.jpg", "scene", "train"),
    ("matplotlib/mpl-data/sample_data/grace_hopper.jpg", "scene", "train"),
    ("pygame/docs/generated/_images/camera_average.jpg", "scene", "train"),
    ("pygame/docs/generated/_images/camera_background.jpg", "scene",
     "train"),
    ("dm_control/locomotion/arenas/assets/outdoor_natural/"
     "OutdoorGrassFloorD.png", "texture", "train"),
    ("gymnasium_robotics/envs/assets/adroit_hand/resources/textures/"
     "foil.png", "texture", "train"),
    ("gymnasium_robotics/envs/assets/adroit_hand/resources/textures/"
     "marble.png", "texture", "train"),
    ("gymnasium_robotics/envs/assets/adroit_hand/resources/textures/"
     "darkwood.png", "texture", "train"),
    ("gymnasium_robotics/envs/assets/adroit_hand/resources/textures/"
     "skin.png", "texture", "train"),
    ("gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/"
     "textures/tile1.png", "texture", "train"),
    ("gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/"
     "textures/metal1.png", "texture", "train"),
    ("gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/"
     "textures/marble1.png", "texture", "train"),
    ("dm_control/suite/dog_assets/skin_texture.png", "texture", "train"),
    ("dm_control/suite/dog_assets/tennis_ball.png", "texture", "train"),
    # held-out val sources (never tiled into train):
    ("sklearn/datasets/images/china.jpg", "scene", "val"),
    ("pygame/docs/generated/_images/camera_rgb.jpg", "scene", "val"),
    ("gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/"
     "textures/wood1.png", "texture", "val"),
]

# The outdoor skybox is a 4x3 cube-map cross of real sky photos; extract
# the 6 non-black faces.
SKYBOX = ("dm_control/locomotion/arenas/assets/outdoor_natural/"
          "OutdoorSkybox2048.png")
SKYBOX_FACES = [(1, 0), (0, 1), (1, 1), (2, 1), (3, 1), (1, 2)]  # (cx,cy)


def _crop(img: np.ndarray, x0: int, y0: int, n: int) -> np.ndarray:
    """Pillow's crop of an n x n box: what lies outside the image black."""
    out = np.zeros((n, n, 3), np.uint8)
    part = img[y0:y0 + n, x0:x0 + n]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def collect_sources(tmp_dir: str) -> Dict[str, List[Tuple[str, str]]]:
    """Resolve the manifest into {'train'|'val': [(png_path, kind)]}.

    Extracted originals are written as PNG into tmp_dir (the analogue of
    the unpacked download directory in prep_openimages.sh:54-61).
    """
    os.makedirs(tmp_dir, exist_ok=True)
    out: Dict[str, List[Tuple[str, str]]] = {"train": [], "val": []}
    for rel, kind, split in MANIFEST:
        p = os.path.join(_site_packages(), rel)
        if not os.path.isfile(p):
            print(f"offline corpus: missing {rel} (skipped)",
                  file=sys.stderr)
            continue
        name = os.path.splitext(os.path.basename(rel))[0] + ".png"
        dst = os.path.join(tmp_dir, name)
        if not os.path.isfile(dst):
            write_png(dst, load_image_uint8(p))
        out[split].append((dst, kind))
    sky = os.path.join(_site_packages(), SKYBOX)
    if os.path.isfile(sky):
        im = load_image_uint8(sky)
        face = im.shape[1] // 4
        for i, (cx, cy) in enumerate(SKYBOX_FACES):
            dst = os.path.join(tmp_dir, f"sky_face{i}.png")
            if not os.path.isfile(dst):
                write_png(dst, _crop(im, cx * face, cy * face, face))
            out["train"].append((dst, "texture"))
    return out


def _tiles_from(img: np.ndarray, kind: str, n_tiles: int, tile: int,
                rng: np.random.RandomState,
                noise_frac: float = 0.0) -> List[np.ndarray]:
    """Random-scale random crops (reference importer's random Lanczos
    downscale, import_train_images.py:150-167, adapted to small pools).

    noise_frac: fraction of tiles that get small uniform sensor-like
    noise added (the package sources are mostly clean textures; a model
    trained on them alone is miscalibrated on noisy photos). The draws
    from `rng` come in the JAX package's order: scale, offsets, flip,
    rotation (textures), noise.
    """
    h, w = img.shape[:2]
    tiles = []
    for _ in range(n_tiles):
        s = float(rng.uniform(0.5, 1.0))
        sh, sw = max(1, round(h * s)), max(1, round(w * s))
        if min(sh, sw) < tile // 2:
            s, sh, sw = 1.0, h, w
        a = resize(img, (sw, sh)) if s != 1.0 else img
        t = min(tile, a.shape[0], a.shape[1])
        y = rng.randint(0, a.shape[0] - t + 1)
        x = rng.randint(0, a.shape[1] - t + 1)
        c = a[y:y + t, x:x + t]
        if rng.rand() < 0.5:
            c = c[:, ::-1]
        if kind == "texture":
            c = np.rot90(c, rng.randint(0, 4))
        c = np.ascontiguousarray(c)
        if rng.rand() < noise_frac:
            k = int(rng.choice([1, 2, 4, 6]))
            c = np.clip(c.astype(np.int16)
                        + rng.randint(-k, k + 1, c.shape), 0,
                        255).astype(np.uint8)
        tiles.append(c)
    return tiles


def build_corpus(out_root: str, tile: int = 256,
                 tiles_scene: int = 24, tiles_texture: int = 40,
                 seed: int = 0, noise_frac: float = 0.3,
                 extra_train_dirs: Optional[List[str]] = None
                 ) -> Tuple[str, str, str]:
    """Assemble train/val tile sets + whole held-out val images.

    extra_train_dirs: directories of ready-made training images copied
    into the train split verbatim.
    Returns (train_dir, val_dir, val_full_dir)."""
    src = collect_sources(os.path.join(out_root, "sources"))
    train_dir = os.path.join(out_root, "train")
    val_dir = os.path.join(out_root, "val")
    val_full = os.path.join(out_root, "val_full")
    for d in (train_dir, val_dir, val_full):
        os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    n_train = n_val = 0
    for split, pairs in src.items():
        for p, kind in pairs:
            img = load_image_uint8(p)
            base = os.path.splitext(os.path.basename(p))[0]
            if split == "val":
                write_png(os.path.join(val_full, base + ".png"), img)
            n = tiles_texture if kind == "texture" else tiles_scene
            nf = noise_frac if split == "train" else 0.0
            if split == "val":
                n = max(4, n // 3)
            for i, t in enumerate(_tiles_from(img, kind, n, tile, rng,
                                              noise_frac=nf)):
                d = train_dir if split == "train" else val_dir
                write_png(os.path.join(d, f"{base}_{i:03d}.png"), t)
            if split == "train":
                n_train += n
            else:
                n_val += n
    for xd in (extra_train_dirs or []):
        for p in iter_images_in(xd):
            dst = os.path.join(train_dir, "x_" + os.path.basename(p))
            if not os.path.isfile(dst):
                shutil.copy(p, dst)
            n_train += 1
    print(f"offline corpus: {n_train} train tiles, {n_val} val tiles, "
          f"{len(src['val'])} whole held-out val images -> {out_root}")
    return train_dir, val_dir, val_full
