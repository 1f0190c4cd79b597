"""Recursive 4-way spatial tiling for large images.

NHWC numpy images (the reference's auto_crop.py):
images with H*W above a memory threshold are recursively quartered
(TL, TR, BL, BR, depth-first) and each tile is coded independently into a
`.partN` file; `stitch` inverts the depth-first order recursively instead
of the reference's index-remapping table (auto_crop.py:78-136) — same
result, simpler invariant (stitch(list(iter_crops(x))) == x).
"""
from __future__ import annotations

import os
from typing import Iterator, List

import numpy as np

# Reference default: crops when H*W > 2000*1500 (Titan X 12GB bound,
# auto_crop.py:24-36). Overridable via the same env var.
_DEFAULT_DIM = 2000 * 1500


def needs_crop_dim() -> int:
    spec = os.environ.get("AC_NEEDS_CROP_DIM", "")
    if spec:
        parts = [int(p) for p in spec.split(",")]
        out = 1
        for p in parts:
            out *= p
        return out
    return _DEFAULT_DIM


def needs_crop(img: np.ndarray, dim: int = None) -> bool:
    h, w = img.shape[1:3]
    return h * w > (dim if dim is not None else needs_crop_dim())


def _quarters(img: np.ndarray) -> List[np.ndarray]:
    h, w = img.shape[1:3]
    return [img[:, : h // 2, : w // 2], img[:, : h // 2, w // 2:],
            img[:, h // 2:, : w // 2], img[:, h // 2:, w // 2:]]


def crop_depth(img: np.ndarray, dim: int = None) -> int:
    """Quartering depth for `img`: the max depth any quadrant needs.

    Splitting every quadrant to the SAME depth (unlike the reference's
    per-quadrant recursion, auto_crop.py:55-75) keeps the part count a
    power of 4 at every level, so `stitch` can reassemble from the part
    list alone: with independent depths, quadrants of a near-threshold
    odd-sized image can recurse unevenly and the flat `.partN` list
    becomes ambiguous. Cost: a few tiles smaller than strictly needed.
    """
    if not needs_crop(img, dim):
        return 0
    return 1 + max(crop_depth(q, dim) for q in _quarters(img))


def _iter_at_depth(img: np.ndarray, depth: int) -> Iterator[np.ndarray]:
    if depth == 0:
        yield img
        return
    for q in _quarters(img):
        yield from _iter_at_depth(q, depth - 1)


def iter_crops(img: np.ndarray, dim: int = None) -> Iterator[np.ndarray]:
    """Yield tiles (depth-first quartering) small enough to code."""
    yield from _iter_at_depth(img, crop_depth(img, dim))


def num_crops(img: np.ndarray, dim: int = None) -> int:
    return 4 ** crop_depth(img, dim)


def stitch(parts: List[np.ndarray]) -> np.ndarray:
    """Inverse of list(iter_crops(...)): recursive quadrant reassembly."""
    if len(parts) == 1:
        return parts[0]
    assert len(parts) % 4 == 0, len(parts)
    q = len(parts) // 4
    tl = stitch(parts[0 * q: 1 * q])
    tr = stitch(parts[1 * q: 2 * q])
    bl = stitch(parts[2 * q: 3 * q])
    br = stitch(parts[3 * q: 4 * q])
    top = np.concatenate([tl, tr], axis=2)
    bot = np.concatenate([bl, br], axis=2)
    return np.concatenate([top, bot], axis=1)


class CropLossCombinator:
    """Subpixel-weighted mean bpsp across tiles (auto_crop.py:139-152)."""

    def __init__(self):
        self._total_bits = 0.0
        self._total_subpixels = 0

    def add(self, bpsp: float, num_subpixels: int):
        self._total_bits += bpsp * num_subpixels
        self._total_subpixels += num_subpixels

    def get_bpsp(self) -> float:
        assert self._total_subpixels > 0
        return self._total_bits / self._total_subpixels
