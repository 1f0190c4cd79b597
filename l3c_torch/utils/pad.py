"""Pad H,W of an NHWC image to a multiple of `fac`; undo on the way out.

Split padding top/bottom and left/right and return the padding tuple,
which the codec records in the file header.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

PadTuple = Tuple[int, int, int, int]  # (left, right, top, bottom)


def padding_for(h: int, w: int, fac: int) -> PadTuple:
    pad_h = fac - (h % fac)
    pad_w = fac - (w % fac)
    top = bottom = left = right = 0
    if pad_h != fac:
        top = pad_h // 2
        bottom = pad_h - top
    if pad_w != fac:
        left = pad_w // 2
        right = pad_w - left
    return (left, right, top, bottom)


def pad(img: np.ndarray, fac: int, mode: str = "replicate"
        ) -> Tuple[np.ndarray, PadTuple]:
    """Pad NHWC `img` so H and W divide `fac`.

    mode: 'replicate' (edge) or 'constant' (zeros; what the codec uses).
    Returns (padded, (left, right, top, bottom))."""
    _, h, w, _ = img.shape
    left, right, top, bottom = padding_for(h, w, fac)
    if (left, right, top, bottom) == (0, 0, 0, 0):
        return img, (0, 0, 0, 0)
    np_mode = {"replicate": "edge", "constant": "constant"}[mode]
    widths = ((0, 0), (top, bottom), (left, right), (0, 0))
    return np.pad(img, widths, mode=np_mode), (left, right, top, bottom)


def undo_pad(img: np.ndarray, left: int, right: int, top: int, bottom: int
             ) -> np.ndarray:
    """Crop an NHWC image back; inverse of `pad`."""
    return img[:, top: img.shape[1] - bottom, left: img.shape[2] - right, :]
