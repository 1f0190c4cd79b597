"""AV1's super-resolution upscaling (the AV1 specification, section 7.16),
as dav1d runs it (its `resize` over a whole row of the frame, not a tile
column at a time).

A frame with `use_superres` is coded at FrameWidth, 8 / SuperresDenom of
its UpscaledWidth; after CDEF each row of each plane is upscaled by an
8-tap filter of 64 phases (dav1d's `dav1d_resize_filter`, its taps
negated: `av1_tables.RESIZE_FILTER`). Output column x reads the source
from column -1 + ((x0 + x * step) >> 14) with the phase
((x0 + x * step) & 0x3fff) >> 8, its taps at -3 .. +4 around it clamped
to the plane's mi-aligned width (MiCols * 4 >> subX: the samples past
FrameWidth that the reconstruction and CDEF wrote). `step` and `x0` are
dav1d's, in C's truncating division.
"""
from __future__ import annotations

import numpy as np

from . import av1_tables as T

FILTER = np.array(T.RESIZE_FILTER, np.int64).reshape(64, 8)
ROWS = 256                   # rows upscaled at once (bounds the memory)


def _cdiv(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def step_and_start(down_w: int, up_w: int):
    """dav1d's resize_step and resize_start (get_upscale_x0) for a plane
    `down_w` samples wide upscaled to `up_w`."""
    step = ((down_w << 14) + (up_w >> 1)) // up_w
    err = up_w * step - (down_w << 14)
    x0 = _cdiv(-((up_w - down_w) << 13) + (up_w >> 1), up_w) + 128 - \
        _cdiv(err, 2)
    return step, x0 & 0x3FFF


def taps(down_w: int, up_w: int, src_w: int):
    """(columns, filter): for each output column its 8 source columns,
    clamped to [0, src_w), and its 8 (negated) taps."""
    step, x0 = step_and_start(down_w, up_w)
    pos = x0 + step * np.arange(up_w, dtype=np.int64)
    at = -1 + (pos >> 14)
    cols = np.clip(at[:, None] + np.arange(-3, 5)[None, :], 0, src_w - 1)
    return cols, FILTER[(pos & 0x3FFF) >> 8]


def upscale_plane(plane: np.ndarray, down_w: int, up_w: int, src_w: int,
                  bd: int) -> np.ndarray:
    """The plane's rows (its first `src_w` columns read) upscaled from
    `down_w` to `up_w` samples, clipped to `bd` bits; int64."""
    cols, flt = taps(down_w, up_w, src_w)
    out = np.empty((plane.shape[0], up_w), np.int64)
    top = (1 << bd) - 1
    for r in range(0, plane.shape[0], ROWS):
        src = plane[r:r + ROWS].astype(np.int64)
        acc = np.einsum("rwk,wk->rw", src[:, cols], flt)
        out[r:r + ROWS] = np.clip((64 - acc) >> 7, 0, top)
    return out


def upscale(planes, f, seq):
    """Each plane of the frame upscaled from FrameWidth to UpscaledWidth:
    padded planes in, the frame's rows of the upscaled width out."""
    out = []
    for p, plane in enumerate(planes[:seq.num_planes]):
        sx = seq.ssx if p else 0
        sy = seq.ssy if p else 0
        out.append(upscale_plane(plane[:(f.height + sy) >> sy],
                                 (f.width + sx) >> sx,
                                 (f.upscaled_width + sx) >> sx,
                                 (f.mi_cols * 4) >> sx, seq.bit_depth))
    return out
