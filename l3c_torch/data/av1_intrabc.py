"""AV1's intra block copy (the AV1 specification, sections 5.11.24-5.11.26,
7.10.2 and 7.11.3) for an intra frame with `allow_intrabc`, as dav1d 1.5
decodes it: the displacement vector (DV) of a block from the stack of its
spatial neighbours' DVs, the difference read with the intrabc context's
own CDFs, and the DV kept inside the decoded part of the tile as dav1d
keeps it. The prediction is the inter predictor's (data/av1_inter.py)
from the frame before filtering, through the bilinear filter.

The functions take the frame decoder of data/av1_block.py (its per-4x4
arrays `is_inter`, `ref_frames`, `mvs`, `mi_size`, `written`, its tile
bounds) and the block being decoded.
"""
from __future__ import annotations

from . import av1_mvs
from .av1_obu import damaged


def pred_dv(d, b, wh):
    """assign_mv's predicted DV: the first nonzero entry of two of the MV
    stack (data/av1_mvs.py) an intrabc block has in an intra frame (its
    neighbours' DVs: no temporal or extra candidates), else the default
    one sb above (or sb + 256 pixels to the left in the tile's first
    superblock row)."""
    for dv, _ in av1_mvs.find_mv_stack(d, b, (0, -1), wh).mvs[:2]:
        if dv != (0, 0):
            return dv
    sb4 = d.sb4
    if b.r - sb4 < d.row_start:
        return 0, -(sb4 * 4 + 256) * 8
    return -(sb4 * 4 * 8), 0


def read_dv(rd, cdf, pred):
    """read_mv with MV_INTRABC_CONTEXT: the DV, the prediction plus the
    coded difference (rows first) at integer precision, in 1/8 pixel."""
    return av1_mvs.read_mv(rd, cdf.mv[1], pred, 0, 1)


def clip_dv(d, b, dv, wh):
    """dav1d's hold of a DV to the decoded part of the tile: moved inside
    the tile's left, right and top edges, out of the current superblock
    (up into the row above, or left), no lower than its superblock row;
    a DV that still overlaps the current superblock is refused (dav1d's
    decode error). Valid DVs pass unchanged."""
    bw4, bh4 = wh[b.size]
    sb128 = int(d.sb4 == 32)
    border_left = d.col_start * 4
    border_top = d.row_start * 4
    if b.has_chroma:
        if bw4 < 2 and d.ssx:
            border_left += 4
        if bh4 < 2 and d.ssy:
            border_top += 4
    left = b.c * 4 + (dv[1] >> 3)
    top = b.r * 4 + (dv[0] >> 3)
    right, bottom = left + bw4 * 4, top + bh4 * 4
    border_right = ((d.col_end + (bw4 - 1)) & ~(bw4 - 1)) * 4
    if left < border_left:
        right += border_left - left
        left = border_left
    elif right > border_right:
        left -= right - border_right
        right = border_right
    if top < border_top:
        bottom += border_top - top
        top = border_top
    sbx = (b.c >> (4 + sb128)) << (6 + sb128)
    sby = (b.r >> (4 + sb128)) << (6 + sb128)
    sb_size = 1 << (6 + sb128)
    if bottom > sby and right > sbx:
        if top - border_top >= bottom - sby:
            top -= bottom - sby
            bottom = sby
        elif left - border_left >= right - sbx:
            left -= right - sbx
            right = sbx
    if bottom > sby + sb_size:
        top -= bottom - (sby + sb_size)
        bottom = sby + sb_size
    if bottom > sby and right > sbx:
        raise damaged(d.path, "an intra block copy vector points into its "
                              "own superblock")
    return (top - b.r * 4) * 8, (left - b.c * 4) * 8

