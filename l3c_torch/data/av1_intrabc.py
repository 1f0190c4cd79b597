"""AV1's intra block copy (the AV1 specification, sections 5.11.24-5.11.26,
7.10.2 and 7.11.3) for an intra frame with `allow_intrabc`, as dav1d 1.5
decodes it: the displacement vector (DV) of a block from the stack of its
spatial neighbours' DVs, the difference read with the intrabc context's
own CDFs, the DV kept inside the decoded part of the tile as dav1d keeps
it, and the prediction copied from the frame before filtering (chroma of
a subsampled plane through the bilinear filter of the inter predictor).

The functions take the frame decoder of data/av1_block.py (its per-4x4
arrays `is_inter`, `dvs`, `mi_size`, `written`, its tile bounds) and the
block being decoded.
"""
from __future__ import annotations

import numpy as np

from .av1_obu import damaged

REF_CAT_LEVEL = 640
MAX_STACK = 8
MV_BORDER = 128                     # 16 pixels, in 1/8


def _add(stack, weights, cand, weight):
    """search_stack: a candidate DV, or more weight for one found."""
    for i, v in enumerate(stack):
        if v == cand:
            weights[i] += weight
            return
    if len(stack) < MAX_STACK:
        stack.append(cand)
        weights.append(weight)


def _candidate(d, row, col, stack, weights, weight):
    """add_ref_mv_candidate of an intra frame: the intrabc blocks only."""
    if d.is_inter[row][col]:
        _add(stack, weights, d.dvs[row][col], weight)
        return 1
    return 0


def _scan_row(d, b, delta_row, stack, weights, wh):
    bw4 = wh[b.size][0]
    end4 = min(bw4, d.mi_cols - b.c, 16)
    delta_col = 0
    if abs(delta_row) > 1:
        delta_row += b.r & 1
        delta_col = 1 - (b.c & 1)
    found = i = 0
    while i < end4:
        row, col = b.r + delta_row, b.c + delta_col + i
        if not d.inside(row, col):
            break
        n = min(bw4, wh[d.mi_size[row][col]][0])
        if abs(delta_row) > 1:
            n = max(2, n)
        if bw4 >= 16:
            n = max(4, n)
        found |= _candidate(d, row, col, stack, weights, 2 * n)
        i += n
    return found


def _scan_col(d, b, delta_col, stack, weights, wh):
    bh4 = wh[b.size][1]
    end4 = min(bh4, d.mi_rows - b.r, 16)
    delta_row = 0
    if abs(delta_col) > 1:
        delta_row = 1 - (b.r & 1)
        delta_col += b.c & 1
    found = i = 0
    while i < end4:
        row, col = b.r + delta_row + i, b.c + delta_col
        if not d.inside(row, col):
            break
        n = min(bh4, wh[d.mi_size[row][col]][1])
        if abs(delta_col) > 1:
            n = max(2, n)
        if bh4 >= 16:
            n = max(4, n)
        found |= _candidate(d, row, col, stack, weights, 2 * n)
        i += n
    return found


def _scan_point(d, b, delta_row, delta_col, stack, weights):
    row, col = b.r + delta_row, b.c + delta_col
    if d.inside(row, col) and d.written[row][col]:
        return _candidate(d, row, col, stack, weights, 4)
    return 0


def _sort(stack, weights, start, end):
    while end > start:
        new_end = start
        for i in range(start + 1, end):
            if weights[i - 1] < weights[i]:
                weights[i - 1], weights[i] = weights[i], weights[i - 1]
                stack[i - 1], stack[i] = stack[i], stack[i - 1]
                new_end = i
        end = new_end


def dv_stack(d, b, wh):
    """find_mv_stack(0) of an intrabc block: the first two entries of the
    stack of its neighbours' DVs, sorted by weight (the nearest ones
    first), clamped to the frame plus MV_BORDER; zeros where fewer than
    two were found (intra frames have no temporal or extra candidates)."""
    bw4, bh4 = wh[b.size]
    stack, weights = [], []
    _scan_row(d, b, -1, stack, weights, wh)
    _scan_col(d, b, -1, stack, weights, wh)
    if max(bw4, bh4) <= 16:
        _scan_point(d, b, -1, bw4, stack, weights)
    nearest = len(stack)
    for i in range(nearest):
        weights[i] += REF_CAT_LEVEL
    _scan_point(d, b, -1, -1, stack, weights)
    _scan_row(d, b, -3, stack, weights, wh)
    _scan_col(d, b, -3, stack, weights, wh)
    if bh4 > 1:
        _scan_row(d, b, -5, stack, weights, wh)
    if bw4 > 1:
        _scan_col(d, b, -5, stack, weights, wh)
    _sort(stack, weights, 0, nearest)
    _sort(stack, weights, nearest, len(stack))
    out = []
    for dv_row, dv_col in stack[:2]:
        top = -(b.r * 32) - (MV_BORDER + bh4 * 32)
        bottom = (d.mi_rows - bh4 - b.r) * 32 + MV_BORDER + bh4 * 32
        left = -(b.c * 32) - (MV_BORDER + bw4 * 32)
        right = (d.mi_cols - bw4 - b.c) * 32 + MV_BORDER + bw4 * 32
        out.append((max(top, min(bottom, dv_row)),
                    max(left, min(right, dv_col))))
    return out + [(0, 0)] * (2 - len(out))


def pred_dv(d, b, wh):
    """assign_mv's predicted DV: the stack's first nonzero entry of two,
    else the default one sb above (or sb + 256 pixels to the left in the
    tile's first superblock row)."""
    for dv in dv_stack(d, b, wh):
        if dv != (0, 0):
            return dv
    sb4 = d.sb4
    if b.r - sb4 < d.row_start:
        return 0, -(sb4 * 4 + 256) * 8
    return -(sb4 * 4 * 8), 0


def _component(rd, c):
    """read_mv_component with integer precision (fr 3, hp 1)."""
    sign = rd.symbol(c.sign)
    cls = rd.symbol(c.cls)
    if cls == 0:
        up = rd.symbol(c.class0)
    else:
        up = 1 << cls
        for i in range(cls):
            up |= rd.symbol(c.bits[i]) << i
    mag = ((up << 3) | 7) + 1
    return -mag if sign else mag


def read_dv(rd, cdf, pred):
    """read_mv with MV_INTRABC_CONTEXT: the DV, the prediction plus the
    coded difference (rows first), in 1/8 pixel."""
    joint = rd.symbol(cdf.mv_joint)
    row, col = pred
    if joint in (2, 3):
        row += _component(rd, cdf.mv_comp[0])
    if joint in (1, 3):
        col += _component(rd, cdf.mv_comp[1])
    return row, col


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


def predict(plane: np.ndarray, x: int, y: int, w: int, h: int, dv, ssx: int,
            ssy: int, last_x: int, last_y: int, bd: int = 8) -> np.ndarray:
    """The block's prediction in one plane: the samples the DV points at
    (positions clipped to the frame), bilinear where a subsampled plane
    lands between samples, as dav1d's put_bilin rounds it with its
    intermediate bits ib (4 up to 10 bits, 2 at 12): (16 - f) a + f b
    across rounded by 4 - ib bits, then ((16 - g) p + g q) rounded by 4 +
    ib bits down, or, with no step down, by ib bits (at 8 and 10 bits
    ((16 - g) p + g q + 128) >> 8 of the unrounded rows)."""
    px = (x << 4) + ((2 * dv[1]) >> ssx)
    py = (y << 4) + ((2 * dv[0]) >> ssy)
    fx, fy = px & 15, py & 15
    cols = np.clip(np.arange(px >> 4, (px >> 4) + w + 1), 0, last_x)
    rows = np.clip(np.arange(py >> 4, (py >> 4) + h + 1), 0, last_y)
    src = plane[rows[:, None], cols[None, :]]
    ib = 4 if bd <= 10 else 2
    across = ((16 - fx) * src[:, :w] + fx * src[:, 1:] +
              ((1 << (4 - ib)) >> 1)) >> (4 - ib)
    if not fy:
        return (across[:h] + ((1 << ib) >> 1)) >> ib
    return ((16 - fy) * across[:h] + fy * across[1:] + (1 << (3 + ib))) >> \
        (4 + ib)
