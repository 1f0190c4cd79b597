"""libavif 1.3.0's avifImageScale: an AV1 frame of another size than its
item's `ispe` (a grid's cell, an alpha item too) is scaled to it before
conversion, each plane to its own subsampled size, by libyuv's
ScalePlane under kFilterBox (AVIF_LIBYUV_FILTER_MODE), or ScalePlane_16
for 10- and 12-bit frames, which are scaled at their depth.

ScalePlane first reduces the filter (ScaleFilterReduce: box only where
both axes shrink below one half, else bilinear; linear where the height
is kept, a third or one row; none where the width is kept, a third or
one column), then picks a path: a copy, a vertical-only blend, the exact
3/4, 1/2, 3/8 and 1/4 reductions, the box average, the 2x linear and
bilinear enlargements, bilinear up or down in 16.16 fixed point, or
point sampling. Each path here is libyuv's row functions' integer
arithmetic as they run on x86: ScaleFilterCols' 7-bit blend, the
interpolation of two rows in 8 bits, the box sums scaled by 65536 / n.
The 16-bit paths are the same but for ScaleFilterCols_16's 16-bit blend
and the 3/4 and 3/8 reductions, which run their C rows throughout.
"""
from __future__ import annotations

import numpy as np

from .avif_yuv import upsample_420, _linear_up

NONE, LINEAR, BILINEAR, BOX = 0, 1, 2, 3


def _tdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fixed_div(num: int, div: int) -> int:
    return _tdiv(num << 16, div)


def _fixed_div1(num: int, div: int) -> int:
    return _tdiv((num << 16) - 0x00010001, div - 1)


def _center(d: int, s: int) -> int:
    return -((-d >> 1) + s) if d < 0 else (d >> 1) + s


def reduce_filter(sw: int, sh: int, dw: int, dh: int, f: int) -> int:
    """ScaleFilterReduce."""
    if f == BOX and (dw * 2 >= sw or dh * 2 >= sh):
        f = BILINEAR
    if f == BILINEAR:
        if sh == 1 or dh == sh or dh * 3 == sh:
            f = LINEAR
        if sw == 1:
            f = NONE
    if f == LINEAR and (sw == 1 or dw == sw or dw * 3 == sw):
        f = NONE
    return f


def _slope(sw, sh, dw, dh, f):
    """ScaleSlope: (x, y, dx, dy) in 16.16."""
    if f == BOX:
        return 0, 0, _fixed_div(sw, dw), _fixed_div(sh, dh)
    if f in (BILINEAR, LINEAR):
        x = dx = 0
        if dw <= sw:
            dx = _fixed_div(sw, dw)
            x = _center(dx, -32768)
        elif sw > 1 and dw > 1:
            dx = _fixed_div1(sw, dw)
        if f == LINEAR:
            dy = _fixed_div(sh, dh)
            return x, dy >> 1, dx, dy
        y = dy = 0
        if dh <= sh:
            dy = _fixed_div(sh, dh)
            y = _center(dy, -32768)
        elif sh > 1 and dh > 1:
            dy = _fixed_div1(sh, dh)
        return x, y, dx, dy
    dx, dy = _fixed_div(sw, dw), _fixed_div(sh, dh)
    return _center(dx, 0), _center(dy, 0), dx, dy


def _interpolate(r0: np.ndarray, r1: np.ndarray, f: int) -> np.ndarray:
    """InterpolateRow: two rows blended by f / 256."""
    if f == 0:
        return r0.copy()
    if f == 128:
        return (r0 + r1 + 1) >> 1
    return (r0 * (256 - f) + r1 * f + 128) >> 8


def _filter_cols(row: np.ndarray, n: int, x: int, dx: int,
                 depth: int = 8) -> np.ndarray:
    """ScaleFilterCols (x86): a + ((f >> 9) * (b - a) + 64) >> 7; for
    16-bit samples ScaleFilterCols_16's C row: a + (f (b - a) + 2^15) >>
    16."""
    xs = x + dx * np.arange(n, dtype=np.int64)
    xi = xs >> 16
    a = row[xi]
    b = row[np.minimum(xi + 1, len(row) - 1)]
    if depth > 8:
        return a + (((xs & 0xFFFF) * (b - a) + 0x8000) >> 16)
    return a + ((((xs & 0xFFFF) >> 9) * (b - a) + 0x40) >> 7)


def _vertical(src, dh, y, dy, f):
    """ScalePlaneVertical: each row a blend of two source rows."""
    sh = src.shape[0]
    max_y = ((sh - 1) << 16) - 1 if sh > 1 else 0
    out = []
    for _ in range(dh):
        y = min(y, max_y)
        yi = y >> 16
        yf = (y >> 8) & 255 if f else 0
        out.append(_interpolate(src[yi], src[min(yi + 1, sh - 1)], yf))
        y += dy
    return np.stack(out)


def _down2(src, dw, dh):
    """ScaleRowDown2Box: (a + b + c + d + 2) >> 2."""
    s = src[:2 * dh, :2 * dw]
    return (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] +
            2) >> 2


def _down4(src, dw, dh):
    """ScaleRowDown4Box: the 16 sources + 8 >> 4."""
    return (src[:4 * dh, :4 * dw].reshape(dh, 4, dw, 4).sum((1, 3)) +
            8) >> 4


def _row34(s, t, dw, kind, depth=8):
    """ScaleRowDown34_0_Box (kind 0: t blended into s 1 : 3) or _1_Box
    (kind 1: 1 : 1) over dw outputs. The "Any" wrapper runs the SSSE3 row
    over the first multiple of 24 outputs (rows first, by pavgb: (s + t +
    1) >> 1, for 3 : 1 that again with s; then columns 3 : 1, 1 : 1, 1 : 3
    + 2 >> 2) and the C row over the rest (columns first, then rows);
    16-bit samples take the C row throughout."""
    n = dw // 3
    s4, t4 = s[:4 * n].reshape(n, 4), t[:4 * n].reshape(n, 4)

    def h(r):
        return np.stack([(r[:, 0] * 3 + r[:, 1] + 2) >> 2,
                         (r[:, 1] + r[:, 2] + 1) >> 1,
                         (r[:, 2] + r[:, 3] * 3 + 2) >> 2], 1)
    a, b = h(s4), h(t4)
    c = (a * 3 + b + 2) >> 2 if kind == 0 else (a + b + 1) >> 1
    simd = (dw - dw % 24) // 3 if depth == 8 else 0
    v = (s4[:simd] + t4[:simd] + 1) >> 1
    if kind == 0:
        v = (s4[:simd] + v + 1) >> 1
    c[:simd] = h(v)
    return c.reshape(-1)


def _down34(src, dw, dh, depth=8):
    """ScalePlaneDown34 (a 3/4 reduction is always bilinear, 3 | dh):
    of each four source rows, rows 0-1 3 : 1, 1-2 1 : 1, 3-2 3 : 1."""
    out = []
    for sy in range(0, 4 * dh // 3, 4):
        out += [_row34(src[sy], src[sy + 1], dw, 0, depth),
                _row34(src[sy + 1], src[sy + 2], dw, 1, depth),
                _row34(src[sy + 3], src[sy + 2], dw, 0, depth)]
    return np.stack(out)


def _row38(rows, dw, depth=8):
    """ScaleRowDown38_3_Box / _2_Box over len(rows) source rows: each
    output the sum of its 3 x k (the third 2 x k) sources times
    65536 / (3k) >> 16. For two rows the "Any" wrapper's SSSE3 part (the
    first multiple of 6 outputs) averages the rows by pavgb first and
    scales the column sums by 65536 / 3 (/ 2); 16-bit samples take the C
    row throughout."""
    n = dw // 3
    k = len(rows)
    s = sum(r[:8 * n] for r in rows).reshape(n, 8)
    out = np.stack([s[:, 0:3].sum(1) * (65536 // (3 * k)) >> 16,
                    s[:, 3:6].sum(1) * (65536 // (3 * k)) >> 16,
                    s[:, 6:8].sum(1) * (65536 // (2 * k)) >> 16], 1)
    if k == 2 and depth == 8:
        simd = (dw - dw % 6) // 3
        v = ((rows[0][:8 * simd] + rows[1][:8 * simd] + 1) >> 1).reshape(
            simd, 8)
        out[:simd] = np.stack([v[:, 0:3].sum(1) * (65536 // 3) >> 16,
                               v[:, 3:6].sum(1) * (65536 // 3) >> 16,
                               v[:, 6:8].sum(1) * (65536 // 2) >> 16], 1)
    return out.reshape(-1)


def _down38(src, dw, dh, depth=8):
    """ScalePlaneDown38 (a 3/8 reduction is always a box, 3 | dh): output
    rows from 3, 3 and 2 source rows of each eight."""
    out = []
    for sy in range(0, 8 * dh // 3, 8):
        out += [_row38(src[sy:sy + 3], dw, depth),
                _row38(src[sy + 3:sy + 6], dw, depth),
                _row38(src[sy + 6:sy + 8], dw, depth)]
    return np.stack(out)


def _box(src, dw, dh, mask=255):
    """ScalePlaneBox: each output the mean of its box of sources, the sum
    times 65536 / (box width x height) >> 16, stored in `mask`'s bits."""
    sh, sw = src.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, BOX)
    max_y = sh << 16
    out = np.empty((dh, dw), np.int64)
    xs = x + dx * np.arange(dw + 1, dtype=np.int64)
    ix = xs[:-1] >> 16
    if dx & 0xFFFF:
        bw = np.maximum((xs[1:] >> 16) - ix, 1)
    else:
        bw = np.full(dw, max(dx >> 16, 1), np.int64)
        if dx == 0x10000:
            bw[:] = 1
        ix = (x >> 16) + bw * np.arange(dw, dtype=np.int64)
    minbw = dx >> 16
    for j in range(dh):
        iy = y >> 16
        y = min(y + dy, max_y)
        bh = max((y >> 16) - iy, 1)
        acc = src[iy:iy + bh].sum(0)
        csum = np.concatenate([[0], np.cumsum(acc)])
        sums = csum[ix + bw] - csum[ix]
        if dx & 0xFFFF:
            scale = np.where(bw - minbw, 65536 // (max(minbw + 1, 1) * bh),
                             65536 // (max(minbw, 1) * bh))
        else:
            scale = 65536 // (bw * bh)
        out[j] = (sums * scale & 0xFFFFFFFF) >> 16
    return out & mask


def _up2_linear(src, dw, dh):
    """ScalePlaneUp2_Linear: rows picked at (2^15 - 1 + k dy) >> 16, each
    widened by ScaleRowUp2_Linear."""
    sh = src.shape[0]
    if dh == 1:
        return _linear_up(src[(sh - 1) // 2], dw)[None]
    dy = _fixed_div(sh - 1, dh - 1)
    ys = ((1 << 15) - 1 + dy * np.arange(dh, dtype=np.int64)) >> 16
    return _linear_up(src[ys], dw)


def _bilinear_up(src, dw, dh, f, depth=8):
    """ScalePlaneBilinearUp: source rows widened into two row buffers as y
    steps past them, then blended (its source pointer rule kept)."""
    sh, sw = src.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, f)
    max_y = (sh - 1) << 16
    y = min(y, max_y)
    yi = y >> 16
    src_row = yi
    rows = [_filter_cols(src[src_row], dw, x, dx, depth), None]
    if sh > 1:
        src_row += 1
    rows[1] = _filter_cols(src[src_row], dw, x, dx, depth)
    if sh > 2:
        src_row += 1
    cur, lasty, out = 0, yi, []
    for _ in range(dh):
        yi = y >> 16
        if yi != lasty:
            if y > max_y:
                y = max_y
                yi = y >> 16
                src_row = yi
            if yi != lasty:
                rows[cur] = _filter_cols(src[src_row], dw, x, dx, depth)
                cur ^= 1
                lasty = yi
                if y + 65536 < max_y:
                    src_row += 1
        if f == LINEAR:
            out.append(rows[cur].copy())
        else:
            out.append(_interpolate(rows[cur], rows[cur ^ 1], (y >> 8) & 255))
        y += dy
    return np.stack(out)


def _bilinear_down(src, dw, dh, f, depth=8):
    """ScalePlaneBilinearDown: each output row a blend of two source rows,
    then its columns filtered."""
    sh, sw = src.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, f)
    max_y = (sh - 1) << 16
    y = min(y, max_y)
    out = []
    for _ in range(dh):
        yi = y >> 16
        if f == LINEAR:
            row = src[yi]
        else:
            row = _interpolate(src[yi], src[min(yi + 1, sh - 1)],
                               (y >> 8) & 255)
        out.append(_filter_cols(row, dw, x, dx, depth))
        y = min(y + dy, max_y)
    return np.stack(out)


def _simple(src, dw, dh):
    """ScalePlaneSimple: point sampling from the centred start."""
    sh, sw = src.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, NONE)
    ys = (y + dy * np.arange(dh, dtype=np.int64)) >> 16
    xs = (x + dx * np.arange(dw, dtype=np.int64)) >> 16
    return src[ys][:, xs]


def scale_plane(plane: np.ndarray, dw: int, dh: int,
                depth: int = 8) -> np.ndarray:
    """libyuv's ScalePlane(kFilterBox) of one 8-bit plane to dw x dh, or
    ScalePlane_16 of a deeper one."""
    src = plane.astype(np.int64)
    sh, sw = src.shape
    f = reduce_filter(sw, sh, dw, dh, BOX)
    if (dw, dh) == (sw, sh):
        out = src
    elif dw == sw and f != BOX:
        dy = y = 0
        if dh <= sh:
            dy = _fixed_div(sh, dh)
            y = _center(dy, -32768)
        elif sh > 1 and dh > 1:
            dy = _fixed_div1(sh, dh)
        out = _vertical(src, dh, y, dy, f)
    elif 4 * dw == 3 * sw and 4 * dh == 3 * sh:
        out = _down34(src, dw, dh, depth)
    elif 2 * dw == sw and 2 * dh == sh:
        out = _down2(src, dw, dh)
    elif 8 * dw == 3 * sw and 8 * dh == 3 * sh:
        out = _down38(src, dw, dh, depth)
    elif 4 * dw == sw and 4 * dh == sh:
        out = _down4(src, dw, dh)
    elif f == BOX and dh * 2 < sh:
        out = _box(src, dw, dh, 255 if depth == 8 else 0xFFFF)
    elif (dw + 1) // 2 == sw and f == LINEAR:
        out = _up2_linear(src, dw, dh)
    elif (dh + 1) // 2 == sh and (dw + 1) // 2 == sw and f in (BILINEAR,
                                                                BOX):
        out = upsample_420(src, dh, dw)
    elif f and dh > sh:
        out = _bilinear_up(src, dw, dh, f, depth)
    elif f:
        out = _bilinear_down(src, dw, dh, f, depth)
    else:
        out = _simple(src, dw, dh)
    return out.astype(np.uint8 if depth == 8 else np.uint16)


def scale_planes(planes, ssx: int, ssy: int, w: int, h: int,
                 depth: int = 8):
    """avifImageScale: Y (or alpha) to w x h, chroma to its subsampled
    size, at the frame's depth (before any conversion to 8 bits)."""
    out = [scale_plane(planes[0], w, h, depth)]
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    out += [scale_plane(p, cw, ch, depth) for p in planes[1:]]
    return out
